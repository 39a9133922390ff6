"""mmengine-style Python config loader with ``_base_`` inheritance
(rs_ov/evalsuite/config.py): exec the file, load its bases recursively and
deep-merge the dicts, the child winning. With ``RS_OV_DATA_ROOT`` set, the
test dataset's paths that lie inside the working directory are rebased under
it, keeping their relative layout (``data_synth/`` holds such a tree).
"""

from __future__ import annotations

import os
from typing import Any

__all__ = ["load_config", "deep_merge", "DATA_ROOT_ENV"]

DATA_ROOT_ENV = "RS_OV_DATA_ROOT"


def deep_merge(base: dict, child: dict) -> dict:
    out = dict(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _exec_config(path: str) -> dict[str, Any]:
    path = os.path.abspath(path)
    scope: dict[str, Any] = {"__file__": path, "os": os}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), scope)
    return {k: v for k, v in scope.items() if not k.startswith("__") and k != "os"}


def _remap_dataset_paths(cfg: dict[str, Any], new_root: str) -> None:
    """Rebase data_root / data_prefix paths under ``new_root`` in place;
    paths outside the working directory stay as they are."""
    ds = cfg.get("test_dataloader", {}).get("dataset")
    if not isinstance(ds, dict):
        return

    def remap(p: str) -> str:
        rel = os.path.relpath(os.path.abspath(p), os.getcwd())
        return p if rel.startswith("..") else os.path.join(new_root, rel)

    if isinstance(ds.get("data_root"), str):
        ds["data_root"] = remap(ds["data_root"])
    dp = ds.get("data_prefix")
    if isinstance(dp, dict):
        for k, v in dp.items():
            if isinstance(v, str):
                dp[k] = remap(v)


def _load_config_raw(path: str) -> dict[str, Any]:
    cfg = _exec_config(path)
    bases = cfg.pop("_base_", None)
    if bases:
        if isinstance(bases, str):
            bases = [bases]
        merged: dict[str, Any] = {}
        for b in bases:
            merged = deep_merge(merged, _load_config_raw(
                os.path.join(os.path.dirname(os.path.abspath(path)), b)))
        cfg = deep_merge(merged, cfg)
    return cfg


def load_config(path: str) -> dict[str, Any]:
    cfg = _load_config_raw(path)
    new_root = os.environ.get(DATA_ROOT_ENV)
    if new_root:
        _remap_dataset_paths(cfg, new_root)
    return cfg
