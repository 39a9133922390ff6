"""mmengine-style Python config loader with ``_base_`` inheritance
(rs_ov/evalsuite/config.py): exec the file, load its bases recursively and
deep-merge the dicts, the child winning. The dataset-path remapping of the
JAX loader belongs to the eval entries, which are not ported yet (ROADMAP
queue 1 item 6)."""

from __future__ import annotations

import os
from typing import Any

__all__ = ["load_config", "deep_merge"]


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


def load_config(path: str) -> dict[str, Any]:
    cfg = _exec_config(path)
    bases = cfg.pop("_base_", None)
    if bases:
        if isinstance(bases, str):
            bases = [bases]
        merged: dict[str, Any] = {}
        for b in bases:
            merged = deep_merge(merged, load_config(
                os.path.join(os.path.dirname(os.path.abspath(path)), b)))
        cfg = deep_merge(merged, cfg)
    return cfg
