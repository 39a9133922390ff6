"""Package rules of the port: no jax, a strict weight bridge, CPU tensors on
the plain route, CUDA wrappers that refuse what their kernels do not take."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov_torch.core.params import clip_params_from_numpy, jbu_params_from_numpy
from rs_ov_torch.kernels import build
from rs_ov_torch.kernels.jbu_epilogue import (_jbu_epilogue_classify_cuda,
                                              _jbu_epilogue_cuda, jbu_epilogue,
                                              jbu_epilogue_classify)
from rs_ov_torch.kernels.range_logits import _range_logits_cuda, range_logits

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=32, patch_size=16, width=32, layers=2,
                        output_dim=32, head_width=16),
    text=TextConfig(context_length=77, vocab_size=64, width=16, heads=2,
                    layers=1, output_dim=32))


def test_port_imports_without_jax():
    """Every module of the port imports, and none of them pulls in jax or
    any module of the JAX package rs_ov, jax-free ones included."""
    code = ("import importlib, pkgutil, sys, rs_ov_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(rs_ov_torch.__path__, 'rs_ov_torch.')]\n"
            "[importlib.import_module(m) for m in mods]\n"
            "assert len(mods) >= 25, mods\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'rs_ov' or m.startswith('rs_ov.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_chip_smoke_imports_neither_jax_nor_rs_ov():
    """chip_smoke.py imports no jax and nothing of rs_ov, and reaches every
    kernel module of the port (each one it checks on the card)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    froms = {(n.module, a.name) for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             for a in n.names}
    assert "rs_ov_torch.pipeline.segmentor" in names
    kernels = [os.path.splitext(f)[0] for f in os.listdir(os.path.join(REPO, "rs_ov_torch",
                                                                       "kernels"))
               if f.endswith(".py") and f not in ("__init__.py", "build.py")]
    for mod in kernels:
        assert (f"rs_ov_torch.kernels.{mod}" in names
                or ("rs_ov_torch.kernels", mod) in froms), mod
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "rs_ov")]
    assert not bad, bad


def test_cuda_sources_note_their_tpu_kernel_and_export_the_bound_signatures():
    """Each rs_ov_torch/csrc/*.cu opens with a note naming the TPU kernel it
    replaces and what bounds it on the card; every C entry point that
    kernels/build.py binds is defined in a source, and every one a source
    defines is bound."""
    import re

    csrc = os.path.join(REPO, "rs_ov_torch", "csrc")
    defined = set()
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        head = text[:text.index("#include")]
        assert re.search(r"Replaces the TPU kernels? rs_ov/kernels/\w+\.py", head), name
        assert "What bounds it on the H100" in head, name
        defined |= set(re.findall(r'extern "C" (?:int|const char\*) (rs_\w+)\(', text))
    assert defined == set(build._SIGNATURES) | {"rs_error_string"}


@pytest.mark.parametrize("name", ["ViT-B/16", "ViT-L/14", "ViT-B-32", "ViT-H-14",
                                  "ViT-M-16-alt", "ViT-bigG-14"])
def test_config_copy_matches_the_jax_package(name):
    from rs_ov.core.config import get_model_config as jax_cfg
    from rs_ov_torch.core.config import get_model_config, list_models

    assert dataclasses.asdict(get_model_config(name)) == dataclasses.asdict(jax_cfg(name))
    for n in list_models():  # every entry the port lists has the JAX numbers
        assert dataclasses.asdict(get_model_config(n)) == dataclasses.asdict(jax_cfg(n))
    ours = get_model_config(name)
    assert (ours.vision.heads, ours.vision.grid_size) == (jax_cfg(name).vision.heads,
                                                          jax_cfg(name).vision.grid_size)


def test_bridge_takes_the_ports_own_config():
    from rs_ov_torch.core.config import CLIPConfig as TCLIP, TextConfig as TText
    from rs_ov_torch.core.config import VisionConfig as TVision

    ours = TCLIP(embed_dim=32, vision=TVision(**dataclasses.asdict(CFG.vision)),
                 text=TText(**dataclasses.asdict(CFG.text)))
    tree = _tree()
    clip = clip_params_from_numpy(tree, ours)
    np.testing.assert_array_equal(clip.text.token_embedding.numpy(),
                                  tree["text"]["token_embedding"])


@pytest.mark.parametrize("path", ["configs/base_config.py", "configs/cfg_potsdam.py",
                                  "configs/cfg_loveda.py"])
def test_config_loader_matches_the_jax_package(path, monkeypatch):
    from rs_ov.evalsuite.config import load_config as jax_load
    from rs_ov_torch.evalsuite.config import load_config

    monkeypatch.chdir(REPO)
    monkeypatch.delenv("RS_OV_DATA_ROOT", raising=False)
    assert load_config(path) == jax_load(path)


def test_transform_constants_match_the_jax_package():
    from rs_ov.data.transforms import PREPROC_MEAN as M, PREPROC_STD as S
    from rs_ov_torch.data.transforms import PREPROC_MEAN, PREPROC_STD

    np.testing.assert_array_equal(PREPROC_MEAN, M)
    np.testing.assert_array_equal(PREPROC_STD, S)


def _tree():
    return jax.tree_util.tree_map(np.asarray, init_clip_params(jax.random.PRNGKey(0), CFG))


def test_bridge_consumes_every_key():
    tree = _tree()
    clip = clip_params_from_numpy(tree, CFG)
    np.testing.assert_array_equal(clip.visual.blocks[1].attn.in_proj_w.numpy(),
                                  tree["visual"]["blocks"][1]["attn"]["in_proj_w"])
    assert float(clip.logit_scale) == pytest.approx(float(tree["logit_scale"]))
    up_tree = jax.tree_util.tree_map(np.asarray,
                                     init_jbu_one_params(jax.random.PRNGKey(1), 32))
    up = jbu_params_from_numpy(up_tree, 32)
    np.testing.assert_array_equal(up.up.fixup_proj.w0.numpy(), up_tree["up"]["fixup_proj"]["w0"])

    extra = _tree()
    extra["visual"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused.*visual.stray"):
        clip_params_from_numpy(extra, CFG)
    missing = _tree()
    del missing["text"]["ln_final"]
    with pytest.raises(KeyError, match="missing.*text.ln_final"):
        clip_params_from_numpy(missing, CFG)
    wrong = _tree()
    wrong["visual"]["proj"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="visual.proj"):
        clip_params_from_numpy(wrong, CFG)


def _epilogue_args(d=5, h=6, w=7, c=4, g=3, dtype=torch.bfloat16):
    g_ = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g_).to(dt)  # noqa: E731
    dd = d * d
    return [r(2, h + d - 1, w + d - 1, c, dt=dtype), r(2, h, w, dd), r(2, h, w, g, dt=dtype),
            r(dd), torch.tensor(1.0), r(dd, dd + g), r(dd), r(dd, dd), r(dd)]


def test_cpu_tensors_take_the_plain_route():
    counters = (range_logits, jbu_epilogue, jbu_epilogue_classify)
    before = [f.launches for f in counters]
    range_logits(torch.randn(1, 4, 10, 10), torch.randn(1, 4, 6, 6), 5)
    a = _epilogue_args()
    assert jbu_epilogue(*a, 5).dtype == torch.bfloat16
    out = jbu_epilogue_classify(*a, torch.randn(4, 4), torch.randn(4), torch.randn(3, 4), 5)
    assert out.shape == (2, 6, 7, 3) and out.dtype == torch.float32
    assert [f.launches for f in counters] == before


def test_other_devices_raise():
    with pytest.raises(NotImplementedError, match="no route"):
        range_logits(torch.empty(1, 4, 10, 10, device="meta"),
                     torch.empty(1, 4, 6, 6, device="meta"), 5)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks run before the library is touched, so they hold here."""
    with pytest.raises(ValueError, match="fp32|float32"):
        _range_logits_cuda(torch.randn(1, 4, 10, 10, dtype=torch.float64),
                           torch.randn(1, 4, 6, 6), 5)
    with pytest.raises(ValueError, match="does not match"):
        _range_logits_cuda(torch.randn(1, 4, 11, 10), torch.randn(1, 4, 6, 6), 5)
    with pytest.raises(ValueError, match="K <= 32"):
        _range_logits_cuda(torch.randn(1, 40, 10, 10), torch.randn(1, 40, 6, 6), 5)
    with pytest.raises(NotImplementedError, match="fp32 takes the channel-first route"):
        _jbu_epilogue_cuda(*_epilogue_args(dtype=torch.float32), 5)
    a = _epilogue_args()
    a[2] = a[2][:, :, :-1]  # guidance one pixel short
    with pytest.raises(ValueError, match="guid_t"):
        _jbu_epilogue_cuda(*a, 5)
    a = _epilogue_args()
    a[0] = a[0].transpose(1, 2)  # not contiguous and misshapen
    with pytest.raises(ValueError, match="inp"):
        _jbu_epilogue_cuda(*a, 5)
    with pytest.raises(ValueError, match="even channel"):
        _jbu_epilogue_cuda(*_epilogue_args(c=3), 5)
    with pytest.raises(ValueError, match="weight of shape"):
        _jbu_epilogue_cuda(*_epilogue_args()[:5], torch.randn(25, 27), *_epilogue_args()[6:], 5)
    with pytest.raises(ValueError, match="fixup_w"):
        _jbu_epilogue_classify_cuda(*_epilogue_args(), torch.randn(4, 5), torch.randn(4),
                                    torch.randn(3, 4), 5)
    # every operand must lie on the features' device: here the features are
    # on "meta" and one weight at a time stays on the host
    host = _epilogue_args()
    a = [t.to("meta") for t in host]
    host_tail = [torch.randn(4, 4), torch.randn(4), torch.randn(3, 4)]
    tail = [t.to("meta") for t in host_tail]
    for i in range(5, 9):
        b = list(a)
        b[i] = host[i]
        with pytest.raises(ValueError, match="weight .* is on cpu"):
            _jbu_epilogue_cuda(*b, 5)
    for i, name in enumerate(("fixup_w", "weight", "query_features")):
        t = list(tail)
        t[i] = host_tail[i]
        with pytest.raises(ValueError, match=f"{name}.* is on cpu"):
            _jbu_epilogue_classify_cuda(*a, *t, 5)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load_library()
    finally:
        build.load_library.cache_clear()
