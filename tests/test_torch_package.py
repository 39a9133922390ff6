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
from rs_ov_torch.kernels.jbu_epilogue import (_classify_operands, _epilogue_operands,
                                              jbu_epilogue, jbu_epilogue_classify)
from rs_ov_torch.kernels.range_logits import _range_logits_operands, range_logits

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
            "assert {'rs_ov_torch.pipeline.export', 'rs_ov_torch.data.converters.convert',\n"
            "        'rs_ov_torch.utils.profiling'} <= set(mods), mods\n"
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
    replaces (or that it replaces none, and the JAX function it computes)
    and what bounds it on the card; every C entry point that
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
        assert re.search(r"Replaces (?:the TPU kernels? rs_ov/kernels/\w+\.py"
                         r"|no TPU kernel: [^.]*rs_ov/\w+/\w+\.py)", head), name
        assert "What bounds it on the H100" in head, name
        defined |= set(re.findall(r'extern "C" (?:int|const char\*) (rs_\w+)\(', text))
    assert defined == set(build._SIGNATURES) | {"rs_error_string"}


def test_bf16_adaptive_conv_source_names_its_tpu_kernels():
    """The source of K4e/K4f's entries names both JAX kernels they replace,
    by file and function."""
    with open(os.path.join(REPO, "rs_ov_torch", "csrc", "adaptive_conv.cu")) as f:
        text = f.read()
    assert "rs_adaptive_conv_v3(" in text and "rs_adaptive_conv_v4(" in text
    head = text.split("#include")[0]
    assert "rs_ov/kernels/adaptive_conv_v3.py" in head and "adaptive_conv_pallas_v3" in head
    assert "rs_ov/kernels/adaptive_conv_v4.py" in head and "adaptive_conv_pallas_v4" in head


def test_native_library_is_the_ports_own():
    """rs_ov_torch.native builds its own copy of the decoder sources into the
    port's build directory and loads nothing under rs_ov/."""
    from rs_ov_torch import native

    lib = native.get_lib()
    assert lib is not None  # g++ is present here
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.realpath(native.BUILD_DIR) + os.sep), path
    # a fresh process that decodes a committed image maps no file of rs_ov/
    code = ("from rs_ov_torch.data.transforms import load_image\n"
            "load_image('data_synth/data/CHN6-CUG/val/image_cvt/syn0.jpg')\n"
            "print(open('/proc/self/maps').read())\n")
    maps = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, check=True, timeout=120).stdout
    assert "libpreprocess_decode" in maps
    assert os.path.join(os.path.realpath(REPO), "rs_ov") + os.sep not in maps
    for src in ("decode.cpp", "preprocess.cpp"):
        assert os.path.exists(os.path.join(REPO, "rs_ov_torch", "native", src))
    rgb = np.random.RandomState(0).randint(0, 256, (5, 7, 3), np.uint8)
    from rs_ov_torch.data.transforms import PREPROC_MEAN, PREPROC_STD

    np.testing.assert_allclose(native.normalize_hwc_to_chw(rgb, PREPROC_MEAN, PREPROC_STD),
                               ((rgb - PREPROC_MEAN) / PREPROC_STD).transpose(2, 0, 1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ViT-B/16", "ViT-L/14", "ViT-B-32", "ViT-H-14",
                                  "ViT-M-16-alt", "ViT-bigG-14"])
def test_config_copy_matches_the_jax_package(name):
    from rs_ov.core.config import get_model_config as jax_cfg
    from rs_ov_torch.core.config import COCA_MODELS, get_model_config, list_models

    assert dataclasses.asdict(get_model_config(name)) == dataclasses.asdict(jax_cfg(name))
    for n in list_models():  # every entry the port lists has the JAX numbers, CoCa's too
        assert dataclasses.asdict(get_model_config(n)) == dataclasses.asdict(jax_cfg(n)), n
    assert set(COCA_MODELS) <= set(list_models())
    ours = get_model_config(name)
    assert (ours.vision.heads, ours.vision.grid_size) == (jax_cfg(name).vision.heads,
                                                          jax_cfg(name).vision.grid_size)
    # the timm towers' arch table is a copy too, and names every timm config's arch
    from rs_ov.nn.timm_tower import TIMM_ARCHS as JAX_TIMM_ARCHS
    from rs_ov_torch.nn.timm_tower import TIMM_ARCHS

    assert {k: dataclasses.asdict(v) for k, v in TIMM_ARCHS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_TIMM_ARCHS.items()}
    timm_names = {get_model_config(n).vision.timm_model_name for n in list_models()
                  if n not in COCA_MODELS} - {None}
    assert timm_names == set(TIMM_ARCHS)


def test_bridge_takes_the_ports_own_config():
    from rs_ov_torch.core.config import CLIPConfig as TCLIP, TextConfig as TText
    from rs_ov_torch.core.config import VisionConfig as TVision

    ours = TCLIP(embed_dim=32, vision=TVision(**dataclasses.asdict(CFG.vision)),
                 text=TText(**dataclasses.asdict(CFG.text)))
    tree = _tree()
    clip = clip_params_from_numpy(tree, ours)
    np.testing.assert_array_equal(clip.text.token_embedding.numpy(),
                                  tree["text"]["token_embedding"])


_CONFIGS = ["configs/base_config.py", "configs/cfg_potsdam.py", "configs/cfg_loveda.py"]


@pytest.mark.parametrize("path,data_root", [pytest.param(p, None, id=p) for p in _CONFIGS] + [
    pytest.param(p, root, id=f"{p}-RS_OV_DATA_ROOT={root}") for p in _CONFIGS[1:]
    for root in ("data_synth", "/elsewhere/root")])
def test_config_loader_matches_the_jax_package(path, data_root, monkeypatch):
    """Also with the dataset paths rebased under RS_OV_DATA_ROOT."""
    from rs_ov.evalsuite.config import load_config as jax_load
    from rs_ov_torch.evalsuite.config import load_config

    monkeypatch.chdir(REPO)
    if data_root is None:
        monkeypatch.delenv("RS_OV_DATA_ROOT", raising=False)
    else:
        monkeypatch.setenv("RS_OV_DATA_ROOT", data_root)
    cfg = load_config(path)
    assert cfg == jax_load(path)
    if data_root and "test_dataloader" in cfg:
        assert cfg["test_dataloader"]["dataset"]["data_root"].startswith(data_root)


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
    before = build.launch_counts()
    range_logits(torch.randn(1, 4, 10, 10), torch.randn(1, 4, 6, 6), 5)
    a = _epilogue_args()
    assert jbu_epilogue(*a, 5).dtype == torch.bfloat16
    out = jbu_epilogue_classify(*a, torch.randn(4, 4), torch.randn(4), torch.randn(3, 4), 5)
    assert out.shape == (2, 6, 7, 3) and out.dtype == torch.float32
    assert build.launch_counts() == before


def test_other_devices_raise():
    with pytest.raises(NotImplementedError, match="no route"):
        range_logits(torch.empty(1, 4, 10, 10, device="meta"),
                     torch.empty(1, 4, 6, 6, device="meta"), 5)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The operand checks, which run before the library is touched, so they
    hold here."""
    with pytest.raises(ValueError, match="fp32|float32"):
        _range_logits_operands(torch.randn(1, 4, 10, 10, dtype=torch.float64),
                               torch.randn(1, 4, 6, 6), 5)
    with pytest.raises(ValueError, match="does not match"):
        _range_logits_operands(torch.randn(1, 4, 11, 10), torch.randn(1, 4, 6, 6), 5)
    with pytest.raises(ValueError, match="K <= 32"):
        _range_logits_operands(torch.randn(1, 40, 10, 10), torch.randn(1, 40, 6, 6), 5)
    with pytest.raises(NotImplementedError, match="fp32 takes the channel-first route"):
        _epilogue_operands(*_epilogue_args(dtype=torch.float32), 5)
    a = _epilogue_args()
    a[2] = a[2][:, :, :-1]  # guidance one pixel short
    with pytest.raises(ValueError, match="guid_t"):
        _epilogue_operands(*a, 5)
    a = _epilogue_args()
    a[0] = a[0].transpose(1, 2)  # not contiguous and misshapen
    with pytest.raises(ValueError, match="inp"):
        _epilogue_operands(*a, 5)
    with pytest.raises(ValueError, match="even channel"):
        _epilogue_operands(*_epilogue_args(c=3), 5)
    with pytest.raises(ValueError, match="weight of shape"):
        _epilogue_operands(*_epilogue_args()[:5], torch.randn(25, 27), *_epilogue_args()[6:], 5)
    with pytest.raises(ValueError, match="fixup_w"):
        _classify_operands(*_epilogue_args(), torch.randn(4, 5), torch.randn(4),
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
            _epilogue_operands(*b, 5)
    for i, name in enumerate(("fixup_w", "weight", "query_features")):
        t = list(tail)
        t[i] = host_tail[i]
        with pytest.raises(ValueError, match=f"{name}.* is on cpu"):
            _classify_operands(*a, *t, 5)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load_library()
    finally:
        build.load_library.cache_clear()


def test_kernel_resources_reads_the_ptxas_report(tmp_path):
    """rs_ov_torch.tools.kernel_resources names each kernel instantiation by
    its template arguments and reads its registers and spills from the
    build's -Xptxas -v log."""
    from rs_ov_torch.tools.kernel_resources import _short, ptxas_report

    k6 = ("_ZN63_GLOBAL__N__daf6626a_30_selfself_attention_f32_sm90_cu_a97098f029"
          "selfself_attention_f32_kernelILi5ELi26EEvPKfS2_S2_S2_Pfiiiffi")
    k1 = "_ZN48_GLOBAL__N__e04d9891_15_range_logits_cu_2590296019range_logits_kernelILi11EEvPKfS2_Pfiii"
    assert _short(k6) == "selfself_attention_f32_kernel<5, 26>"
    assert _short(k1) == "range_logits_kernel<11>"
    assert _short("_ZN12_GLOBAL__N_119jbu_classify_kernelILb1EEEvNS_4ArgsE") == \
        "jbu_classify_kernel<1>"
    assert _short("_ZN12_GLOBAL__N_120adaptive_conv_kernelI13__nv_bfloat16Li128EEEvPKT_") == \
        "adaptive_conv_kernel<__nv_bfloat16, 128>"
    assert _short("_ZN12_GLOBAL__N_120adaptive_conv_kernelIfLi32EEEvPKT_S3_PS1_") == \
        "adaptive_conv_kernel<float, 32>"
    assert _short("_ZN12_GLOBAL__N_120adaptive_conv_kernelI13__nv_bfloat16S1_Li128ELb1EEEvPKT_"
                  "PKT0_PS2_iiiiiiii") == "adaptive_conv_kernel<__nv_bfloat16, __nv_bfloat16, 128, 1>"
    assert _short("_ZN12_GLOBAL__N_120adaptive_conv_kernelIf13__nv_bfloat16Li32ELb0EEEvPKT_") == \
        "adaptive_conv_kernel<float, __nv_bfloat16, 32, 0>"
    log = tmp_path / "lib.so.x.cu.log"
    log.write_text(
        f"ptxas info    : Compiling entry function '{k6}' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size\n"
        f"ptxas info    : Compiling entry function '{k1}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n")
    assert ptxas_report(str(log)) == {
        "selfself_attention_f32_kernel<5, 26>": {"registers": 255, "spill_stores": 4,
                                                 "spill_loads": 12},
        "range_logits_kernel<11>": {"registers": 64, "spill_stores": 0, "spill_loads": 0}}


def test_profile_request_groups_the_kernels_by_name():
    """rs_ov_torch.tools.profile_request books each JBU kernel instantiation
    under its own name, the fused-range ones (template argument kFused)
    apart from K2 and K3, whose block they share."""
    from rs_ov_torch.tools.profile_request import _group

    ns = "void (anonymous namespace)::"
    args = "((anonymous namespace)::Args)"
    for kernel, group in [("jbu_classify_kernel<true, true>", "K5b jbu_epilogue_fused_classify"),
                          ("jbu_classify_kernel<false, true>", "K5b jbu_epilogue_fused_classify"),
                          ("jbu_epilogue_kernel<true, true>", "K5a jbu_epilogue_fused"),
                          ("jbu_epilogue_kernel<false, true>", "K5a jbu_epilogue_fused"),
                          ("jbu_classify_kernel<true, false>", "K3 jbu_epilogue_classify"),
                          ("jbu_epilogue_kernel<false, false>", "K2 jbu_epilogue"),
                          ("range_logits_kernel<11>", "K1 range_logits"),
                          ("layer_norm_warp<__nv_bfloat16, __nv_bfloat16, 3>", "K7 layer_norm"),
                          ("linear_epilogue_kernel<__nv_bfloat16, 1, 1, 8>",
                           "K8 linear_epilogue")]:
        assert _group(ns + kernel + args) == group, kernel
