"""Build and load the port's CUDA kernels.

Every ``rs_ov_torch/csrc/*.cu`` is compiled by its own ``nvcc`` for
``sm_90a``, all of them at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``rs_ov_torch/_build/`` (ignored by git), and is keyed on a
hash of the sources and flags, so an edited source rebuilds. There is no
fallback: a missing ``nvcc`` or a failed build raises. Each source's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside the
library as ``<library>.<source>.log``.

Each C entry point takes device pointers, ints, floats and the CUDA stream, launches
on that stream and returns ``cudaGetLastError()``; ``launch`` calls one on the
current stream of a device, ``check`` raises on a non-zero code.

``register_op`` makes each kernel an operator of the ``rs_ov`` namespace
(``torch.library.custom_op``): the plain version for CPU tensors, the kernel
for CUDA tensors, a fake for tracing. ``torch.export`` then records one
node per kernel call, and an exported program launches the kernel itself.
Registering loads no library.

``launch_counts`` reads every kernel operator's launch counter (the
``.launches`` attribute its CUDA implementation bumps), for the recorder's
spans (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

__all__ = ["load_library", "launch", "check", "register_op", "launch_counts",
           "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers, ints, floats, stream; every entry point returns
# cudaError_t, but rs_jbu_block_smem, rs_adaptive_conv_smem and
# rs_selfself_attention_f32_smem a block's bytes of shared memory
_SIGNATURES = {
    "rs_range_logits": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue_classify": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue_fused_classify": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_block_smem": [_I, _I, _I, _I, _I],
    "rs_adaptive_conv_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_smem": [_I, _I, _I, _I, _I, _I, _I],
    "rs_adaptive_conv_planes": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_cl": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_v3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_v4": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_selfself_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "rs_selfself_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "rs_selfself_attention_f32_smem": [_I, _I, _I],
    "rs_layer_norm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _build(sources: list[str], lib_path: str) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src, log) for src, log, proc in zip(sources, logs, procs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{s}:\n{log}" for s, log in failed))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        for src, log in zip(sources, logs):
            with open(f"{lib_path}.{os.path.basename(src)}.log", "w") as f:
                f.write(log)
        os.replace(tmp, lib_path)  # atomic: a concurrent process never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; the build and the
    load inside the span ``rs_ov/setup/kernel_library`` (``built``: whether
    this call compiled the library), after the sources' hash (milliseconds)."""
    from rs_ov_torch.utils.profiling import span

    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, f"librs_ov_kernels_{digest.hexdigest()[:16]}.so")
    built = not os.path.exists(lib_path)
    with span("rs_ov/setup/kernel_library", built=built):
        if built:
            _build(sources, lib_path)
        lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rs_error_string.argtypes = [_I]
    lib.rs_error_string.restype = ctypes.c_char_p
    return lib


def launch(fn, args: tuple, device: torch.device) -> int:
    """``fn(*args, stream)`` on the current stream of the CUDA ``device``;
    returns fn's error code. The raw stream handle: torch.cuda.current_stream()
    and the device guard each cost as much host time as the launch itself, so
    the guard is entered only for a device other than the current one."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def check(code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = load_library().rs_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")


def register_op(name: str, schema: str, plain, cuda, fake):
    """The operator ``rs_ov::<name>`` of ``schema``: ``plain`` is its CPU
    implementation, ``cuda`` its CUDA one (the kernel's launch, which counts
    it) and ``fake`` the output's shape and dtype for tracing (and meta
    tensors). No implementation stands in for another; the wrappers refuse
    a tensor on any other device. Inference only: no autograd formula."""
    op = torch.library.custom_op(f"rs_ov::{name}", plain, mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    return op


@functools.cache
def _counted() -> tuple:
    """(the kernel operators' wrappers, ``adaptive_conv_tapmajor``), each
    with its launch counter; imported at first use, since each kernel
    module imports this one."""
    from rs_ov_torch.kernels import adaptive_conv as ac
    from rs_ov_torch.kernels import jbu_epilogue as je
    from rs_ov_torch.kernels import layer_norm as ln
    from rs_ov_torch.kernels import range_logits as rl
    from rs_ov_torch.kernels import selfself_attention as sa

    return ((rl.range_logits, je.jbu_epilogue, je.jbu_epilogue_classify, je.jbu_epilogue_fused,
             je.jbu_epilogue_fused_classify, ac.adaptive_conv_planes, ac.adaptive_conv_cl,
             ac.adaptive_conv_v3, ac.adaptive_conv_v4, sa.fused_selfself_attention,
             ln.layer_norm),
            ac.adaptive_conv_tapmajor)


def launch_counts() -> dict[str, int]:
    """CUDA launches so far of each kernel operator, by its wrapper's name;
    ``adaptive_conv_tapmajor`` by the input's dtype (``.bf16``: K4a,
    ``.f32``: K4b)."""
    fns, tap = _counted()
    counts = {fn.__name__: fn.launches for fn in fns}
    counts["adaptive_conv_tapmajor.bf16"] = tap.launches[torch.bfloat16]
    counts["adaptive_conv_tapmajor.f32"] = tap.launches[torch.float32]
    return counts
