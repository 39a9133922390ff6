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
on that stream and returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.
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

__all__ = ["load_library", "check", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers, ints, floats, stream; every entry point returns cudaError_t
_SIGNATURES = {
    "rs_range_logits": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue_classify": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_jbu_epilogue_fused_classify": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_planes": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_cl": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_v3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_adaptive_conv_v4": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rs_selfself_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "rs_selfself_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
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
    """Compile (if needed) and load the kernel library."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, f"librs_ov_kernels_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        _build(sources, lib_path)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rs_error_string.argtypes = [_I]
    lib.rs_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = load_library().rs_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
