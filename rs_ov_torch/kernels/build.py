"""Build and load the port's CUDA kernels, and declare each one once.

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

``Kernel`` is the one seam through which the program calls a kernel. A kernel
module declares each kernel once: its name, its schema, its plain version,
its operands (a function that checks the arguments, allocates the output and
returns it with the library entry's name, the entry's arguments up to the
stream and the tensors that must outlive the launch) and its fake. The
declaration registers the operator ``rs_ov::<name>`` (``torch.library``: the
plain version for CPU tensors, the launch for CUDA tensors, the fake for
tracing, so that ``torch.export`` records one node per kernel call and an
exported program launches the kernel itself). Called, it routes by one rule:

  * an eager call on CUDA tensors (the first argument a plain
    ``torch.Tensor``, nothing being compiled, no operand needing a gradient)
    launches the kernel directly: the operator's dispatch costs more host
    time than the launch;
  * any other call on a CPU or CUDA tensor goes through the operator: CPU
    tensors, fake or functional tensors under ``torch.export``, calls inside
    ``torch.compile``, operands that need a gradient;
  * a tensor on any other device is refused (``NotImplementedError``).

Both CUDA paths are ``Kernel.launch``, which counts the launch in one table
(``launch_counts``, read by the recorder's spans in ``utils.profiling``, by
taking the difference of two snapshots). Registering loads no library.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import inspect
import os
import shutil
import subprocess
import tempfile

import torch

__all__ = ["load_library", "launch", "check", "Kernel", "KERNELS", "launch_counts",
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
    "rs_linear_epilogue": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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


# CUDA launches so far of each kernel, by the name its readers know it by; K4a
# and K4b share the operator adaptive_conv_tapmajor and count apart, by the
# input's dtype
_LAUNCHES = dict.fromkeys((
    "range_logits", "jbu_epilogue", "jbu_epilogue_classify", "jbu_epilogue_fused",
    "jbu_epilogue_fused_classify", "adaptive_conv_planes", "adaptive_conv_cl", "adaptive_conv_v3",
    "adaptive_conv_v4", "fused_selfself_attention", "layer_norm", "adaptive_conv_tapmajor.bf16",
    "adaptive_conv_tapmajor.f32", "linear_epilogue"), 0)
KERNELS = {}  # every declared Kernel, by its operator's name


class Kernel:
    """The kernel ``name`` and its operator ``rs_ov::<name>`` of ``schema``
    (module docstring): ``plain`` the CPU implementation, ``operands(*args)``
    -> (out, entry, entry's arguments, tensors to keep) the CUDA one's checks
    and output, ``fake`` the output's shape and dtype for tracing. A launch of
    ``entry`` counts under ``counts[entry]``, else under ``name``. Called,
    it takes its arguments as ``plain`` does, by position or keyword.
    Inference only: no autograd formula."""

    def __init__(self, name: str, schema: str, plain, operands, fake, *,
                 counts: dict[str, str] | None = None, doc: str | None = None):
        # as the function it stands for
        self.__name__, self.__doc__, self.__signature__ = name, doc, inspect.signature(plain)
        self.operands, self.counts = operands, counts or {}
        self.counters = tuple(sorted(set(self.counts.values()) or {name}))
        missing = set(self.counters) - _LAUNCHES.keys()
        if missing:
            raise ValueError(f"{name}: launch counters {sorted(missing)} are not in "
                             "kernels/build.py's table")
        self.op = torch.library.custom_op(f"rs_ov::{name}", plain, mutates_args=(),
                                          device_types="cpu", schema=schema)
        self.op.register_kernel("cuda", self.launch)
        self.op.register_fake(fake)
        KERNELS[name] = self

    def launch(self, *args) -> torch.Tensor:
        """The kernel on CUDA operands, counted: the operator's CUDA
        implementation and the direct path."""
        out, entry, largs, _keep = self.operands(*args)  # _keep outlives the launch
        check(launch(getattr(load_library(), entry), largs, out.device), entry)
        _LAUNCHES[self.counts.get(entry, self.__name__)] += 1
        return out

    def __call__(self, *args, **kwargs) -> torch.Tensor:
        if kwargs:
            args = self.__signature__.bind(*args, **kwargs).args
        x = args[0]
        if (type(x) is torch.Tensor and x.is_cuda and not torch.compiler.is_compiling()
                and not (torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad for a in args))):
            return self.launch(*args)
        if x.device.type not in ("cpu", "cuda"):
            raise NotImplementedError(f"{self.__name__}: no route for {x.device}")
        return self.op(*args)


def launch_counts() -> dict[str, int]:
    """A snapshot of every kernel's CUDA launches so far (``_LAUNCHES``)."""
    return dict(_LAUNCHES)
