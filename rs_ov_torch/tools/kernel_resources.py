"""Registers, spills and tensor-core instructions of each built kernel.

    python3 -m rs_ov_torch.tools.kernel_resources [--source range_logits.cu ...]

Builds the kernel library if needed (``kernels.build.load_library``), then
prints, for each kernel instantiation of the named sources (all of
``rs_ov_torch/csrc/*.cu`` by default), the registers and spill bytes that
``nvcc -Xptxas -v`` reported at build time and the count of each ``HMMA``
instruction form in its SASS (``cuobjdump -sass`` of the library). Needs the
CUDA toolkit, as the build does.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess

__all__ = ["ptxas_report", "hmma_counts"]

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")


_BUILTIN = {"f": "float", "d": "double", "i": "int", "b": "bool"}
# one template argument: a literal (Li64E, Lb1E), a named type (13__nv_bfloat16),
# a builtin type (f) or a substitution of an earlier name (S_, S0_, S1_, ...)
_TARG = re.compile(r"L[a-z](\d+)E|(\d+)|([fdib])|S([0-9A-Z]*)_")


def _short(mangled: str) -> str:
    """The kernel's name with its template arguments, from an Itanium-mangled
    name (``_ZN<n><namespace><n>name_kernelILi5ELi26EEv...`` ->
    ``name_kernel<5, 26>``, ``...kernelI13__nv_bfloat16S1_Li64EEEv...`` ->
    ``kernel<__nv_bfloat16, __nv_bfloat16, 64>``); other names as they are."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name, subs = 3, mangled, []  # subs: the names a substitution may repeat, in order
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        subs.append(None)  # each enclosing prefix is a candidate, never a type argument
    if not mangled.startswith("I", i):
        return name
    i, args = i + 1, []
    while i < len(mangled) and mangled[i] != "E":
        m = _TARG.match(mangled, i)
        if not m:
            return name
        if m.group(2):  # a length-prefixed type name
            end = m.end() + int(m.group(2))
            args.append(mangled[m.end():end])
            subs.append(args[-1])
            i = end
        elif m.group(4) is not None:
            k = int(m.group(4), 36) + 1 if m.group(4) else 0
            if k >= len(subs) or subs[k] is None:
                return name
            args.append(subs[k])
            i = m.end()
        else:
            args.append(m.group(1) or _BUILTIN[m.group(3)])
            i = m.end()
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log_path: str) -> dict[str, dict[str, int]]:
    """{kernel: {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}
    from one source's ``-Xptxas -v`` log."""
    out: dict[str, dict[str, int]] = {}
    name = None
    with open(log_path) as f:
        for line in f:
            m = _ENTRY.search(line)
            if m:
                name = _short(m.group(1))
                out[name] = {}
            elif name and "spill stores" in line:
                out[name]["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
                out[name]["spill_loads"] = int(re.search(r"(\d+) bytes spill loads", line).group(1))
            elif name and "Used" in line and "registers" in line:
                out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def hmma_counts(lib_path: str) -> dict[str, collections.Counter]:
    """{kernel: Counter of HMMA forms} from the SASS of the library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out: dict[str, collections.Counter] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _short(line.split("Function :")[1].strip())
            out.setdefault(name, collections.Counter())
        elif name and "HMMA" in line:
            out[name]["HMMA" + line.split("HMMA")[1].split()[0]] += 1
    return out


def main(argv=None) -> None:
    from rs_ov_torch.kernels.build import CSRC, load_library

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", nargs="*", default=None,
                    help="sources under rs_ov_torch/csrc (default: all)")
    opts = ap.parse_args(argv)
    lib = load_library()._name
    sources = opts.source or sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
    hmma = hmma_counts(lib)
    for src in sources:
        for name, r in ptxas_report(f"{lib}.{src}.log").items():
            forms = " ".join(f"{k} {v}" for k, v in sorted(hmma.get(name, {}).items()))
            print(f"[resources] {src} {name}: {r.get('registers')} registers, spill stores "
                  f"{r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B"
                  f"{'; ' + forms if forms else ''}")


if __name__ == "__main__":
    main()
