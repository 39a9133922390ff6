"""safetensors reader and writer (rs_ov/utils/safetensors.py), bf16 through
torch.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to {dtype, shape, data_offsets}, then the raw little-endian
tensor bytes back to back. ``load_safetensors`` returns CPU torch tensors
(bf16 included, which numpy has no type for); ``save_safetensors`` takes
torch tensors or numpy arrays.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

__all__ = ["save_safetensors", "load_safetensors"]

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool, "U16": torch.uint16, "U32": torch.uint32,
    "U64": torch.uint64,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        t = x.detach().cpu()
    else:  # contiguous, writable and little-endian, 0-d arrays kept 0-d
        a = np.asarray(x)
        t = torch.from_numpy(np.require(a, a.dtype.newbyteorder("<"), ["C", "W"]))
    if t.dtype not in _DTYPE_NAMES:
        raise ValueError(f"unsupported dtype for safetensors: {t.dtype}")
    return t.contiguous()


def save_safetensors(tensors: dict, path: str, metadata: dict[str, str] | None = None) -> None:
    """Write ``{name: tensor or array}`` to ``path`` in safetensors layout
    (sorted names, contiguous little-endian data)."""
    header: dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs: list[bytes] = []
    offset = 0
    for name in sorted(tensors):
        t = _as_tensor(tensors[name])
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((-len(hjson)) % 8)  # the spec pads the header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a safetensors file into ``{name: CPU tensor}``."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        data = bytearray(f.read())
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"unsupported safetensors dtype: {info['dtype']}")
        start, end = info["data_offsets"]
        raw = torch.frombuffer(data, dtype=torch.uint8, offset=start, count=end - start) \
            if end > start else torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(_DTYPES[info["dtype"]]).reshape(info["shape"]).clone()
    return out
