"""Serving export of the per-geometry predict program (rs_ov/pipeline/export.py).

``export_predict`` traces one image geometry of a segmentor's predict path
with ``torch.export`` into a self-contained artifact: the visual tower's and
the upsampler's weights, the text queries, the one-hot synonym map and the
normalisation constants go in with the program; the text tower does not.
Every kernel call is one node, the operator ``rs_ov::<kernel>``
(``kernels.build.Kernel``), so the served program launches the same
hand-written kernels as the live segmentor and counts them as it does.
``load_predict`` rebuilds a callable from the artifact without the
segmentor, its checkpoints or a retrace.

The artifact is tied to the device type it was exported on (the program's
constants live there): export on the kind of device you serve on. A
segmentor with a mesh is refused: its collectives are not exported.

    seg = SegmentorEx(...)
    export_predict(seg, (512, 512), "model_512.rsovt")
    predict = load_predict("model_512.rsovt")
    out = predict(img_uint8_hw3)   # {"probs": [C, H, W], "pred_sem_seg": [1, H, W]}

    python -m rs_ov_torch.pipeline.export --name-path configs/cls_potsdam.txt -o model.rsovt
"""

from __future__ import annotations

import io
import json
import os
import struct

import torch
from torch import nn

__all__ = ["export_predict", "load_predict"]

# the file's own magic: the JAX package's loader refuses this artifact, and
# this loader the JAX package's (b"RSOVEXP1")
_MAGIC = b"RSOVTEX1"
FORMAT = "rs_ov_torch.export_predict"


class _Serve(nn.Module):
    """One image geometry of ``seg``'s predict path as a module: the image
    tower's parts and the upsampler as submodules, the queries, the one-hot
    map and the mean / std as buffers."""

    _SEG_BUFFERS = (("queries", "query_features"), ("onehot", "_onehot"), ("mean", "_mean"),
                    ("std", "_std"))

    def __init__(self, seg, ori_shape, raw: bool):
        super().__init__()
        if seg.is_blip:
            self.tower = nn.ModuleDict({"visual": seg.blip.visual,
                                        "vision_proj": seg.blip.vision_proj})
        else:
            self.tower = nn.ModuleDict({"visual": seg.clip.visual})
        self.upsampler = seg.upsampler
        for name, attr in self._SEG_BUFFERS:
            self.register_buffer(name, getattr(seg, attr))
        self.__dict__["seg"] = seg  # not a submodule: its text tower stays out
        self.ori_shape, self.raw = tuple(ori_shape), raw

    def forward(self, img: torch.Tensor):
        seg = self.seg
        saved = {attr: getattr(seg, attr) for _, attr in self._SEG_BUFFERS}
        # the segmentor reads the module's buffers, which the trace follows
        for name, attr in self._SEG_BUFFERS:
            setattr(seg, attr, getattr(self, name))
        try:
            x = seg._normalise(img)[None] if self.raw else img
            res = seg._forward_images(x, self.ori_shape)[0]
        finally:
            for attr, value in saved.items():
                setattr(seg, attr, value)
        return res["seg_logits"], res["pred_sem_seg"]


def export_predict(seg, image_hw: tuple[int, int], path: str,
                   ori_shape: tuple[int, int] | None = None, raw: bool = True) -> dict:
    """Write the predict program of ``seg`` for one image geometry to ``path``.

    image_hw: the geometry the program takes. raw=True takes uint8 [H, W, 3]
    (normalised in the program), raw=False normalised fp32 [1, 3, H, W].
    ori_shape (default image_hw) is the output's size. Returns the header."""
    if getattr(seg, "mesh", None) is not None:
        raise ValueError("export_predict: a segmentor with a mesh cannot be exported (its "
                         "collectives are not part of the program); export one without")
    h, w = image_hw
    ori = tuple(ori_shape) if ori_shape is not None else (h, w)
    if raw:
        example = torch.zeros((h, w, 3), dtype=torch.uint8, device=seg.device)
    else:
        example = torch.zeros((1, 3, h, w), dtype=torch.float32, device=seg.device)
    with torch.no_grad():
        program = torch.export.export(_Serve(seg, ori, raw), (example,), strict=False)
    blob = io.BytesIO()
    torch.export.save(program, blob)
    header = {
        "format": FORMAT, "image_hw": [h, w], "ori_shape": list(ori), "raw": raw,
        "pred_dtype": str(seg.pred_dtype).removeprefix("torch."),
        "platforms": [seg.device.type],
        "num_queries": int(seg.query_features.shape[0]),
    }
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(blob.getbuffer())
    return header


def load_predict(path: str, device=None):
    """The serving callable of an ``export_predict`` artifact:
    ``fn(img) -> {"probs", "pred_sem_seg"}`` on the artifact's contract,
    ``fn.header`` its header, ``fn.program`` the ``ExportedProgram`` (its
    graph holds one ``rs_ov::<kernel>`` node per kernel call). ``device``:
    where it is served, the card by default; it must be the device type the
    artifact was exported on."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not an rs_ov_torch export artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: not an rs_ov_torch export artifact "
                         f"(format {header.get('format')!r})")
    want = torch.device(device if device is not None else "cuda").type
    platform = header["platforms"][0]
    if platform != want:
        raise ValueError(f"{path} was exported on {platform} and cannot be served on {want}: "
                         "export on the kind of device you serve on")
    if want == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} serves on a CUDA card and found none "
                           "(torch.cuda.is_available() is false)")
    # the kernels' operators must be registered before the program loads
    from rs_ov_torch.kernels import adaptive_conv, jbu_epilogue, layer_norm  # noqa: F401
    from rs_ov_torch.kernels import linear_epilogue  # noqa: F401
    from rs_ov_torch.kernels import range_logits, selfself_attention  # noqa: F401

    program = torch.export.load(io.BytesIO(blob))
    module = program.module()

    def fn(img):
        x = torch.as_tensor(img).to(want)
        with torch.no_grad():
            probs, pred = module(x)
        return {"probs": probs, "pred_sem_seg": pred}

    fn.header, fn.program = header, program
    return fn


def _cli(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Export the predict program for serving")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 512), metavar=("H", "W"))
    ap.add_argument("--name-path", required=True, help="cls_*.txt class vocabulary")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--simfeatup-ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="the device to export on (and to serve on): the card by default")
    ap.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)

    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    seg = SegmentorEx(
        clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
        name_path=args.name_path, ignore_residual=True,
        apply_sim_feat_up=True, global_debias_factor=0.2,
        apply_outlier_suppression=True, outlier_suppression_cfg={"top_k": 30},
        apply_similarity_enhancement=True,
        checkpoint_path=args.checkpoint,
        sim_feat_up_cfg={"model_name": "jbu_one", "model_path": args.simfeatup_ckpt},
        device=args.device,
    )
    hdr = export_predict(seg, tuple(args.size), args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes): {hdr}")


if __name__ == "__main__":
    _cli()
