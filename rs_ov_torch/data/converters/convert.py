#!/usr/bin/env python
"""Dataset converter CLI: raw downloads -> mmseg-layout tiles
(the port's own copy of rs_ov/data/converters/convert.py; numpy and PIL only,
its output byte for byte the JAX package's).

    python -m rs_ov_torch.data.converters.convert potsdam  <raw_dir> -o out/
    python -m rs_ov_torch.data.converters.convert uavid    <raw_dir> -o out/
    python -m rs_ov_torch.data.converters.convert isaid    <raw_dir> -o out/
    python -m rs_ov_torch.data.converters.convert binary   <img_dir> <ann_dir> -o out/
    ...

Per-dataset logic mirrors the reference scripts (reference
tools/dataset_converters/*.py); the shared tiling/palette machinery lives in
rs_ov_torch.data.converters.core. The `binary` subcommand covers the
building/road/water datasets whose masks are already 0/255 PNGs (whu.py,
inria.py, xBD.py, chn6-cug.py, deepglobe_road.py, roadval.py, wbs-si.py —
0/255 -> 0/1 index masks, optional tiling).
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np

from rs_ov_torch.data.converters.core import (clip_boxes, convert_from_color,
                                              rgb_to_index_matmul, save_png, tile_image)

# ISPRS Potsdam/Vaihingen BGR color map (reference potsdam.py:76-80; note the
# reference reads BGR via mmcv.imread — we read RGB, so the map is flipped)
_ISPRS_COLOR_RGB = np.array([
    [0, 0, 0], [255, 255, 255], [0, 0, 255], [0, 255, 255],
    [0, 255, 0], [255, 255, 0], [255, 0, 0]])

_UAVID_PALETTE = {0: (0, 0, 0), 1: (128, 0, 0), 2: (128, 64, 128),
                  3: (192, 0, 192), 4: (0, 128, 0), 5: (128, 128, 0),
                  6: (64, 64, 0), 7: (64, 0, 128)}  # 7 = Moving_Car

_ISAID_PALETTE = {0: (0, 0, 0), 1: (0, 0, 63), 2: (0, 63, 63), 3: (0, 63, 0),
                  4: (0, 63, 127), 5: (0, 63, 191), 6: (0, 63, 255),
                  7: (0, 127, 63), 8: (0, 127, 127), 9: (0, 0, 127),
                  10: (0, 0, 191), 11: (0, 0, 255), 12: (0, 191, 127),
                  13: (0, 127, 191), 14: (0, 127, 255), 15: (0, 100, 155)}


def _load_rgb(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def _iter_images(d, exts=("png", "tif", "tiff", "jpg", "jpeg", "JPG")):
    for ext in exts:
        yield from sorted(glob.glob(osp.join(d, f"*.{ext}")))


def convert_isprs(raw_dir, out_dir, clip_size=512, stride_size=256,
                  label_subdir="labels", image_subdir="images"):
    """Potsdam/Vaihingen-style: tile images + RGB label maps -> index masks
    (reference potsdam.py:35-110 / vaihingen.py)."""
    for split in ("train", "validation"):
        img_out = osp.join(out_dir, "images", split)
        ann_out = osp.join(out_dir, "annotations", split)
        src_img = osp.join(raw_dir, image_subdir, split)
        src_ann = osp.join(raw_dir, label_subdir, split)
        if not osp.isdir(src_img):
            continue
        for path in _iter_images(src_img):
            stem = osp.splitext(osp.basename(path))[0]
            tile_image(_load_rgb(path), img_out, stem, clip_size, stride_size)
        for path in _iter_images(src_ann):
            stem = osp.splitext(osp.basename(path))[0]
            label = rgb_to_index_matmul(_load_rgb(path), _ISPRS_COLOR_RGB)
            tile_image(label, ann_out, stem, clip_size, stride_size, pad_val=255)


def convert_uavid(raw_dir, out_dir, clip_size=1024, stride_size=512):
    """UAVid: color labels -> indices w/ Moving_Car -> Static_Car
    (reference uavid.py:26-32, :85-130)."""
    for seq in sorted(glob.glob(osp.join(raw_dir, "seq*"))):
        for path in _iter_images(osp.join(seq, "Images")):
            stem = f"{osp.basename(seq)}_{osp.splitext(osp.basename(path))[0]}"
            tile_image(_load_rgb(path), osp.join(out_dir, "images"),
                       stem, clip_size, stride_size)
        for path in _iter_images(osp.join(seq, "Labels")):
            stem = f"{osp.basename(seq)}_{osp.splitext(osp.basename(path))[0]}"
            label = convert_from_color(_load_rgb(path), _UAVID_PALETTE,
                                       remap={7: 3})
            tile_image(label, osp.join(out_dir, "annotations"),
                       stem, clip_size, stride_size, pad_val=255)


def convert_isaid(raw_dir, out_dir, patch=896, stride=512):
    """iSAID: instance-color labels -> semantic indices, 255-padded tiles
    (reference isaid.py:38-48, :100-150)."""
    for split in ("train", "val"):
        src = osp.join(raw_dir, split)
        if not osp.isdir(src):
            continue
        for path in _iter_images(osp.join(src, "images")):
            stem = osp.splitext(osp.basename(path))[0]
            if stem.endswith("_instance_color_RGB"):
                label = convert_from_color(_load_rgb(path), _ISAID_PALETTE)
                tile_image(label, osp.join(out_dir, "annotations", split),
                           stem, patch, stride, pad_val=255)
            else:
                tile_image(_load_rgb(path), osp.join(out_dir, "images", split),
                           stem, patch, stride, pad_val=0)


def convert_loveda(raw_dir, out_dir):
    """LoveDA: reorganise the unzipped Train/Val/Test trees (Rural + Urban)
    into the mmseg images/annotations layout (reference loveda.py:22-74 —
    pure file moves, no pixel transforms; masks are already index maps)."""
    import shutil

    split_map = {"Train": "train", "Val": "validation", "Test": "test"}
    for raw_split, split in split_map.items():
        for domain in ("Rural", "Urban"):
            src = osp.join(raw_dir, raw_split, domain)
            if not osp.isdir(src):
                continue
            img_out = osp.join(out_dir, "images", split)
            ann_out = osp.join(out_dir, "annotations", split)
            os.makedirs(img_out, exist_ok=True)
            os.makedirs(ann_out, exist_ok=True)
            for path in _iter_images(osp.join(src, "images_png")):
                shutil.copy(path, osp.join(img_out, osp.basename(path)))
            mask_dir = osp.join(src, "masks_png")
            if osp.isdir(mask_dir):
                for path in _iter_images(mask_dir):
                    shutil.copy(path, osp.join(ann_out, osp.basename(path)))


def convert_openearthmap(raw_dir, out_dir, val_list=None):
    """OpenEarthMap: regions/<name>/{images,labels}/*.tif -> flat
    img_dir/ann_dir per split, split by the official val file list
    (reference openearthmap.py pattern)."""
    import glob as _glob
    import shutil

    val_names = set()
    if val_list and osp.exists(val_list):
        val_names = {line.strip() for line in open(val_list) if line.strip()}
    for img_path in sorted(_glob.glob(osp.join(raw_dir, "*", "images", "*.tif"))):
        name = osp.basename(img_path)
        split = "val" if name in val_names else "train"
        os.makedirs(osp.join(out_dir, "img_dir", split), exist_ok=True)
        os.makedirs(osp.join(out_dir, "ann_dir", split), exist_ok=True)
        shutil.copy(img_path, osp.join(out_dir, "img_dir", split, name))
        label = img_path.replace(osp.sep + "images" + osp.sep,
                                 osp.sep + "labels" + osp.sep)
        if osp.exists(label):
            shutil.copy(label, osp.join(out_dir, "ann_dir", split, name))


def _binary_labels(label_dir, out_dir, strip=None, threshold=128):
    """Grayscale 0/255 masks -> 0/1 index masks, optional filename-suffix
    strip (reference whu.py:45-52 / chn6-cug.py:33-37 pattern)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for path in _iter_images(label_dir):
        mask = np.asarray(Image.open(path).convert("L"))
        mask = (mask >= threshold).astype(np.uint8)
        name = osp.basename(path)
        if strip:
            name = name.replace(strip, "")
        save_png(mask, osp.join(out_dir, name))


def convert_whu(raw_dir, out_dir):
    """WHU building: <split>/OUT/ grayscale masks -> <split>/label_cvt/
    (reference whu.py:29-52; labels only, images used in place)."""
    for split in ("train", "val", "test"):
        src = osp.join(raw_dir, split, "OUT")
        if osp.isdir(src):
            _binary_labels(src, osp.join(out_dir, split, "label_cvt"))


def convert_gt_images(raw_dir, out_dir, image_subdir, strip_mask="_mask",
                      strip_sat="_sat"):
    """CHN6-CUG / DeepGlobe-road: gt/*_mask -> label_cvt/ (0/1), copy
    images/<name>_sat -> image_cvt/ (reference chn6-cug.py:27-43,
    deepglobe_road.py:27-43 — identical up to the image dir name)."""
    import shutil

    _binary_labels(osp.join(raw_dir, "gt"), osp.join(out_dir, "label_cvt"),
                   strip=strip_mask)
    img_out = osp.join(out_dir, "image_cvt")
    os.makedirs(img_out, exist_ok=True)
    for path in _iter_images(osp.join(raw_dir, image_subdir)):
        shutil.copy(path, osp.join(img_out,
                                   osp.basename(path).replace(strip_sat, "")))


def convert_roadval(raw_dir, out_dir):
    """RoadVal: gt/ -> label_cvt/ (reference roadval.py:27-36)."""
    _binary_labels(osp.join(raw_dir, "gt"), osp.join(out_dir, "label_cvt"))


def convert_wbs_si(raw_dir, out_dir):
    """WBS-SI water: Masks/ -> Masks_cvt/ (reference wbs-si.py:27-36)."""
    _binary_labels(osp.join(raw_dir, "Masks"), osp.join(out_dir, "Masks_cvt"))


def convert_xbd(raw_dir, out_dir):
    """xBD building: targets/ -> targets_cvt/, any damage level >= 1 -> 1,
    '_target' suffix stripped (reference xBD.py:36-41); keep only 'pre'
    images downstream per xBD.py:4's note."""
    _binary_labels(osp.join(raw_dir, "targets"), osp.join(out_dir, "targets_cvt"),
                   strip="_target", threshold=1)


_INRIA_VAL = [
    "chicago24", "austin27", "kitsap22", "chicago28", "tyrol-w6", "austin8",
    "kitsap5", "vienna28", "kitsap30", "austin15", "kitsap13", "austin19",
    "chicago6", "austin9", "chicago12", "vienna7", "kitsap18", "tyrol-w24",
    "vienna36", "austin29", "tyrol-w19", "vienna29", "chicago1", "tyrol-w12",
    "tyrol-w22", "austin17", "tyrol-w10"]
_INRIA_TEST = [
    "vienna3", "chicago10", "vienna20", "austin1", "tyrol-w25", "vienna9",
    "chicago14", "vienna18", "kitsap36", "kitsap35", "austin22", "kitsap34",
    "austin7", "vienna11", "kitsap14", "kitsap25", "austin12", "vienna15",
    "kitsap9", "austin36", "vienna6", "chicago23", "tyrol-w3", "chicago26",
    "austin24", "tyrol-w1", "tyrol-w36"]


def convert_inria(raw_dir, out_dir, clip_size=1000, stride_size=1000):
    """Inria building: images/ + gt/ 5000^2 .tifs -> 1000^2 tiles under
    img_dir/ann_dir per the fixed val/test filename splits; train tiles are
    skipped like the reference (reference inria.py:89-136; tile grid and
    `_24label` strip :31-85)."""
    from PIL import Image

    for path in _iter_images(osp.join(raw_dir, "images"), exts=("tif", "tiff")):
        name = osp.basename(path)
        stem = osp.splitext(name)[0]
        if stem in _INRIA_VAL:
            split = "split_val"
        elif stem in _INRIA_TEST:
            split = "split_test"
        else:
            continue  # reference skips train (inria.py:121-122)
        stem_out = stem.replace("_24label", "")
        tile_image(_load_rgb(path), osp.join(out_dir, "img_dir", split),
                   stem_out, clip_size, stride_size)
        ann = osp.join(raw_dir, "gt", name)
        if osp.exists(ann):
            mask = np.asarray(Image.open(ann).convert("L"))
            mask = (mask >= 128).astype(np.uint8)
            tile_image(mask, osp.join(out_dir, "ann_dir", split),
                       stem_out, clip_size, stride_size)


def convert_binary(img_dir, ann_dir, out_dir, threshold=128,
                   clip_size=0, stride_size=0):
    """Building/road/water datasets: 0/255 masks -> 0/1 index masks
    (reference whu.py / inria.py / xBD.py / chn6-cug.py / *_road.py pattern),
    optional tiling when clip_size > 0."""
    from PIL import Image

    img_out = osp.join(out_dir, "images")
    ann_out = osp.join(out_dir, "annotations")
    os.makedirs(img_out, exist_ok=True)
    os.makedirs(ann_out, exist_ok=True)
    for path in _iter_images(img_dir):
        stem = osp.splitext(osp.basename(path))[0]
        img = _load_rgb(path)
        if clip_size:
            tile_image(img, img_out, stem, clip_size, stride_size or clip_size)
        else:
            save_png(img, osp.join(img_out, f"{stem}.png"))
    for path in _iter_images(ann_dir):
        stem = osp.splitext(osp.basename(path))[0]
        mask = np.asarray(Image.open(path))
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = (mask >= threshold).astype(np.uint8)
        if clip_size:
            tile_image(mask, ann_out, stem, clip_size, stride_size or clip_size,
                       pad_val=255)
        else:
            save_png(mask, osp.join(ann_out, f"{stem}.png"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="dataset", required=True)

    p = sub.add_parser("potsdam")
    p.add_argument("raw_dir")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--clip_size", type=int, default=512)
    p.add_argument("--stride_size", type=int, default=256)

    p = sub.add_parser("vaihingen")
    p.add_argument("raw_dir")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--clip_size", type=int, default=512)
    p.add_argument("--stride_size", type=int, default=256)

    p = sub.add_parser("uavid")
    p.add_argument("raw_dir")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--clip_size", type=int, default=1024)
    p.add_argument("--stride_size", type=int, default=512)

    p = sub.add_parser("isaid")
    p.add_argument("raw_dir")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--patch", type=int, default=896)
    p.add_argument("--stride", type=int, default=512)

    p = sub.add_parser("loveda")
    p.add_argument("raw_dir")
    p.add_argument("-o", "--out_dir", required=True)

    p = sub.add_parser("openearthmap")
    p.add_argument("raw_dir")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--val_list", default=None)

    for name in ("whu", "roadval", "wbs-si", "xbd"):
        p = sub.add_parser(name)
        p.add_argument("raw_dir")
        p.add_argument("-o", "--out_dir", required=True)

    for name in ("chn6-cug", "deepglobe_road"):
        p = sub.add_parser(name)
        p.add_argument("raw_dir")
        p.add_argument("-o", "--out_dir", required=True)

    p = sub.add_parser("inria")
    p.add_argument("raw_dir")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--clip_size", type=int, default=1000)
    p.add_argument("--stride_size", type=int, default=1000)

    p = sub.add_parser("binary")
    p.add_argument("img_dir")
    p.add_argument("ann_dir")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--threshold", type=int, default=128)
    p.add_argument("--clip_size", type=int, default=0)
    p.add_argument("--stride_size", type=int, default=0)

    args = parser.parse_args(argv)
    if args.dataset in ("potsdam", "vaihingen"):
        convert_isprs(args.raw_dir, args.out_dir, args.clip_size, args.stride_size)
    elif args.dataset == "uavid":
        convert_uavid(args.raw_dir, args.out_dir, args.clip_size, args.stride_size)
    elif args.dataset == "isaid":
        convert_isaid(args.raw_dir, args.out_dir, args.patch, args.stride)
    elif args.dataset == "loveda":
        convert_loveda(args.raw_dir, args.out_dir)
    elif args.dataset == "openearthmap":
        convert_openearthmap(args.raw_dir, args.out_dir, args.val_list)
    elif args.dataset == "whu":
        convert_whu(args.raw_dir, args.out_dir)
    elif args.dataset == "roadval":
        convert_roadval(args.raw_dir, args.out_dir)
    elif args.dataset == "wbs-si":
        convert_wbs_si(args.raw_dir, args.out_dir)
    elif args.dataset == "xbd":
        convert_xbd(args.raw_dir, args.out_dir)
    elif args.dataset == "chn6-cug":
        convert_gt_images(args.raw_dir, args.out_dir, image_subdir="images")
    elif args.dataset == "deepglobe_road":
        convert_gt_images(args.raw_dir, args.out_dir, image_subdir="img")
    elif args.dataset == "inria":
        convert_inria(args.raw_dir, args.out_dir, args.clip_size,
                      args.stride_size)
    elif args.dataset == "binary":
        convert_binary(args.img_dir, args.ann_dir, args.out_dir, args.threshold,
                       args.clip_size, args.stride_size)


if __name__ == "__main__":
    main()
