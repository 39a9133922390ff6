"""Eval runner (rs_ov/evalsuite/runner.py): config -> SegmentorEx ->
dataset walk -> IoUMetric, with dataset sharding for data-parallel eval
(shards merge through their saved [4, C] states). Results land in
``work_dir/results.txt``, ``results.csv``, ``<tag>_per_class.json`` and
``metric_state.npz``.

The loop: decoded uint8 images ride to the card with their uint8 labels;
``batch_images`` > 1 groups consecutive images of one geometry into one
``predict_batch_raw`` call (a short tail is padded by repeating its last
image); the [4, C] confusion state stays on the device and is read once at
the end, so predictions never come back to the host, except for images
without ground truth or with labels above 255. ``RS_OV_EVAL_DEPTH`` batches
(default 2) stay in flight: on the card the loop waits once per batch, on a
CUDA event recorded after that batch, when it folds the batch ``depth``
places back into the state. ``RS_OV_EVAL_DECODE_WORKERS`` threads (default
max(4, 2 x batch)) decode ahead. The sustained rates count the batches
after the first two, from the third's submission to the final read of the
state.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from rs_ov_torch.data.datasets import get_dataset_meta
from rs_ov_torch.data.loader import SegDataset
from rs_ov_torch.evalsuite.config import load_config
from rs_ov_torch.evalsuite.metrics import IoUMetric, device_confusion_update
from rs_ov_torch.pipeline.segmentor import SegmentorEx

__all__ = ["build_segmentor_from_config", "run_eval", "append_experiment_result",
           "merge_eval_results"]

_MODEL_KEY_DROP = ("type", "device")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_segmentor_from_config(cfg: dict, overrides: Optional[dict] = None) -> SegmentorEx:
    """The config's ``model`` dict with ``overrides`` on top as a
    SegmentorEx. A dict-valued override merges one level into the config's
    dict (a --jbu-stages override keeps the config's model_path). The
    config's own ``device`` key is dropped: pass ``device`` as an override
    (without one the segmentor runs on the card)."""
    model_cfg = {k: v for k, v in cfg["model"].items() if k not in _MODEL_KEY_DROP}
    for k, v in (overrides or {}).items():
        if isinstance(v, dict) and isinstance(model_cfg.get(k), dict):
            model_cfg[k] = {**model_cfg[k], **v}
        else:
            model_cfg[k] = v
    name_path = model_cfg.get("name_path", "")
    if name_path and not os.path.exists(name_path):
        # the reference's configs name paths relative to the repo root
        candidate = os.path.join(_REPO_ROOT, name_path.lstrip("./"))
        if os.path.exists(candidate):
            model_cfg["name_path"] = candidate
    # a missing upsampler checkpoint falls back to random init in SegmentorEx
    return SegmentorEx(**model_cfg)


def _dataset(cfg: dict, shard, max_samples):
    ds_cfg = cfg["test_dataloader"]["dataset"]
    meta = get_dataset_meta(ds_cfg["type"])
    meta = dataclasses.replace(meta, **{k: ds_cfg[k] for k in (
        "img_suffix", "seg_map_suffix", "reduce_zero_label", "ignore_index") if k in ds_cfg})
    prefix = ds_cfg["data_prefix"]
    return SegDataset(ds_cfg["type"], prefix["img_path"], prefix.get("seg_map_path"),
                      meta=meta, shard=shard, max_samples=max_samples, raw=True), meta


def run_eval(config_path: str, work_dir: str = "./work_dirs/tmp",
             shard: tuple[int, int] = (0, 1), max_samples: Optional[int] = None,
             model_overrides: Optional[dict] = None,
             save_seg_dir: Optional[str] = None,
             save_heatmap_dir: Optional[str] = None,
             segmentor: Optional[SegmentorEx] = None,
             batch_images: int = 1,
             verbose: bool = True) -> dict:
    cfg = load_config(config_path)
    # the dataset first: a missing data_root fails before the model build
    dataset, meta = _dataset(cfg, shard, max_samples)

    if segmentor is None:
        overrides = dict(model_overrides or {})
        if save_seg_dir:
            overrides["result_dir"] = save_seg_dir
        if save_heatmap_dir:
            overrides["heatmap_dir"] = save_heatmap_dir
        if (len(meta.classes) < 250 and int(cfg["model"].get("bg_idx", 0)) < 250
                and "pred_dtype" not in overrides):
            overrides["pred_dtype"] = "uint8"  # every label it can emit fits
        segmentor = build_segmentor_from_config(cfg, overrides)

    metric = IoUMetric(num_classes=len(meta.classes), ignore_index=meta.ignore_index,
                       class_names=meta.classes)
    device = segmentor.device
    on_card = device.type == "cuda"
    dev_state = [torch.zeros((4, metric.num_classes), dtype=torch.float32, device=device)]

    n = len(dataset)
    t0 = time.perf_counter()
    pixels = images_done = 0
    warm = [0.0, 0]  # (time, pixels) after the first consumed batch
    # (time, images, pixels) as each batch is submitted, for the sustained rates
    submitted: list[tuple[float, int, int]] = []

    def consume(batch, event):
        """Fold one predicted batch [(result, labels), ...] into the state:
        predictions with uint8-sized labels on the device, the rest on the
        host."""
        nonlocal pixels, images_done
        if event is not None:
            event.synchronize()
        on_device = [s is not None and int(s.max(initial=0)) <= 255 for _, s in batch]
        with_gt = [rs for rs, dev in zip(batch, on_device) if dev]
        host = [rs for rs, dev in zip(batch, on_device) if not dev]
        if with_gt:
            preds = torch.cat([r["pred_sem_seg"] for r, _ in with_gt])
            labels = torch.from_numpy(np.stack([s for _, s in with_gt]).astype(np.uint8))
            dev_state[0] = device_confusion_update(
                dev_state[0], preds, labels.to(device),
                metric.num_classes, metric.ignore_index)
            pixels += preds.numel()
        for r, s in host:
            pred = r["pred_sem_seg"][0].cpu().numpy().astype(np.int64)
            pixels += pred.size
            if s is not None:
                metric.process(pred, s)
        images_done += len(batch)
        if not warm[1]:
            warm[0], warm[1] = time.perf_counter(), pixels

    depth = max(1, int(os.environ.get("RS_OV_EVAL_DEPTH", "2")))
    target = max(batch_images, 1)
    pending, buf = [], []
    done = [0, 0, 0]  # (images submitted, their pixels, images at the last progress line)

    def flush():
        if not buf:
            return
        submitted.append((time.perf_counter(), done[0], done[1]))
        if target == 1:
            results = segmentor.predict_raw(buf[0].img[None], [buf[0].meta])
        else:
            run = buf + [buf[-1]] * (target - len(buf))  # pad a short tail
            results = segmentor.predict_batch_raw(np.stack([s.img for s in run]),
                                                  [s.meta for s in run])[:len(buf)]
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        pending.append(([(r, s.seg) for r, s in zip(results, buf)], event))
        while len(pending) > depth:
            consume(*pending.pop(0))
        done[0] += len(buf)
        done[1] += sum(s.img.shape[0] * s.img.shape[1] for s in buf)
        buf.clear()
        if verbose and done[0] - done[2] >= 50:
            done[2] = done[0]
            print(f"[eval] {done[0]}/{n} images", flush=True)

    workers = int(os.environ.get("RS_OV_EVAL_DECODE_WORKERS", "0")) or max(4, 2 * target)
    buf_key = None
    for sample in dataset.prefetch(lookahead=workers):
        key = (sample.img.shape, tuple(sample.meta.get("ori_shape", sample.img.shape[:2]))[:2])
        if buf and (key != buf_key or len(buf) >= target):
            flush()
        buf_key = key
        buf.append(sample)
    flush()
    while pending:
        consume(*pending.pop(0))
    # the one device-to-host copy of the eval: the [4, C] state
    metric.merge(dev_state[0].cpu().numpy().astype(np.float64))
    elapsed = time.perf_counter() - t0

    results = metric.compute()
    results["num_images"] = n
    results["elapsed_sec"] = elapsed
    results["tiles512_per_sec"] = (pixels / (512.0 * 512.0)) / elapsed if elapsed else 0.0
    # without the first batch; with batches in flight when it is stamped
    # this overstates: the sustained rates below are the loop's number
    steady_t = t0 + elapsed - warm[0]
    if n > 1 and steady_t > 0:
        results["tiles512_per_sec_steady"] = ((pixels - warm[1]) / (512.0 * 512.0)) / steady_t
    # the first two batches left out, as the JAX runner does, but anchored
    # where the third is submitted: on the card a submission runs about as
    # long as its batch, so the JAX runner's anchor (the second batch's
    # consumption, after `depth` more submissions) would leave their time
    # out of the window; ended at the final read of the state
    if len(submitted) > 2:
        t_ref, img_ref, px_ref = submitted[2]
        dt = (t0 + elapsed) - t_ref
        if dt > 0 and images_done > img_ref:
            results["img_per_sec_sustained"] = (images_done - img_ref) / dt
            results["tiles512_per_sec_sustained"] = ((pixels - px_ref) / (512.0 * 512.0)) / dt

    os.makedirs(work_dir, exist_ok=True)
    tag = os.path.splitext(os.path.basename(config_path))[0]
    model = [segmentor.clip_type, segmentor.vit_type, segmentor.model_type]
    # every shard keeps its state, so that merge_eval_results can rebuild
    # the dataset-level result
    np.savez(os.path.join(work_dir, "metric_state.npz"), state=metric.state, num_images=n,
             pixels=pixels, elapsed_sec=elapsed, ignore_index=meta.ignore_index,
             class_names=np.asarray(meta.classes), tag=tag, model=np.asarray(model))
    if shard[0] == 0:
        _write_results(work_dir, tag, model, results, tag)
    return results


def _write_results(out_dir: str, tag: str, model: list, results: dict, label: str) -> None:
    append_experiment_result(os.path.join(out_dir, "results.csv"), [[
        *model, tag, f"{results['aAcc']:.2f}", f"{results['mIoU']:.2f}",
        f"{results['mAcc']:.2f}"]])
    with open(os.path.join(out_dir, "results.txt"), "a") as f:
        f.write(f"{label}: " + json.dumps({k: results[k] for k in (
            "aAcc", "mIoU", "mAcc", "num_images", "tiles512_per_sec")}) + "\n")
    with open(os.path.join(out_dir, f"{tag}_per_class.json"), "w") as f:
        json.dump(results.get("per_class", {}), f, indent=2)


def merge_eval_results(dist_dir: str, verbose: bool = True) -> dict:
    """Sum the states of every ``<dist_dir>/rank*/metric_state.npz`` (or
    ``<dist_dir>/*/metric_state.npz``) into the dataset-level result, and
    write results.txt / results.csv / the per-class table into dist_dir."""
    paths = (sorted(glob.glob(os.path.join(dist_dir, "rank*", "metric_state.npz")))
             or sorted(glob.glob(os.path.join(dist_dir, "*", "metric_state.npz"))))
    if not paths:
        raise FileNotFoundError(
            f"no rank*/metric_state.npz under {dist_dir}: run sharded eval "
            "(--shard R/W) into per-rank work dirs first")
    first = np.load(paths[0], allow_pickle=False)
    metric = IoUMetric(num_classes=first["state"].shape[1],
                       ignore_index=int(first["ignore_index"]),
                       class_names=tuple(str(c) for c in first["class_names"]))
    n_images, pixels, elapsed = 0, 0.0, 0.0
    for p in paths:
        z = np.load(p, allow_pickle=False)
        metric.merge(z["state"])
        n_images += int(z["num_images"])
        pixels += float(z["pixels"])
        elapsed = max(elapsed, float(z["elapsed_sec"]))  # shards run side by side

    results = metric.compute()
    results["num_images"] = n_images
    results["num_shards"] = len(paths)
    results["elapsed_sec"] = elapsed
    results["tiles512_per_sec"] = (pixels / (512.0 * 512.0)) / elapsed if elapsed else 0.0
    tag = str(first["tag"])
    _write_results(dist_dir, tag, [str(x) for x in first["model"]], results,
                   f"{tag} (merged {len(paths)} shards)")
    if verbose:
        print(f"[merge] {len(paths)} shards, {n_images} images -> mIoU {results['mIoU']:.2f} "
              f"aAcc {results['aAcc']:.2f} mAcc {results['mAcc']:.2f}")
    return results


def append_experiment_result(path: str, rows: list[list]) -> None:
    """Append rows to the results CSV, with its header when new (the
    reference's openpyxl logger, reference utils.py:3-31)."""
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["CLIP", "VIT", "MODEL", "Dataset", "aAcc", "mIoU", "mAcc"])
        w.writerows(rows)
