"""The caption-generation evaluation loop and its rank-shard result files
(rs_ov/evalsuite/caption.py; the reference's BLIP/eval_nocaps.py:30-51 and
data/utils.py save_result).

``evaluate_captions`` generates in batches of ``batch`` frames, the tail
batch padded with its last frame and the padding's captions dropped, one
``{"image_id", "caption"}`` record per image; ``save_result`` writes a
rank's shard and ``merge_results`` joins the shards, duplicates dropped by
key.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Sequence

import numpy as np

__all__ = ["evaluate_captions", "save_result", "merge_results"]


def evaluate_captions(params, cfg, images: np.ndarray, image_ids: Sequence[int], tokenizer,
                      batch: int = 8, num_beams: int = 3, max_length: int = 20,
                      min_length: int = 5, repetition_penalty: float = 1.1,
                      prompt: str = "a picture of ",
                      log: Callable[[str], None] | None = None) -> List[dict]:
    """[N, 3, S, S] frames and their ids -> the reference's result records
    (beam search, ``num_beams``, ``max_length`` / ``min_length``,
    ``repetition_penalty`` 1.1), through ``nn.blip_lm.generate_captions``
    on the weights' device."""
    from rs_ov_torch.nn.blip_lm import generate_captions

    images = np.asarray(images, np.float32)
    n = len(images)
    if n != len(image_ids):
        raise ValueError(f"{n} images vs {len(image_ids)} image_ids")
    results: List[dict] = []
    for i in range(0, n, batch):
        chunk = images[i:i + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        caps = generate_captions(params, chunk, cfg, tokenizer, num_beams=num_beams,
                                 max_length=max_length, min_length=min_length,
                                 repetition_penalty=repetition_penalty, prompt=prompt)
        for cap, img_id in zip(caps[:len(chunk) - pad], image_ids[i:i + batch]):
            results.append({"image_id": int(img_id), "caption": cap})
        if log:
            log(f"captioned {min(i + batch, n)}/{n}")
    return results


def save_result(result: List[dict], result_dir: str, filename: str, rank: int = 0) -> str:
    """Write this shard's ``{filename}_rank{rank}.json``."""
    os.makedirs(result_dir, exist_ok=True)
    path = os.path.join(result_dir, f"{filename}_rank{rank}.json")
    with open(path, "w") as f:
        json.dump(result, f)
    return path


def merge_results(result_dir: str, filename: str, world: int,
                  remove_duplicate: str = "image_id") -> str:
    """Join the ``world`` shards in rank order, keep the first record of
    each ``remove_duplicate`` key, write ``{filename}.json``."""
    merged: List[dict] = []
    for rank in range(world):
        with open(os.path.join(result_dir, f"{filename}_rank{rank}.json")) as f:
            merged.extend(json.load(f))
    if remove_duplicate:
        seen, uniq = set(), []
        for rec in merged:
            if rec[remove_duplicate] not in seen:
                seen.add(rec[remove_duplicate])
                uniq.append(rec)
        merged = uniq
    path = os.path.join(result_dir, f"{filename}.json")
    with open(path, "w") as f:
        json.dump(merged, f)
    return path
