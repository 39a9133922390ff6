"""BLIP image / video-text retrieval evaluation: the ITC shortlist, the ITM
rerank, recall@K (rs_ov/evalsuite/retrieval.py; the reference's
BLIP/train_retrieval.py:69-211 and eval_retrieval_video.py:29-176).

Each rerank direction walks its rows in chunks of ``rows_per_chunk``: a
chunk gathers its rows' top-k candidates into one [rows * k, L] batch and
runs the cross-attention text encoder and the ITM head on it, the tail chunk
padded with its last row. The per-image token features stay in host memory;
each chunk's gather goes to the weights' device. ``shard=(rank, world)``
takes every world-th row of each direction; the shards' sparse (score,
index) pairs join by concatenation and ``densify`` lays them out as the
reference's -100-filled matrices.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from rs_ov_torch.nn.bert import bert_encode
from rs_ov_torch.nn.blip import Blip, BlipConfig
from rs_ov_torch.nn.blip_vit import blip_vit_forward
from rs_ov_torch.nn.layers import linear

__all__ = ["encode_retrieval_texts", "encode_retrieval_images", "encode_retrieval_videos",
           "retrieval_rerank", "densify", "itm_eval", "blip_retrieval_evaluation"]


def _l2norm32(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    pad = (-len(a)) % mult
    return a if pad == 0 else np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)


def _on(params: Blip, x) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x))
    dev = params.visual.cls_token
    return x.to(dev.device, dev.dtype if x.is_floating_point() else torch.long)


@torch.no_grad()
def encode_retrieval_texts(params: Blip, cfg: BlipConfig, input_ids: np.ndarray,
                           attention_mask: np.ndarray, enc_token_id: int,
                           batch: int = 256) -> Dict[str, np.ndarray]:
    """Tokenised captions -> the normalised ITC embeddings and the
    [ENC]-first ids the ITM rerank reads."""
    input_ids = np.asarray(input_ids, np.int32)
    attention_mask = np.asarray(attention_mask, np.int32)
    n = len(input_ids)
    ids_p, att_p = _pad_rows(input_ids, batch), _pad_rows(attention_mask, batch)
    embeds = []
    for i in range(0, len(ids_p), batch):
        hidden = bert_encode(params.text, _on(params, ids_p[i:i + batch]),
                             _on(params, att_p[i:i + batch]), cfg.text)
        embeds.append(_l2norm32(linear(hidden[:, 0], params.text_proj.w,
                                       params.text_proj.b)).cpu().numpy())
    enc_ids = input_ids.copy()
    enc_ids[:, 0] = enc_token_id
    return {"text_embeds": np.concatenate(embeds)[:n], "enc_ids": enc_ids,
            "text_atts": attention_mask}


def _image_chunk(params: Blip, images: np.ndarray, cfg: BlipConfig):
    feats = blip_vit_forward(params.visual, _on(params, images), cfg.vision)
    return feats, linear(feats[:, 0], params.vision_proj.w, params.vision_proj.b).float()


@torch.no_grad()
def encode_retrieval_images(params: Blip, cfg: BlipConfig, images: np.ndarray,
                            batch: int = 16) -> Dict[str, np.ndarray]:
    """[N, 3, S, S] -> the full token features (host memory, the ITM
    context) and the normalised CLS embeddings."""
    images = np.asarray(images, np.float32)
    n = len(images)
    imgs_p = _pad_rows(images, batch)
    feats, embeds = [], []
    for i in range(0, len(imgs_p), batch):
        f, e = _image_chunk(params, imgs_p[i:i + batch], cfg)
        feats.append(f.float().cpu().numpy())
        embeds.append(_l2norm32(e).cpu().numpy())
    return {"image_feats": np.concatenate(feats)[:n],
            "image_embeds": np.concatenate(embeds)[:n]}


@torch.no_grad()
def encode_retrieval_videos(params: Blip, cfg: BlipConfig, videos: np.ndarray,
                            batch: int = 16) -> Dict[str, np.ndarray]:
    """[N, F, 3, S, S] -> the frame mean of the raw CLS projections,
    normalised after the mean (as the reference), and every frame's tokens
    end to end as the cross-attention context."""
    videos = np.asarray(videos, np.float32)
    n, f = videos.shape[:2]
    flat_p = _pad_rows(videos.reshape((-1,) + videos.shape[2:]), batch)
    feats, projs = [], []
    for i in range(0, len(flat_p), batch):
        fe, pr = _image_chunk(params, flat_p[i:i + batch], cfg)
        feats.append(fe.float().cpu().numpy())
        projs.append(pr.cpu().numpy())
    feats = np.concatenate(feats)[:n * f]
    embeds = np.concatenate(projs)[:n * f].reshape(n, f, -1).mean(axis=1)
    embeds = embeds / np.maximum(np.linalg.norm(embeds, axis=-1, keepdims=True), 1e-12)
    tok = feats.shape[1]
    return {"image_feats": feats.reshape(n, f * tok, feats.shape[-1]),
            "image_embeds": embeds.astype(np.float32)}


def _itm_match(params: Blip, cfg: BlipConfig, ids, atts, enc, r: int, k: int) -> np.ndarray:
    hidden = bert_encode(params.text, ids, atts, cfg.text, encoder_hidden_states=enc)
    logits = linear(hidden[:, 0], params.itm_head.w, params.itm_head.b)
    return logits[:, 1].reshape(r, k).float().cpu().numpy()


@torch.no_grad()
def retrieval_rerank(params: Blip, cfg: BlipConfig, image_feats: np.ndarray,
                     image_embeds: np.ndarray, text_embeds: np.ndarray, enc_ids: np.ndarray,
                     text_atts: np.ndarray, k_test: int, rows_per_chunk: int = 4,
                     shard: tuple[int, int] = (0, 1),
                     log: Callable[[str], None] | None = None) -> Dict[str, np.ndarray]:
    """Both rerank directions: sparse ``scores_*`` / ``idx_*`` [rows,
    k_test] (fp32 ITM 'match' logit plus the ITC similarity) with the
    ``rows_*`` they cover, and the raw ITC ``sims`` matrix."""
    k = int(k_test)
    sims = image_embeds.astype(np.float32) @ text_embeds.astype(np.float32).T
    n_img, n_txt = sims.shape
    if k > n_txt or k > n_img:
        raise ValueError(f"k_test={k} exceeds matrix dims {sims.shape}")
    enc_ids_d, text_atts_d = _on(params, enc_ids), _on(params, text_atts)
    rank, world = shard
    out: Dict[str, np.ndarray] = {"sims": sims}

    for direction in ("i2t", "t2i"):
        mat = sims if direction == "i2t" else sims.T
        rows = np.arange(mat.shape[0])[rank::world]
        topk_idx = np.argsort(-mat[rows], axis=1)[:, :k].astype(np.int32)
        scores = np.empty((len(rows), k), np.float32)
        rows_p = _pad_rows(rows, rows_per_chunk)
        idx_p = _pad_rows(topk_idx, rows_per_chunk)
        for c in range(0, len(rows_p), rows_per_chunk):
            sl = slice(c, c + rows_per_chunk)
            if direction == "i2t":
                flat = torch.as_tensor(idx_p[sl].reshape(-1), device=enc_ids_d.device).long()
                enc = _on(params, image_feats[rows_p[sl]]).repeat_interleave(k, 0)
                got = _itm_match(params, cfg, enc_ids_d[flat], text_atts_d[flat], enc,
                                 rows_per_chunk, k)
            else:
                gathered = _on(params, image_feats[idx_p[sl].reshape(-1)])  # host gather
                got = _itm_match(params, cfg,
                                 _on(params, enc_ids[rows_p[sl]]).repeat_interleave(k, 0),
                                 _on(params, text_atts[rows_p[sl]]).repeat_interleave(k, 0),
                                 gathered, rows_per_chunk, k)
            keep = min(rows_per_chunk, len(rows) - c)
            if keep > 0:
                scores[c:c + keep] = got[:keep]
            if log:
                log(f"{direction} rerank {min(c + rows_per_chunk, len(rows))}/{len(rows)}")
        out[f"scores_{direction}"] = scores + np.take_along_axis(mat[rows], topk_idx, 1)
        out[f"idx_{direction}"] = topk_idx
        out[f"rows_{direction}"] = rows
    return out


def densify(scores: np.ndarray, idx: np.ndarray, rows: np.ndarray, shape: tuple[int, int],
            fill: float = -100.0) -> np.ndarray:
    """Sparse per-row (score, column) pairs -> the -100-filled dense matrix."""
    dense = np.full(shape, fill, np.float32)
    dense[rows[:, None], idx] = scores
    return dense


def itm_eval(scores_i2t: np.ndarray, scores_t2i: np.ndarray,
             txt2img: Sequence[int] | Dict[int, int],
             img2txt: Sequence[Sequence[int]] | Dict[int, List[int]],
             median_rank: bool = False) -> Dict[str, float]:
    """Recall@1/5/10 each way and their means (and the t2v median rank with
    ``median_rank``). img2txt[i]: image i's ground-truth captions (its rank
    the best of them); txt2img[t]: caption t's image."""
    ranks = np.zeros(scores_i2t.shape[0])
    for index, score in enumerate(scores_i2t):
        inds = np.argsort(score)[::-1]
        gold = img2txt[index]
        if np.isscalar(gold):
            gold = [int(gold)]
        ranks[index] = min((np.where(inds == i)[0][0] for i in gold), default=1e20)
    tr1, tr5, tr10 = (100.0 * len(np.where(ranks < r)[0]) / len(ranks) for r in (1, 5, 10))

    ranks = np.zeros(scores_t2i.shape[0])
    for index, score in enumerate(scores_t2i):
        inds = np.argsort(score)[::-1]
        ranks[index] = np.where(inds == txt2img[index])[0][0]
    ir1, ir5, ir10 = (100.0 * len(np.where(ranks < r)[0]) / len(ranks) for r in (1, 5, 10))

    tr_mean, ir_mean = (tr1 + tr5 + tr10) / 3, (ir1 + ir5 + ir10) / 3
    result = {"txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
              "img_r1": ir1, "img_r5": ir5, "img_r10": ir10, "img_r_mean": ir_mean,
              "r_mean": (tr_mean + ir_mean) / 2}
    if median_rank:
        result["img_mdR"] = float(np.median(ranks + 1))
    return result


def blip_retrieval_evaluation(params: Blip, cfg: BlipConfig, images: np.ndarray,
                              input_ids: np.ndarray, attention_mask: np.ndarray,
                              enc_token_id: int, txt2img, img2txt, k_test: int = 8,
                              video: bool = False, rows_per_chunk: int = 4,
                              shard: tuple[int, int] = (0, 1),
                              log: Callable[[str], None] | None = None) -> Dict[str, float]:
    """Encode, rerank, the metrics; ``video`` takes [N, F, 3, S, S] stacks."""
    txt = encode_retrieval_texts(params, cfg, input_ids, attention_mask, enc_token_id)
    img = (encode_retrieval_videos if video else encode_retrieval_images)(params, cfg, images)
    rr = retrieval_rerank(params, cfg, img["image_feats"], img["image_embeds"],
                          txt["text_embeds"], txt["enc_ids"], txt["text_atts"], k_test,
                          rows_per_chunk=rows_per_chunk, shard=shard, log=log)
    n_img, n_txt = len(img["image_embeds"]), len(txt["text_embeds"])
    d_i2t = densify(rr["scores_i2t"], rr["idx_i2t"], rr["rows_i2t"], (n_img, n_txt))
    d_t2i = densify(rr["scores_t2i"], rr["idx_t2i"], rr["rows_t2i"], (n_txt, n_img))
    return itm_eval(d_i2t, d_t2i, txt2img, img2txt, median_rank=video)
