"""Open-vocabulary segmentor (rs_ov/pipeline/segmentor.py), CLIP branch.

Per image: normalise (uint8 input: on the device) -> overlapping crops ->
the decontaminating ViT over all crops at once -> global CLS debias ->
SimFeatUp (``jbu_one``, ``jbu_stack`` or ``bilinear``) and the cosine
classifier, in chunks of ``tile_chunk`` crops -> optional CLS-logit blend
(``cls_token_lambda``) -> bilinear resize of the logits to the padded crop
-> overlap-average stitch -> resize to the original shape -> softmax,
synonym merge, argmax, threshold.

The JBU route follows rs_ov/pipeline/segmentor.py:326-395, with "on the
card" in place of the JAX package's "not on the CPU":

* bf16 tokens on the card, ``RS_OV_JBU_FUSED`` not "0": channel-last, the
  classifier fused into the last stage's kernel (K1 + K2 + K3) when Q <= 128,
  else channel-last features (K1 + K2) and the classifier below;
* otherwise (fp32, the kill switch, or the CPU): channel-first (K1, the
  epilogue in plain torch, K4b for fp32 / K4a for bf16), then the classifier
  in plain torch: fp32 L2 norm, bf16-rounded operands under bf16.

Precision follows the JAX package with the card in the TPU's role: bf16
weights and activations on CUDA by default (fp32 LayerNorm, softmax and
product results), fp32 on the CPU; ``param_dtype`` chooses. The segmentor
runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from rs_ov_torch.core.config import get_model_config
from rs_ov_torch.data.transforms import PREPROC_MEAN, PREPROC_STD
from rs_ov_torch.core.params import clip_params_from_numpy, init_clip_params, load_numpy_tree
from rs_ov_torch.decontam.global_debias import global_debias
from rs_ov_torch.nn.vit import VitCallConfig, vit_forward
from rs_ov_torch.pipeline.postprocess import postprocess_logits, query_onehot
from rs_ov_torch.pipeline.tiler import compute_padsize, extract_tiles, stitch, tile_grid
from rs_ov_torch.text.classifier import build_text_classifier, get_cls_idx
from rs_ov_torch.text.templates import OPENAI_IMAGENET_TEMPLATES
from rs_ov_torch.upsample.jbu import (get_upsampler, get_upsampler_nhwc,
                                      get_upsampler_nhwc_classify)
from rs_ov_torch.utils.resize import resize_bilinear

__all__ = ["SegmentorEx"]


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class SegmentorEx:
    """Training-free open-vocabulary segmentor, the production recipe."""

    def __init__(self,
                 clip_type: str = "CLIP",
                 vit_type: str = "ViT-B/16",
                 model_type: str = "Experimental",
                 name_path: str = "",
                 ignore_residual: bool = True,
                 prob_thd: float = 0.0,
                 logit_scale: float = 50.0,
                 slide_stride: int = 112,
                 slide_crop: int = 224,
                 cls_token_lambda: float = 0.0,
                 global_debias_factor: float = 0.0,
                 bg_idx: int = 0,
                 apply_sim_feat_up: bool = False,
                 sim_feat_up_cfg: Optional[dict] = None,
                 apply_ctd: bool = False,
                 apply_outlier_suppression: bool = False,
                 outlier_suppression_cfg: Optional[dict] = None,
                 apply_self_attn_enhancement: bool = False,
                 apply_layer_fusion: bool = False,
                 apply_similarity_enhancement: bool = False,
                 similarity_enhancement_cfg: Optional[dict] = None,
                 apply_cross_tile_fusion: bool = False,
                 apply_som: bool = False,
                 checkpoint_path: Optional[str] = None,
                 params=None,
                 upsampler_params=None,
                 query_features=None,
                 param_dtype: Optional[torch.dtype] = None,
                 templates=OPENAI_IMAGENET_TEMPLATES,
                 tile_chunk: int = 0,
                 seed: int = 0,
                 clip_config=None,
                 device=None):
        # fp32 products on the card run in full fp32, not TF32: the port's
        # numerics are held against the JAX package's fp32 islands
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for flag, what, item in (
                (clip_type != "CLIP", f"clip_type '{clip_type}'", "queue 1 item 8"),
                (apply_ctd, "CTD", "queue 1 item 7"),
                (apply_self_attn_enhancement, "self-attention enhancement", "queue 1 item 7"),
                (apply_layer_fusion, "layer fusion", "queue 1 item 7"),
                (apply_cross_tile_fusion, "cross-tile fusion", "queue 1 item 7"),
                (apply_som, "SOM", "queue 1 item 7"),
                (model_type != "Experimental", f"attention mode '{model_type}'",
                 "queue 1 item 7"),
                (bool((outlier_suppression_cfg or {}).get("suppression_layers")),
                 "outlier suppression_layers", "queue 1 item 7"),
                (checkpoint_path is not None, "checkpoint loading", "queue 1 item 1")):
            if flag:
                raise _not_ported(what, item)

        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("SegmentorEx runs on a CUDA card and found none "
                                   "(torch.cuda.is_available() is false); pass "
                                   "device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if param_dtype is None:
            param_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.param_dtype = param_dtype
        self.cfg = clip_config if clip_config is not None else get_model_config(
            "ViT-B/16" if "B" in vit_type else "ViT-L/14")
        self.patch_size = self.cfg.vision.patch_size

        gen = torch.Generator().manual_seed(seed)
        clip = (clip_params_from_numpy(params, self.cfg) if params is not None
                else init_clip_params(gen, self.cfg))
        self.clip = clip.to(device=self.device, dtype=param_dtype)

        query_words, self.query_idx = get_cls_idx(name_path)
        self.num_queries = len(query_words)
        self.num_classes = max(self.query_idx) + 1
        if query_features is not None:
            self.query_features = torch.as_tensor(
                np.asarray(query_features, np.float32)).to(self.device)
        else:
            self.query_features = build_text_classifier(
                self.clip.text, query_words, self.cfg.text,
                quick_gelu=self.cfg.quick_gelu, templates=templates)
        self._onehot = torch.from_numpy(query_onehot(self.query_idx)).to(self.device)
        self._mean = torch.from_numpy(PREPROC_MEAN).to(self.device)
        self._std = torch.from_numpy(PREPROC_STD).to(self.device)

        sim_cfg = dict(similarity_weight=1.0, temperature=1.0, add_self_similarity=True)
        sim_cfg.update(similarity_enhancement_cfg or {})
        out_cfg = dict(top_k=10, contamination_temp=0.1)
        out_cfg.update(outlier_suppression_cfg or {})
        self.call = VitCallConfig(
            model_type=model_type, ignore_residual=ignore_residual,
            quick_gelu=self.cfg.quick_gelu,
            apply_similarity_enhancement=apply_similarity_enhancement,
            similarity_weight=sim_cfg["similarity_weight"],
            similarity_temperature=sim_cfg["temperature"],
            add_self_similarity=sim_cfg["add_self_similarity"],
            apply_outlier_suppression=apply_outlier_suppression,
            outlier_top_k=out_cfg["top_k"],
            contamination_temp=out_cfg["contamination_temp"])

        self.logit_scale = float(logit_scale)
        self.prob_thd = float(prob_thd)
        self.slide_stride = slide_stride
        self.slide_crop = slide_crop
        self.global_debias_factor = float(global_debias_factor)
        self.cls_token_lambda = float(cls_token_lambda)
        self.bg_idx = int(bg_idx)
        self.tile_chunk = tile_chunk or 2

        self.apply_sim_feat_up = apply_sim_feat_up
        up_cfg = sim_feat_up_cfg or {}
        self.upsampler_name = up_cfg.get("model_name", "jbu_one")
        # 2 stages by default: classify at 4x the token grid and let the
        # bilinear logit resize cover the rest (rs_ov/pipeline/segmentor.py:264-280)
        self.jbu_stages = int(up_cfg.get("num_stages", 2))
        if not 1 <= self.jbu_stages <= 4:
            raise ValueError(f"jbu stages must be in [1, 4], got {self.jbu_stages}")
        self.upsampler = None
        if apply_sim_feat_up:
            fwd, init = get_upsampler(self.upsampler_name, stages=self.jbu_stages)
            self._upsample_fn = fwd
            self._upsample_fn_nhwc = get_upsampler_nhwc(self.upsampler_name, self.jbu_stages)
            self._upsample_classify_nhwc = get_upsampler_nhwc_classify(
                self.upsampler_name, self.jbu_stages)
            model_path = up_cfg.get("model_path")
            # random init unless weights are given (the repo holds none), as
            # the JAX package does; given weights overwrite every parameter
            up = init(torch.Generator().manual_seed(seed + 1), self.cfg.embed_dim)
            if upsampler_params is not None:
                load_numpy_tree(up, upsampler_params)
            elif model_path and os.path.exists(model_path):
                raise _not_ported("loading an upsampler checkpoint", "queue 1 item 1")
            self.upsampler = up.to(device=self.device, dtype=param_dtype)

    # ------------------------------------------------------------------

    def _jbu_route(self, tokens: torch.Tensor) -> str:
        """'nhwc_classify', 'nhwc' or 'channel_first'
        (rs_ov/pipeline/segmentor.py:329-363)."""
        nhwc_ok = (self._upsample_fn_nhwc is not None
                   and tokens.dtype == torch.bfloat16 and tokens.device.type == "cuda"
                   and os.environ.get("RS_OV_JBU_FUSED", "1") != "0")
        if (nhwc_ok and self._upsample_classify_nhwc is not None
                and self.query_features.shape[0] <= 128):
            return "nhwc_classify"
        return "nhwc" if nhwc_ok else "channel_first"

    def _classify(self, feats: torch.Tensor) -> torch.Tensor:
        """Cosine logits of [T, N, C] features -> [T, N, Q] fp32: fp32 L2
        norm, then bf16-rounded operands (exact products, fp32 sums) when the
        weights are bf16, fp32 operands otherwise."""
        f32 = feats.float()
        f32 = f32 / f32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        qf = self.query_features
        if self.param_dtype == torch.bfloat16:
            f32, qf = f32.to(torch.bfloat16).float(), qf.to(torch.bfloat16).float()
        return torch.matmul(f32, qf.t())

    def _decontam_and_classify(self, tokens, cls_norm, cls_logits, tiles, grid_hw,
                               pads, tile_hw):
        """tokens [T, P, C] -> per-tile logits [T, Q, th, tw]."""
        gh, gw = grid_hw
        t, _, c = tokens.shape
        tokens = global_debias(tokens, cls_norm, self.global_debias_factor)
        out_hw = (gh, gw)
        if not self.apply_sim_feat_up:
            logits = self._classify(tokens)
        else:
            route = self._jbu_route(tokens)
            if route == "nhwc_classify":
                lg = self._upsample_classify_nhwc(self.upsampler, tokens.reshape(t, gh, gw, c),
                                                  tiles, self.query_features)
                out_hw = lg.shape[1:3]
                logits = lg.reshape(t, -1, lg.shape[-1])
            elif route == "nhwc":
                up = self._upsample_fn_nhwc(self.upsampler, tokens.reshape(t, gh, gw, c), tiles)
                out_hw = up.shape[1:3]
                logits = self._classify(up.reshape(t, -1, c))
            else:
                feats = tokens.transpose(1, 2).reshape(t, c, gh, gw)
                up = self._upsample_fn(self.upsampler, feats, tiles)
                out_hw = up.shape[-2:]
                logits = self._classify(up.reshape(t, c, -1).transpose(1, 2))
        if self.cls_token_lambda != 0.0:
            logits = logits + cls_logits[:, None, :] * self.cls_token_lambda
        logits = logits.transpose(1, 2).reshape(t, -1, *out_hw)  # [T, Q, ph, pw]
        pad_h = tile_hw[0] + pads[2] + pads[3]
        pad_w = tile_hw[1] + pads[0] + pads[1]
        logits = resize_bilinear(logits, (pad_h, pad_w))
        left, _, top, _ = pads
        return logits[:, :, top:top + tile_hw[0], left:left + tile_hw[1]]

    def _chunked_decontam(self, tokens, cls_norm, cls_logits, tiles, grid_hw, pads,
                          tile_hw):
        """Debias + JBU + classify in chunks of tile_chunk crops: the upsampler's
        temporaries scale with the chunk, the ViT still runs on all crops."""
        c = self.tile_chunk
        return torch.cat([
            self._decontam_and_classify(tokens[i:i + c], cls_norm[i:i + c],
                                        cls_logits[i:i + c], tiles[i:i + c], grid_hw,
                                        pads, tile_hw)
            for i in range(0, tokens.shape[0], c)])

    def _forward_image(self, img: torch.Tensor, ori_shape: tuple[int, int]):
        """img [3, H, W] normalised, on the device -> (probs, pred)."""
        h_img, w_img = img.shape[-2:]
        if self.slide_crop > 0:
            coords, _ = tile_grid(h_img, w_img, self.slide_stride, self.slide_crop)
        else:
            coords = ((0, 0, h_img, w_img),)
        ch, cw = coords[0][2] - coords[0][0], coords[0][3] - coords[0][1]
        pads = compute_padsize(ch, cw, self.patch_size)
        tiles = extract_tiles(img, coords)
        left, right, top, bottom = pads
        tiles = torch.nn.functional.pad(tiles, (left, right, top, bottom))
        tiles = tiles.to(self.param_dtype)

        pooled, tokens = vit_forward(self.clip.visual, tiles, self.cfg.vision, self.call)
        p32 = pooled.float()
        cls_norm = p32 / p32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        cls_logits = cls_norm @ self.query_features.t()  # [T, Q]
        grid_hw = (tiles.shape[-2] // self.patch_size, tiles.shape[-1] // self.patch_size)
        tile_logits = self._chunked_decontam(tokens, cls_norm, cls_logits, tiles, grid_hw,
                                             pads, (ch, cw))
        preds = resize_bilinear(stitch(tile_logits, coords, h_img, w_img), ori_shape)
        return postprocess_logits(preds, self._onehot, logit_scale=self.logit_scale,
                                  prob_thd=self.prob_thd, bg_idx=self.bg_idx)

    def _results(self, images, data_samples, shape_of):
        results = []
        for i, img in enumerate(images):
            meta = (data_samples[i] if data_samples is not None else None) or {}
            ori_shape = tuple(meta.get("ori_shape", shape_of(img)))[:2]
            probs, pred = self._forward_image(img, ori_shape)
            results.append({"seg_logits": probs, "pred_sem_seg": pred})
        return results

    @torch.no_grad()
    def predict_raw(self, inputs, data_samples=None):
        """inputs [B, H, W, 3] uint8 RGB. Mean/std normalisation and HWC->CHW
        run on the device. Returns one {'seg_logits': [C, oh, ow],
        'pred_sem_seg': [1, oh, ow]} per image, on the device."""
        x = torch.as_tensor(np.asarray(inputs)).to(self.device)
        images = (((im.float() - self._mean) / self._std).permute(2, 0, 1) for im in x)
        return self._results(images, data_samples, lambda im: im.shape[-2:])

    @torch.no_grad()
    def predict(self, inputs, data_samples=None):
        """inputs [B, 3, H, W] mean/std-normalised RGB (numpy or tensor)."""
        x = torch.as_tensor(np.asarray(inputs, np.float32) if not torch.is_tensor(inputs)
                            else inputs).to(self.device, torch.float32)
        return self._results(x, data_samples, lambda im: im.shape[-2:])
