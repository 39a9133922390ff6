"""Open-vocabulary segmentor (rs_ov/pipeline/segmentor.py:51-812).

The tower follows ``clip_type`` and ``vit_type`` as in the JAX package
(``_resolve_arch``: the plain OpenAI-style ViTs of CLIP, RemoteCLIP,
GeoRSCLIP, SkyCLIP, OpenCLIP, MetaCLIP and ALIP), or ``clip_type="BLIP"``
(the BLIP ViT and its BERT text tower, ``blip_vocab_path`` naming the
WordPiece vocabulary). ``model_type="GEM"`` runs the CLIP tower's GEM
dual stream (``gem_depth``, ``ss_attn_iter``, ``ss_attn_temp``). GEM and
BLIP give patch tokens only, so they refuse global debias,
``cls_token_lambda`` and CTD, which read the CLS token.

Per image, or per batch of N images of one geometry (``predict_batch_raw``):
normalise (uint8 input: on the device) -> overlapping crops (BLIP: each
resized to the tower's ``image_size``) -> the decontaminating ViT over all
N*T crops at once (every attention mode of ``ATTENTION_MODES``, SOM, layer
fusion, self-attention enhancement, outlier suppression; or GEM's gem
stream, or the BLIP ViT with its q.q last block) -> optional cross-tile
fusion over each image's crops -> in chunks of ``tile_chunk`` crops
(``RS_OV_TILE_CHUNK``; by default 2 with SimFeatUp, else all at once):
global CLS debias, optional CTD (DBSCAN, then
clustered CLS debias), SimFeatUp (``jbu_one``, ``jbu_stack``, ``bilinear``
or, random init only, the channel-first alternates ``resize_conv``,
``ifa``, ``carafe`` and ``sapa``) and the cosine classifier -> optional CLS-logit blend
(``cls_token_lambda``) -> bilinear resize of the logits to the padded crop
-> per image: overlap-average stitch -> resize to the original shape ->
softmax, synonym merge, argmax, threshold. With ``shape_bucket`` (or
``RS_OV_SHAPE_BUCKET``) ``predict_raw`` and ``predict`` pad each image up to
a multiple of the bucket and crop the stitched logits back before the
resize, as the JAX package does.

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

from rs_ov_torch.core.checkpoint import (clip_params_from_state_dict,
                                         jbu_params_from_state_dict, load_torch_state_dict)
from rs_ov_torch.core.config import get_model_config
from rs_ov_torch.core.params import (blip_params_from_numpy, clip_params_from_numpy,
                                     init_clip_params, load_numpy_tree)
from rs_ov_torch.data.palette import colorize_mask, confidence_heatmap
from rs_ov_torch.data.transforms import PREPROC_MEAN, PREPROC_STD
from rs_ov_torch.decontam.cross_tile import CrossTileFusionConfig, fuse_tile_grid
from rs_ov_torch.decontam.ctd import adaptive_debiasing, cluster_patch_tokens_dbscan
from rs_ov_torch.decontam.global_debias import global_debias
from rs_ov_torch.nn.attention import ATTENTION_MODES
from rs_ov_torch.nn.blip import (BlipConfig, blip_encode_image, blip_encode_text,
                                 blip_params_from_state_dict, init_blip_params)
from rs_ov_torch.nn.gem import gem_vit_forward
from rs_ov_torch.nn.vit import VitCallConfig, vit_forward
from rs_ov_torch.pipeline.postprocess import postprocess_logits, query_onehot
from rs_ov_torch.pipeline.tiler import compute_padsize, extract_tiles, stitch, tile_grid
from rs_ov_torch.text.classifier import build_text_classifier, get_cls_idx
from rs_ov_torch.text.templates import OPENAI_IMAGENET_TEMPLATES
from rs_ov_torch.text.wordpiece import WordPieceTokenizer
from rs_ov_torch.upsample.jbu import (get_upsampler, get_upsampler_nhwc,
                                      get_upsampler_nhwc_classify)
from rs_ov_torch.utils.resize import resize_bilinear

__all__ = ["SegmentorEx", "Segmentor"]


def _resolve_arch(clip_type: str, vit_type: str) -> str:
    """(clip_type, vit_type) -> the tower's config name
    (rs_ov/pipeline/segmentor.py:51-67); BLIP takes its own branch."""
    b = "B" in vit_type
    table = {
        "CLIP": "ViT-B/16" if b else "ViT-L/14",
        "RemoteCLIP": "ViT-B-32" if b else "ViT-L-14",
        "GeoRSCLIP": "ViT-B-32" if b else ("ViT-H-14" if "H" in vit_type else "ViT-L-14"),
        "SkyCLIP": "ViT-B-32" if b else "ViT-L-14",
        "OpenCLIP": "ViT-B-16" if b else "ViT-L-14",
        "MetaCLIP": "ViT-B-16-quickgelu" if b else "ViT-L-14-quickgelu",
        "ALIP": "ViT-B-32",
    }
    if clip_type not in table:
        raise NotImplementedError(f"clip_type '{clip_type}' not yet supported (known: "
                                  f"{sorted(table)} + BLIP via the dedicated branch)")
    return table[clip_type]


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or a numpy dtype or its name ("uint8"), as a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)


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
                 ctd_cfg: Optional[dict] = None,
                 apply_outlier_suppression: bool = False,
                 outlier_suppression_cfg: Optional[dict] = None,
                 apply_self_attn_enhancement: bool = False,
                 self_attn_enhancement_cfg: Optional[dict] = None,
                 apply_layer_fusion: bool = False,
                 layer_fusion_lambda: float = 0.5,
                 layer_fusion_threshold: float = 0.7,
                 apply_similarity_enhancement: bool = False,
                 similarity_enhancement_cfg: Optional[dict] = None,
                 apply_cross_tile_fusion: bool = False,
                 cross_tile_fusion_cfg: Optional[dict] = None,
                 apply_som: bool = False,
                 som_cfg: Optional[dict] = None,
                 result_dir: Optional[str] = None,
                 heatmap_dir: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 params=None,
                 upsampler_params=None,
                 query_features=None,
                 blip_vocab_path: Optional[str] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 templates=OPENAI_IMAGENET_TEMPLATES,
                 tile_chunk: int = 0,
                 pred_dtype=None,
                 shape_bucket: int = 0,
                 gem_depth: int = 7,
                 ss_attn_iter: int = 1,
                 ss_attn_temp: Optional[float] = None,
                 seed: int = 0,
                 clip_config=None,
                 device=None):
        # fp32 products on the card run in full fp32, not TF32: the port's
        # numerics are held against the JAX package's fp32 islands
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.is_blip = clip_type == "BLIP"
        # the BLIP path takes no attention mode (its last block is q.q)
        if not self.is_blip and model_type not in ATTENTION_MODES + ("GEM",):
            raise ValueError(f"Unknown attention mode '{model_type}'. "
                             f"Known: {ATTENTION_MODES + ('GEM',)}")
        if (model_type == "GEM" or self.is_blip) and (
                global_debias_factor != 0.0 or cls_token_lambda != 0.0 or apply_ctd):
            raise ValueError("GEM/BLIP paths are incompatible with "
                             "global_debias/cls_token_lambda/CTD (no CLS token)")

        self.clip_type, self.vit_type, self.model_type = clip_type, vit_type, model_type
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
        # no implicit download: without params or a checkpoint, random
        # weights from the seed keep the pipeline runnable
        self.clip = self.blip = None
        if self.is_blip:
            self.cfg = clip_config if clip_config is not None else (
                BlipConfig.base(slide_crop) if "B" in vit_type else BlipConfig.large(slide_crop))
            if params is not None:
                model = blip_params_from_numpy(params)
            elif checkpoint_path:
                model = blip_params_from_state_dict(load_torch_state_dict(checkpoint_path))
            else:
                model = init_blip_params(torch.Generator().manual_seed(seed), self.cfg)
            self.blip = model.to(device=self.device, dtype=param_dtype)
        else:
            self.cfg = clip_config if clip_config is not None else get_model_config(
                _resolve_arch(clip_type, vit_type))
            if params is not None:
                model = clip_params_from_numpy(params, self.cfg)
            elif checkpoint_path:
                model = clip_params_from_state_dict(load_torch_state_dict(checkpoint_path),
                                                    self.cfg)
            else:
                model = init_clip_params(torch.Generator().manual_seed(seed), self.cfg)
            self.clip = model.to(device=self.device, dtype=param_dtype)
        self.patch_size = self.cfg.vision.patch_size
        self.gem_depth, self.ss_attn_iter, self.ss_attn_temp = gem_depth, ss_attn_iter, ss_attn_temp

        query_words, self.query_idx = get_cls_idx(name_path)
        self.num_queries = len(query_words)
        self.num_classes = max(self.query_idx) + 1
        if query_features is not None:
            self.query_features = torch.as_tensor(
                np.asarray(query_features, np.float32)).to(self.device)
        elif self.is_blip:
            self.query_features = self._build_blip_classifier(query_words, templates,
                                                              blip_vocab_path)
        else:
            self.query_features = build_text_classifier(
                self.clip.text, query_words, self.cfg.text,
                quick_gelu=self.cfg.quick_gelu, templates=templates)
        self._onehot = torch.from_numpy(query_onehot(self.query_idx)).to(self.device)
        self._mean = torch.from_numpy(PREPROC_MEAN).to(self.device)
        self._std = torch.from_numpy(PREPROC_STD).to(self.device)

        sim_cfg = dict(similarity_weight=1.0, temperature=1.0, add_self_similarity=True)
        sim_cfg.update(similarity_enhancement_cfg or {})
        # suppression_layers: global layer indices (negatives allowed) whose
        # attention feeds outlier detection; () = the last front block
        out_cfg = dict(top_k=10, contamination_temp=0.1, suppression_layers=())
        out_cfg.update(outlier_suppression_cfg or {})
        sa_cfg = dict(enhancement_strength=0.1, min_self_attn_threshold=0.15,
                      mode="feature", top_k=10)
        sa_cfg.update(self_attn_enhancement_cfg or {})
        som = dict(consensus_threshold=0.5, detection_mode="both",
                   self_sufficiency_ratio=1.0)
        som.update(som_cfg or {})
        self.call = VitCallConfig(
            model_type=model_type, ignore_residual=ignore_residual,
            quick_gelu=getattr(self.cfg, "quick_gelu", False),
            apply_similarity_enhancement=apply_similarity_enhancement,
            similarity_weight=sim_cfg["similarity_weight"],
            similarity_temperature=sim_cfg["temperature"],
            add_self_similarity=sim_cfg["add_self_similarity"],
            apply_outlier_suppression=apply_outlier_suppression,
            outlier_top_k=out_cfg["top_k"],
            contamination_temp=out_cfg["contamination_temp"],
            outlier_source_layers=tuple(out_cfg["suppression_layers"]),
            apply_self_attn_enhancement=apply_self_attn_enhancement,
            self_attn_strength=sa_cfg["enhancement_strength"],
            self_attn_threshold=sa_cfg["min_self_attn_threshold"],
            self_attn_mode=sa_cfg["mode"],
            self_attn_top_k=sa_cfg["top_k"],
            apply_layer_fusion=apply_layer_fusion,
            layer_fusion_lambda=layer_fusion_lambda,
            layer_fusion_threshold=layer_fusion_threshold,
            apply_som=apply_som,
            som_consensus_threshold=som["consensus_threshold"],
            som_detection_mode=som["detection_mode"],
            som_self_sufficiency_ratio=som["self_sufficiency_ratio"])
        self.apply_ctd = apply_ctd
        self.ctd_cfg = dict(max_points=8192, metric="euclidean", eps=1.1, min_samples=11)
        self.ctd_cfg.update(ctd_cfg or {})
        self.apply_cross_tile_fusion = apply_cross_tile_fusion
        self.ctf_cfg = CrossTileFusionConfig(**(cross_tile_fusion_cfg or {}))

        self.logit_scale = float(logit_scale)
        self.prob_thd = float(prob_thd)
        self.slide_stride = slide_stride
        self.slide_crop = slide_crop
        self.global_debias_factor = float(global_debias_factor)
        self.cls_token_lambda = float(cls_token_lambda)
        self.bg_idx = int(bg_idx)
        self.pred_dtype = _torch_dtype(pred_dtype or torch.int32)
        self.result_dir = result_dir
        self.heatmap_dir = heatmap_dir
        self.tile_chunk = tile_chunk  # 0: RS_OV_TILE_CHUNK or the default, at call time
        self.shape_bucket = shape_bucket or int(os.environ.get("RS_OV_SHAPE_BUCKET", "0"))

        self.apply_sim_feat_up = apply_sim_feat_up
        up_cfg = sim_feat_up_cfg or {}
        self.upsampler_name = up_cfg.get("model_name", "jbu_one")
        # 2 stages by default: classify at 4x the token grid and let the
        # bilinear logit resize cover the rest; RS_OV_JBU_STAGES overrides
        # (rs_ov/pipeline/segmentor.py:264-280)
        self.jbu_stages = int(os.environ.get("RS_OV_JBU_STAGES", up_cfg.get("num_stages", 2)))
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
            # random init unless weights are given, as the JAX package does:
            # a missing model_path falls back to it
            if upsampler_params is not None:
                up = load_numpy_tree(init(torch.Generator(), self.cfg.embed_dim),
                                     upsampler_params)
            elif model_path and os.path.exists(model_path):
                up = jbu_params_from_state_dict(load_torch_state_dict(model_path),
                                                self.upsampler_name)
            else:
                up = init(torch.Generator().manual_seed(seed + 1), self.cfg.embed_dim)
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

    @torch.no_grad()
    def _build_blip_classifier(self, query_words, templates, vocab_path) -> torch.Tensor:
        """Prompt-ensembled queries through the BLIP text tower: per word,
        each template's normalised projected CLS, averaged and normalised
        again (rs_ov/pipeline/segmentor.py:397-419) -> [Q, embed_dim] fp32."""
        if vocab_path is None:
            raise ValueError("clip_type='BLIP' needs blip_vocab_path (a BERT vocab.txt) or "
                             "precomputed query_features: no implicit downloads")
        tok = WordPieceTokenizer(vocab_path)
        feats = []
        for word in query_words:
            batch = tok([t.format(word) for t in templates], max_length=35)
            ids, mask = (torch.from_numpy(batch[k]).to(self.device)
                         for k in ("input_ids", "attention_mask"))
            mean = blip_encode_text(self.blip, ids, mask, self.cfg).float().mean(0)
            feats.append(mean / mean.norm().clamp_min(1e-12))
        return torch.stack(feats)

    def _decontam_and_classify(self, tokens, cls_norm, cls_logits, tiles, grid_hw,
                               pads, tile_hw):
        """tokens [T, P, C] -> per-tile logits [T, Q, th, tw]."""
        gh, gw = grid_hw
        t, _, c = tokens.shape
        tokens = global_debias(tokens, cls_norm, self.global_debias_factor)
        if self.apply_ctd:
            _, labels = cluster_patch_tokens_dbscan(tokens, (gh, gw), self.ctd_cfg)
            tokens = adaptive_debiasing(tokens, labels, cls_norm, factor=-1.5)
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

    def _chunk_size(self) -> int:
        """Crops per decontam / JBU / classify chunk; 0 runs all at once
        (rs_ov/pipeline/segmentor.py:496-497)."""
        return self.tile_chunk or int(os.environ.get(
            "RS_OV_TILE_CHUNK", "2" if self.apply_sim_feat_up else "0"))

    def _chunked_decontam(self, tokens, cls_norm, cls_logits, tiles, grid_hw, pads,
                          tile_hw):
        """Debias + JBU + classify in chunks of crops: the upsampler's
        temporaries scale with the chunk, the ViT still runs on all crops."""
        c, t = self._chunk_size(), tokens.shape[0]
        if not c or t <= c:
            return self._decontam_and_classify(tokens, cls_norm, cls_logits, tiles,
                                               grid_hw, pads, tile_hw)
        return torch.cat([
            self._decontam_and_classify(tokens[i:i + c], cls_norm[i:i + c],
                                        cls_logits[i:i + c], tiles[i:i + c], grid_hw,
                                        pads, tile_hw)
            for i in range(0, t, c)])

    def _fuse_tiles(self, tokens, grid_shape, grid_hw, n_images: int):
        """Cross-tile fusion per image: the flat [N*T, P, C] batch is regrouped
        so that fusion never crosses an image boundary
        (rs_ov/pipeline/segmentor.py:421-432)."""
        t = tokens.shape[0] // n_images
        return torch.cat([fuse_tile_grid(tokens[i * t:(i + 1) * t], grid_shape, grid_hw,
                                         self.ctf_cfg) for i in range(n_images)])

    def _tile_logits(self, imgs: torch.Tensor):
        """imgs [N, 3, H, W] normalised, on the device -> (per-crop logits
        [N, T, Q, ch, cw], crop coordinates). The N*T crops are one batch."""
        n, _, h_img, w_img = imgs.shape
        if self.slide_crop > 0:
            coords, grid_shape = tile_grid(h_img, w_img, self.slide_stride, self.slide_crop)
        else:
            coords, grid_shape = ((0, 0, h_img, w_img),), (1, 1)
        ch, cw = coords[0][2] - coords[0][0], coords[0][3] - coords[0][1]
        pads = compute_padsize(ch, cw, self.patch_size)
        tiles = torch.cat([extract_tiles(im, coords) for im in imgs])
        tiles = torch.nn.functional.pad(tiles, pads)  # (left, right, top, bottom)
        tile_logits = self._forward_tiles(tiles, grid_shape, pads, (ch, cw), n)
        return tile_logits.reshape(n, len(coords), *tile_logits.shape[1:]), coords

    def _forward_tiles(self, tiles: torch.Tensor, grid_shape, pads, tile_hw,
                       n_images: int = 1) -> torch.Tensor:
        """Padded crops [T, 3, ch, cw] -> per-crop logits [T, Q, th, tw]
        (rs_ov/pipeline/segmentor.py:434-487); cross-tile fusion regroups the
        crops per image."""
        tiles = tiles.to(self.param_dtype)
        if self.is_blip:  # the crops at the tower's own size: no pos-embed resample
            s = self.cfg.vision.image_size
            tiles = resize_bilinear(tiles, (s, s))
            tokens = blip_encode_image(self.blip, tiles, self.cfg,
                                       ignore_residual=self.call.ignore_residual)
        elif self.model_type == "GEM":
            tokens = gem_vit_forward(
                self.clip.visual, tiles, self.cfg.vision, depth=self.gem_depth,
                ss_attn_iter=self.ss_attn_iter, ss_attn_temp=self.ss_attn_temp,
                ignore_residual=self.call.ignore_residual, quick_gelu_act=self.cfg.quick_gelu)
        else:
            pooled, tokens = vit_forward(self.clip.visual, tiles, self.cfg.vision, self.call)
        if self.is_blip or self.model_type == "GEM":  # patch tokens only: no CLS
            cls_norm = torch.zeros((tokens.shape[0], tokens.shape[-1]), device=self.device)
            cls_logits = torch.zeros((tokens.shape[0], self.query_features.shape[0]),
                                     device=self.device)
        else:
            p32 = pooled.float()
            cls_norm = p32 / p32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            cls_logits = cls_norm @ self.query_features.t()  # [N*T, Q]
        grid_hw = (tiles.shape[-2] // self.patch_size, tiles.shape[-1] // self.patch_size)
        if self.apply_cross_tile_fusion:
            tokens = self._fuse_tiles(tokens, grid_shape, grid_hw, n_images)
        return self._chunked_decontam(tokens, cls_norm, cls_logits, tiles, grid_hw, pads,
                                      tile_hw)

    def _forward_images(self, imgs: torch.Tensor, ori_shape: tuple[int, int],
                        extent: Optional[tuple[int, int]] = None):
        """imgs [N, 3, H, W] -> one {'seg_logits', 'pred_sem_seg'} per image.
        ``extent`` crops a bucket-padded logit canvas back to the image."""
        tile_logits, coords = self._tile_logits(imgs)
        h_img, w_img = imgs.shape[-2:]
        eh, ew = extent or (h_img, w_img)
        results = []
        for tl in tile_logits:
            canvas = stitch(tl, coords, h_img, w_img)[:, :eh, :ew]
            probs, pred = postprocess_logits(
                resize_bilinear(canvas, ori_shape), self._onehot,
                logit_scale=self.logit_scale, prob_thd=self.prob_thd, bg_idx=self.bg_idx,
                pred_dtype=self.pred_dtype)
            results.append({"seg_logits": probs, "pred_sem_seg": pred})
        return results

    def _bucket_pad(self, h: int, w: int) -> tuple[int, int]:
        """(rows, columns) to pad an h x w image up to its shape bucket."""
        b, crop = self.shape_bucket, self.slide_crop or 0
        return max(-(-h // b) * b, crop) - h, max(-(-w // b) * b, crop) - w

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 [..., H, W, 3] on the device -> normalised fp32 [..., 3, H, W]."""
        return ((x.float() - self._mean) / self._std).movedim(-1, -3)

    @staticmethod
    def _meta(data_samples, i: int) -> dict:
        return (data_samples[i] if data_samples is not None else None) or {}

    def _ori_shape(self, data_samples, i: int, default) -> tuple[int, int]:
        return tuple(self._meta(data_samples, i).get("ori_shape", default))[:2]

    def _maybe_dump(self, results, data_samples) -> None:
        """With ``result_dir`` / ``heatmap_dir``: each image's colourised
        prediction / confidence heatmap as ``<stem>.png``, the stem from its
        meta's path, else ``sample_<i>`` (rs_ov/pipeline/segmentor.py:779-798)."""
        if not (self.result_dir or self.heatmap_dir):
            return
        for i, result in enumerate(results):
            meta = self._meta(data_samples, i)
            stem = next((os.path.splitext(os.path.basename(meta[k]))[0]
                         for k in ("img_path", "ori_path", "filename", "ori_filename")
                         if meta.get(k)), f"sample_{i}")
            if self.result_dir:
                os.makedirs(self.result_dir, exist_ok=True)
                colorize_mask(result["pred_sem_seg"][0].cpu().numpy(), self.num_classes,
                              self.bg_idx, os.path.join(self.result_dir, f"{stem}.png"))
            if self.heatmap_dir:
                os.makedirs(self.heatmap_dir, exist_ok=True)
                confidence_heatmap(result["seg_logits"].amax(0).cpu().numpy(),
                                   os.path.join(self.heatmap_dir, f"{stem}.png"))

    @torch.no_grad()
    def forward_feature(self, img, logit_size=None) -> torch.Tensor:
        """Per-pixel logits [B, Q, H, W] of normalised images [B, 3, H, W] in
        one shot, without the sliding window (rs_ov/pipeline/segmentor.py:661-675);
        resized to ``logit_size`` when given."""
        x = torch.as_tensor(np.asarray(img, np.float32) if not torch.is_tensor(img)
                            else img).to(self.device, torch.float32)
        h, w = x.shape[-2:]
        pads = compute_padsize(h, w, self.patch_size)
        logits = self._forward_tiles(torch.nn.functional.pad(x, pads), (1, 1), pads, (h, w))
        return logits if logit_size is None else resize_bilinear(logits, tuple(logit_size))

    @torch.no_grad()
    def predict_raw(self, inputs, data_samples=None):
        """inputs [B, H, W, 3] uint8 RGB. Mean/std normalisation and HWC->CHW
        run on the device. Returns one {'seg_logits': [C, oh, ow],
        'pred_sem_seg': [1, oh, ow]} per image, on the device. With a shape
        bucket the uint8 image is padded with 0 (normalised: -mean/std)."""
        x = torch.as_tensor(np.asarray(inputs)).to(self.device)
        results = []
        for i, im in enumerate(x):
            h, w = im.shape[:2]
            ori_shape = self._ori_shape(data_samples, i, (h, w))
            if self.shape_bucket:
                ph, pw = self._bucket_pad(h, w)
                im = torch.nn.functional.pad(im, (0, 0, 0, pw, 0, ph))
            results += self._forward_images(self._normalise(im)[None], ori_shape, (h, w))
        self._maybe_dump(results, data_samples)
        return results

    @torch.no_grad()
    def predict_batch_raw(self, inputs, data_samples=None):
        """predict_raw of N uint8 images of one geometry [N, H, W, 3] as one
        batch of N*T crops (rs_ov/pipeline/segmentor.py:714-747): the same
        predictions as per-image predict_raw. The images must share their
        ori_shape; N == 1 is predict_raw. Shape buckets do not apply, as in
        the JAX package."""
        inputs = np.asarray(inputs)
        n, h, w = inputs.shape[:3]
        if n == 1:
            return self.predict_raw(inputs, data_samples)
        shapes = {self._ori_shape(data_samples, i, (h, w)) for i in range(n)}
        if len(shapes) != 1:
            raise ValueError(f"predict_batch_raw needs a shape-homogeneous batch, got "
                             f"ori_shapes {sorted(shapes)}")
        x = torch.as_tensor(inputs).to(self.device)
        results = self._forward_images(self._normalise(x), shapes.pop())
        self._maybe_dump(results, data_samples)
        return results

    @torch.no_grad()
    def predict(self, inputs, data_samples=None):
        """inputs [B, 3, H, W] mean/std-normalised RGB (numpy or tensor). With
        a shape bucket the image is padded with 0 (the dataset mean)."""
        x = torch.as_tensor(np.asarray(inputs, np.float32) if not torch.is_tensor(inputs)
                            else inputs).to(self.device, torch.float32)
        results = []
        for i, img in enumerate(x):
            h, w = img.shape[-2:]
            ori_shape = self._ori_shape(data_samples, i, (h, w))
            if self.shape_bucket:
                ph, pw = self._bucket_pad(h, w)
                img = torch.nn.functional.pad(img, (0, pw, 0, ph))
            results += self._forward_images(img[None], ori_shape, (h, w))
        self._maybe_dump(results, data_samples)
        return results


class Segmentor(SegmentorEx):
    """The plain SegEarth-OV variant (rs_ov/pipeline/segmentor.py:801-812):
    the same pipeline with SegEarth attention by default and without the CTD,
    outlier-suppression, self-attention-enhancement, layer-fusion and
    similarity-enhancement hooks, whose switches it drops."""

    def __init__(self, clip_type="CLIP", vit_type="ViT-B/16", model_type="SegEarth",
                 name_path="", **kwargs):
        for banned in ("apply_ctd", "apply_outlier_suppression",
                       "apply_self_attn_enhancement", "apply_layer_fusion",
                       "apply_similarity_enhancement"):
            kwargs.pop(banned, None)
        super().__init__(clip_type=clip_type, vit_type=vit_type, model_type=model_type,
                         name_path=name_path, **kwargs)
