"""Model factory, the open_clip entry surface on the port (rs_ov/factory.py).

``create_model(model_name, pretrained, precision)`` gives a ``CLIPModel``
with ``encode_image`` / ``encode_text``; ``create_model_and_transforms``
adds the preprocess closure, ``get_tokenizer`` the tokenizer the config
names. ``pretrained`` is a local checkpoint path or a registry tag; a tag
resolves only to a file already staged in the cache (``rs_ov_torch.pretrained``),
else a ``FileNotFoundError`` names its URL: nothing is downloaded.

Models run on the card unless the caller passes ``device="cpu"``; with no
card and no device they raise. ``precision`` "fp32" keeps fp32 weights and
activations (full fp32 products, TF32 off), "bf16" and "fp16" mean bf16, as
in the JAX package, whose ViT products then run on the tensor cores
(``nn.layers.matmul32``). The transforms stay numpy + PIL on the host and
give arrays equal to the JAX package's. The timm and HF towers and ``.npz``
checkpoints are ROADMAP queue 1 item 8e, CoCa item 9, the losses item 10.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from rs_ov_torch.core.checkpoint import (clip_params_from_state_dict,
                                         infer_clip_config_from_state_dict,
                                         load_torch_state_dict)
from rs_ov_torch.core.config import CLIPConfig, get_model_config
from rs_ov_torch.core.params import CLIP, init_clip_params
from rs_ov_torch.nn.vit import VitCallConfig, vit_forward
from rs_ov_torch.pretrained import (OPENAI_MEAN, OPENAI_STD, download_pretrained,
                                     get_pretrained_cfg, get_pretrained_url)
from rs_ov_torch.text.encoder import text_forward
from rs_ov_torch.text.tokenizer import SimpleTokenizer

__all__ = ["CLIPModel", "create_loss", "create_model", "create_model_and_transforms",
           "create_model_from_pretrained", "get_tokenizer", "image_transform",
           "image_transform_v2", "PreprocessCfg", "preprocess_style", "center_crop_or_pad",
           "resolve_device"]

_PRECISIONS = {"fp32": torch.float32, "fp16": torch.bfloat16, "bf16": torch.bfloat16,
               "bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None; no card and no device raises.
    Full fp32 products on the card (TF32 off), as the segmentor keeps them."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the port's models run on a CUDA card and found none "
                               "(torch.cuda.is_available() is false); pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 / x32.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(x.dtype)


class CLIPModel(nn.Module):
    """The open_clip ``CLIP`` surface over the port's CLIP module ``clip``
    (rs_ov/factory.py:41-95). Inputs may be numpy arrays or tensors; they
    are moved to the weights' device and dtype."""

    def __init__(self, cfg: CLIPConfig, clip: CLIP):
        super().__init__()
        self.cfg = cfg
        self.clip = clip

    @property
    def device(self) -> torch.device:
        return self.clip.logit_scale.device

    @property
    def dtype(self) -> torch.dtype:
        return self.clip.logit_scale.dtype

    @torch.no_grad()
    def encode_image(self, image, model_type: str = "vanilla", ignore_residual: bool = False,
                     output_cls_token: bool = False, normalize: bool = False, **call_kwargs):
        """[B, 3, H, W] -> the projected patch tokens [B, P, E], or (pooled
        [B, E], tokens) with ``output_cls_token``; the last block runs
        ``model_type``'s attention (``nn.vit.vit_forward``), and with
        ``RS_OV_FUSED_ATTN=1`` on the card a self-self mode's context comes
        from K6."""
        call = VitCallConfig(model_type=model_type, ignore_residual=ignore_residual,
                             quick_gelu=self.cfg.quick_gelu, **call_kwargs)
        x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
        pooled, tokens = vit_forward(self.clip.visual, x.to(self.device, self.dtype),
                                     self.cfg.vision, call)
        if output_cls_token:
            return (_l2norm(pooled), _l2norm(tokens)) if normalize else (pooled, tokens)
        return _l2norm(tokens) if normalize else tokens

    @torch.no_grad()
    def encode_text(self, text_ids, normalize: bool = False) -> torch.Tensor:
        """int [B, ctx] token ids -> [B, E]."""
        ids = torch.as_tensor(np.asarray(text_ids) if not torch.is_tensor(text_ids)
                              else text_ids).to(self.device, torch.long)
        return text_forward(self.clip.text, ids, self.cfg.text,
                            quick_gelu_act=self.cfg.quick_gelu, normalize=normalize)

    @property
    def logit_scale(self) -> torch.Tensor:
        return torch.exp(self.clip.logit_scale)

    @property
    def visual_patch_size(self) -> tuple[int, int]:
        return (self.cfg.vision.patch_size, self.cfg.vision.patch_size)


def _refuse_timm(cfg: CLIPConfig, model_name: str) -> None:
    if cfg.vision.timm_model_name or cfg.text.hf_model_name:
        raise NotImplementedError(f"'{model_name}' has a timm or HF tower, which is not "
                                  "ported yet (ROADMAP queue 1 item 8e)")


def create_model(model_name: str, pretrained: Optional[str] = None,
                 precision: str = "fp32", device=None, force_quick_gelu: bool = False,
                 seed: int = 0, force_image_size: Optional[int] = None,
                 **_ignored) -> CLIPModel:
    """(rs_ov/factory.py:148-239). ``pretrained``: a local checkpoint path
    or a registry tag staged in the cache; None gives random weights from a
    ``torch.Generator`` seeded with ``seed``. ``force_image_size`` overrides
    the arch's input resolution (the pos-embed is interpolated at run time)."""
    device = resolve_device(device)

    def _sized(c):
        if force_image_size and c.vision.image_size != force_image_size:
            return dataclasses.replace(
                c, vision=dataclasses.replace(c.vision, image_size=force_image_size))
        return c

    dtype = _PRECISIONS.get(precision, torch.float32)
    if pretrained and not os.path.exists(pretrained):
        pcfg = get_pretrained_cfg(model_name, pretrained)
        if pcfg:
            try:
                pretrained = download_pretrained(pcfg)
            except RuntimeError:
                pass  # not staged: the refusal below names the URL
    if model_name.startswith("coca"):
        raise NotImplementedError(f"CoCa model '{model_name}' is not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    if pretrained and os.path.exists(pretrained):
        if pretrained.endswith(".npz"):
            raise NotImplementedError("big_vision .npz checkpoints are not ported yet "
                                      "(ROADMAP queue 1 item 8e)")
        sd = load_torch_state_dict(pretrained)
        quick_gelu = force_quick_gelu or "/" in model_name \
            or pretrained.endswith((".pt",)) and "openai" in pretrained.lower()
        try:
            cfg = get_model_config(model_name)
        except KeyError:
            cfg = infer_clip_config_from_state_dict(sd, quick_gelu=quick_gelu)
        _refuse_timm(cfg, model_name)
        clip = clip_params_from_state_dict(sd, cfg)
        cfg = _sized(cfg)
    elif pretrained:
        url = get_pretrained_url(model_name, pretrained)
        raise FileNotFoundError(
            f"No implicit downloads. Fetch the weights for ({model_name}, {pretrained}) "
            f"from {url or 'its distributor'} and pass the local path as `pretrained`.")
    else:
        cfg = _sized(get_model_config(model_name))
        if force_quick_gelu and not cfg.quick_gelu:
            cfg = dataclasses.replace(cfg, quick_gelu=True)
        _refuse_timm(cfg, model_name)
        clip = init_clip_params(torch.Generator().manual_seed(seed), cfg)
    return CLIPModel(cfg, clip.to(device=device, dtype=dtype)).eval()


def preprocess_style(model_name: str, pretrained_tag: str | None = None):
    """(mean, std, interpolation, resize_mode) for a model and tag: the
    registry entry's where the tag has one, else by family (SigLIP and
    CLIPA take their own normalisation and 'squash')."""
    if pretrained_tag:
        cfg = get_pretrained_cfg(model_name, pretrained_tag)
        if cfg:
            return cfg["mean"], cfg["std"], cfg["interpolation"], cfg["resize_mode"]
    n = model_name.lower()
    if "siglip" in n:
        return (0.5, 0.5, 0.5), (0.5, 0.5, 0.5), "bicubic", "squash"
    if "clipa" in n:
        return (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), "bilinear", "squash"
    return OPENAI_MEAN, OPENAI_STD, "bicubic", "shortest"


def center_crop_or_pad(x: np.ndarray, output_size, fill: float = 0.0) -> np.ndarray:
    """Center crop, padding first (split the difference) where the image is
    smaller than the crop along an edge; torchvision's round-half crop
    origin (rs_ov/factory.py:264-284)."""
    ch, cw = output_size
    h, w = x.shape[:2]
    if cw > w or ch > h:
        left = (cw - w) // 2 if cw > w else 0
        right = (cw - w + 1) // 2 if cw > w else 0
        top = (ch - h) // 2 if ch > h else 0
        bottom = (ch - h + 1) // 2 if ch > h else 0
        x = np.pad(x, ((top, bottom), (left, right)) + ((0, 0),) * (x.ndim - 2),
                   constant_values=fill)
        h, w = x.shape[:2]
        if cw == w and ch == h:
            return x
    top, left = int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0))
    return x[top:top + ch, left:left + cw]


def image_transform(image_size=224, is_train: bool = False, mean=None, std=None,
                    interpolation: str = "bicubic", resize_mode: str = "shortest",
                    fill_color: int = 0, aug_cfg=None):
    """HWC uint8 -> CHW float32 preprocessing closure (rs_ov/factory.py:287-366).

    Inference: resize the uint8 image with PIL, crop, normalise, in one of
    three modes: 'shortest' (the short side to the target; for a square
    target the long side is int(size * long / short), truncated, as
    torchvision's scalar Resize; then a center crop), 'longest' (fit the
    target box, then crop-or-pad with ``fill_color``), 'squash' (straight
    to (H, W)). Training (``is_train``): ``data.augment``'s transform.
    ``image_size`` is an int or an (H, W) pair."""
    size = tuple(image_size) if isinstance(image_size, (tuple, list)) \
        else (int(image_size), int(image_size))
    if is_train:
        from rs_ov_torch.data.augment import AugmentationCfg, build_train_transform

        if isinstance(aug_cfg, dict):
            aug_cfg = AugmentationCfg(**aug_cfg)
        if size[0] != size[1]:
            raise ValueError(f"the train transform takes a square target, got {size}")
        return build_train_transform(size[0], aug_cfg, mean=mean, std=std)
    if resize_mode not in ("shortest", "longest", "squash"):
        raise ValueError(f"Unknown resize_mode '{resize_mode}'")
    mean = np.asarray(mean if mean is not None else OPENAI_MEAN, np.float32)
    std = np.asarray(std if std is not None else OPENAI_STD, np.float32)

    def _resize(img, hw):
        from PIL import Image

        mode = Image.BILINEAR if interpolation == "bilinear" else Image.BICUBIC
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return np.asarray(Image.fromarray(img).resize(hw[::-1], mode))

    def transform(img_hwc):
        x = np.asarray(img_hwc)
        if x.ndim == 2:
            x = np.repeat(x[..., None], 3, axis=-1)
        h, w = x.shape[:2]
        th, tw = size
        if resize_mode == "squash":
            x = _resize(x, (th, tw))
        elif resize_mode == "longest":
            ratio = max(h / th, w / tw)
            x = center_crop_or_pad(_resize(x, (round(h / ratio), round(w / ratio))),
                                   (th, tw), fill=fill_color)
        else:
            if th == tw:
                short, long = (h, w) if h <= w else (w, h)
                ns, nl = th, int(th * long / short)
                x = _resize(x, (ns, nl) if h <= w else (nl, ns))
            else:
                ratio = min(h / th, w / tw)
                x = _resize(x, (round(h / ratio), round(w / ratio)))
            x = center_crop_or_pad(x, (th, tw))
        x = (x.astype(np.float32) / 255.0).transpose(2, 0, 1)
        return (x - mean[:, None, None]) / std[:, None, None]

    return transform


@dataclasses.dataclass
class PreprocessCfg:
    """open_clip's preprocess config (rs_ov/factory.py:369-378)."""
    size: int | tuple = 224
    mode: str = "RGB"
    mean: tuple = OPENAI_MEAN
    std: tuple = OPENAI_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0


def image_transform_v2(cfg: PreprocessCfg, is_train: bool, aug_cfg=None):
    """``image_transform`` with a config object."""
    return image_transform(image_size=cfg.size, is_train=is_train, mean=cfg.mean, std=cfg.std,
                           interpolation=cfg.interpolation, resize_mode=cfg.resize_mode,
                           fill_color=cfg.fill_color, aug_cfg=aug_cfg)


def _model_transform(model: CLIPModel, model_name: str, pretrained):
    tag = pretrained if pretrained and not os.path.exists(str(pretrained)) else None
    mean, std, interp, mode = preprocess_style(model_name, tag)
    return image_transform(model.cfg.vision.image_size, mean=mean, std=std,
                           interpolation=interp, resize_mode=mode)


def create_model_and_transforms(model_name: str, pretrained: Optional[str] = None,
                                precision: str = "fp32", **kwargs):
    """(model, preprocess_train, preprocess_val); both transforms are the
    inference one, as in the JAX package."""
    model = create_model(model_name, pretrained, precision, **kwargs)
    preprocess = _model_transform(model, model_name, pretrained)
    return model, preprocess, preprocess


def create_model_from_pretrained(model_name: str, pretrained=None, precision: str = "fp32",
                                 return_transform: bool = True, **kwargs):
    """(model, preprocess), or the model alone."""
    model = create_model(model_name, pretrained, precision, **kwargs)
    if not return_transform:
        return model
    return model, _model_transform(model, model_name, pretrained)


def create_loss(args):
    """The training losses are not ported yet (ROADMAP queue 1 item 10)."""
    raise NotImplementedError("the training losses are not ported yet "
                              "(ROADMAP queue 1 item 10)")


def get_tokenizer(model_name: str = "", context_length: int | None = None,
                  local_tokenizer_path: str | None = None, **_ignored):
    """The tokenizer a model's config names (rs_ov/factory.py:433-461): with
    ``hf_tokenizer_name`` and 'canonicalize' cleaning SigLipTokenizer, with
    another ``hf_tokenizer_name`` HFTokenizer (``strip_sep_token`` from the
    config), else the BPE SimpleTokenizer. An HF tokenizer loads from
    ``local_tokenizer_path``, or from the HF name as a local path."""
    cfg = None
    if model_name:
        try:
            cfg = get_model_config(model_name)
        except (KeyError, NotImplementedError):
            cfg = None
    tcfg = getattr(cfg, "text", None)
    hf_name = getattr(tcfg, "hf_tokenizer_name", None)
    if hf_name:
        from rs_ov_torch.text.hf_tokenizers import HFTokenizer, SigLipTokenizer

        ctx = context_length or tcfg.context_length
        path = local_tokenizer_path or hf_name
        if tcfg.tokenizer_clean == "canonicalize":
            return SigLipTokenizer(path, context_length=ctx)
        return HFTokenizer(path, context_length=ctx, strip_sep_token=tcfg.strip_sep_token)
    return SimpleTokenizer(context_length=context_length
                           or getattr(tcfg, "context_length", None) or 77)
