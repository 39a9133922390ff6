"""GEM user-level API (rs_ov/gem_api.py, the gem package surface).

``create_gem_model`` returns a ``GEMWrapper`` over a ``CLIPModel`` whose
``encode_image`` runs GEM's dual stream (``nn.gem.gem_vit_forward``) and
whose ``forward`` gives min-max normalised image-text heatmaps. It runs on
the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from rs_ov_torch.factory import OPENAI_MEAN, OPENAI_STD, CLIPModel, create_model, get_tokenizer
from rs_ov_torch.nn.gem import gem_vit_forward
from rs_ov_torch.text.encoder import text_forward
from rs_ov_torch.utils.resize import resize_bicubic, resize_bilinear

__all__ = ["GEMWrapper", "create_gem_model", "get_gem_img_transform", "visualize"]


@dataclasses.dataclass
class GEMWrapper:
    model: CLIPModel
    tokenizer: object
    depth: int = 7
    ss_attn_iter: int = 1
    ss_attn_temp: Optional[float] = None
    ignore_residual: bool = False

    def _image(self, image) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
        return x.to(self.model.device, self.model.dtype)

    @torch.no_grad()
    def encode_image(self, image) -> torch.Tensor:
        """[B, 3, H, W] -> GEM patch tokens [B, P, E]."""
        return gem_vit_forward(self.model.clip.visual, self._image(image),
                               self.model.cfg.vision, depth=self.depth,
                               ss_attn_iter=self.ss_attn_iter, ss_attn_temp=self.ss_attn_temp,
                               ignore_residual=self.ignore_residual,
                               quick_gelu_act=self.model.cfg.quick_gelu)

    @torch.no_grad()
    def encode_text(self, classnames: list[str]) -> torch.Tensor:
        """'a photo of a {}.' prompts -> normalised [Q, E]."""
        ids = torch.from_numpy(np.asarray(
            self.tokenizer([f"a photo of a {c}." for c in classnames]))).long()
        return text_forward(self.model.clip.text, ids.to(self.model.device),
                            self.model.cfg.text, quick_gelu_act=self.model.cfg.quick_gelu,
                            normalize=True)

    @staticmethod
    def min_max(logits: torch.Tensor) -> torch.Tensor:
        """Per-map min-max normalisation of [B, Q, H, W]."""
        flat = logits.reshape(*logits.shape[:2], -1)
        lo = flat.min(-1).values[:, :, None, None]
        hi = flat.max(-1).values[:, :, None, None]
        return (logits - lo) / (hi - lo)

    @torch.no_grad()
    def forward(self, image, classnames: list[str]) -> torch.Tensor:
        """Image-text heatmaps [B, Q, H, W] in fp32, min-max normalised."""
        image = self._image(image)
        feats = self.encode_image(image).float()
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        txt = self.encode_text(classnames).float()
        logits = torch.einsum("bpd,qd->bqp", feats, txt)
        patch = self.model.cfg.vision.patch_size
        h, w = image.shape[-2:]
        maps = logits.reshape(*logits.shape[:2], h // patch, w // patch)
        return self.min_max(resize_bilinear(maps, (h, w)))

    __call__ = forward


def create_gem_model(model_name: str, pretrained: Optional[str] = None, gem_depth: int = 7,
                     ss_attn_iter: int = 1, ss_attn_temp: Optional[float] = None,
                     precision: str = "fp32", device=None, ignore_residual: bool = False,
                     **kwargs) -> GEMWrapper:
    model = create_model(model_name, pretrained, precision, device=device, **kwargs)
    return GEMWrapper(model=model, tokenizer=get_tokenizer(model_name), depth=gem_depth,
                      ss_attn_iter=ss_attn_iter, ss_attn_temp=ss_attn_temp,
                      ignore_residual=ignore_residual)


def get_gem_img_transform(img_size=(448, 448), mean=None, std=None):
    """HWC uint8 -> CHW float32: bicubic resize of the [0, 1] image, then
    CLIP normalisation (host numpy, the resize through CPU torch)."""
    mean = np.asarray(mean or OPENAI_MEAN, np.float32)
    std = np.asarray(std or OPENAI_STD, np.float32)
    if isinstance(img_size, int):
        img_size = (img_size, img_size)

    def transform(img_hwc):
        x = torch.from_numpy(np.asarray(img_hwc).astype(np.float32).transpose(2, 0, 1) / 255.0)
        x = resize_bicubic(x, tuple(img_size)).numpy()
        return (x - mean[:, None, None]) / std[:, None, None]

    return transform


def visualize(image, text, logits, alpha: float = 0.6, save_path: str | None = None,
              show: bool = False):
    """Per-class JET heatmap overlays (rs_ov/gem_api.py:110-171).

    image: HWC uint8 array or PIL image, or a CHW CLIP-normalised float
    array (un-normalised here); logits: [Q, H, W] heatmaps (``forward``'s,
    batch dimension allowed). Returns the [H, W, 3] uint8 overlays;
    ``save_path`` (a directory, or a filename prefix) writes
    ``heatmap_{cls}.png`` per class; ``show`` displays them with matplotlib,
    imported here, where it is installed."""
    from rs_ov_torch.data.palette import confidence_heatmap

    logits = np.asarray(logits.float().cpu() if torch.is_tensor(logits) else logits,
                        np.float32)
    if logits.ndim > 3:
        logits = logits[0]
    h, w = logits.shape[-2:]
    img = np.asarray(getattr(image, "convert", lambda m: image)("RGB"))
    if img.ndim > 3:
        img = img[0]
    if img.ndim == 3 and img.shape[0] == 3 and img.dtype != np.uint8:
        mean, std = np.asarray(OPENAI_MEAN, np.float32), np.asarray(OPENAI_STD, np.float32)
        img = (np.clip(img * std[:, None, None] + mean[:, None, None], 0, 1)
               .transpose(1, 2, 0) * 255).astype(np.uint8)
    img = np.asarray(img, np.uint8)
    if img.shape[:2] != (h, w):
        img = resize_bilinear(torch.from_numpy(img.transpose(2, 0, 1).astype(np.float32)),
                              (h, w)).numpy().transpose(1, 2, 0).astype(np.uint8)
    overlays = []
    for q, cls_name in enumerate(text):
        viz = ((1 - alpha) * img + alpha * confidence_heatmap(logits[q])).astype(np.uint8)
        overlays.append(viz)
        if save_path is not None:
            from PIL import Image

            if os.path.isdir(save_path) or save_path.endswith(os.sep):
                os.makedirs(save_path, exist_ok=True)
                out = os.path.join(save_path, f"heatmap_{cls_name}.png")
            else:
                out = f"{save_path}heatmap_{cls_name}.png"
            Image.fromarray(viz).save(out)
        if show:
            try:
                import matplotlib.pyplot as plt

                plt.imshow(viz)
                plt.title(cls_name)
                plt.axis("off")
                plt.tight_layout()
                plt.show()
            except ImportError:
                pass
    return overlays
