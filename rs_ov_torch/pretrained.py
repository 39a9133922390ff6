"""Pretrained-weights registry (rs_ov/pretrained.py): (model, tag) -> the
checkpoint's source and its preprocess style.

The JAX package's registry data (every open_clip entry, plus the RS-domain
checkpoints the segmentor wires by clip_type), its lookups, the cache-dir
precedence, the SHA-256 prefix check and the URL / HF dispatch. Nothing is
ever downloaded: ``_fetch`` raises with the URL, so a tag resolves only to a
file already staged in the cache. The preprocess fields (mean, std,
interpolation, resize mode) parameterise ``factory.image_transform``.
"""

from __future__ import annotations

import hashlib
import os
import warnings

__all__ = [
    "download_pretrained", "download_pretrained_from_hf",
    "download_pretrained_from_url", "expected_sha256_for_url",
    "get_pretrained_cfg", "get_pretrained_url", "is_pretrained_cfg",
    "list_pretrained", "list_pretrained_models_by_tag",
    "list_pretrained_tags_by_model", "resolve_cache_dir",
    "verify_sha256_prefix",
]

OPENAI_MEAN, OPENAI_STD = (0.48145466, 0.4578275, 0.40821073), \
    (0.26862954, 0.26130258, 0.27577711)
INCEPTION_MEAN = INCEPTION_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)

_STYLES = {
    # (mean, std, interpolation, resize_mode)
    None: (OPENAI_MEAN, OPENAI_STD, "bicubic", "shortest"),
    "siglip": (INCEPTION_MEAN, INCEPTION_STD, "bicubic", "squash"),
    "clipa": (IMAGENET_MEAN, IMAGENET_STD, "bilinear", "squash"),
    "squash": (OPENAI_MEAN, OPENAI_STD, "bicubic", "squash"),
    "inception": (INCEPTION_MEAN, INCEPTION_STD, "bicubic", "shortest"),
}


def _e(url: str = "", hf_hub: str = "", style: str | None = None) -> dict:
    mean, std, interp, resize = _STYLES[style]
    return {"url": url, "hf_hub": hf_hub, "mean": mean, "std": std,
            "interpolation": interp, "resize_mode": resize}


PRETRAINED: dict[str, dict[str, dict]] = {
    'RN50': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt'),
        'yfcc15m': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-yfcc15m-455df137.pt'),
        'cc12m': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-cc12m-f000538c.pt'),
    },
    'RN50-quickgelu': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt'),
        'yfcc15m': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-yfcc15m-455df137.pt'),
        'cc12m': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn50-quickgelu-cc12m-f000538c.pt'),
    },
    'RN101': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt'),
        'yfcc15m': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn101-quickgelu-yfcc15m-3e04b30e.pt'),
    },
    'RN101-quickgelu': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt'),
        'yfcc15m': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/rn101-quickgelu-yfcc15m-3e04b30e.pt'),
    },
    'RN50x4': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt'),
    },
    'RN50x16': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt'),
    },
    'RN50x64': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt'),
    },
    'ViT-B-32': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt'),
        'laion400m_e31': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt'),
        'laion400m_e32': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e32-46683a32.pt'),
        'laion2b_e16': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-laion2b_e16-af8dbd0c.pth'),
        'laion2b_s34b_b79k': _e(hf_hub='laion/CLIP-ViT-B-32-laion2B-s34B-b79K/'),
        'datacomp_xl_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K/'),
        'datacomp_m_s128m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-DataComp.M-s128M-b4K/'),
        'commonpool_m_clip_s128m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.M.clip-s128M-b4K/'),
        'commonpool_m_laion_s128m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.M.laion-s128M-b4K/'),
        'commonpool_m_image_s128m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.M.image-s128M-b4K/'),
        'commonpool_m_text_s128m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.M.text-s128M-b4K/'),
        'commonpool_m_basic_s128m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.M.basic-s128M-b4K/'),
        'commonpool_m_s128m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.M-s128M-b4K/'),
        'datacomp_s_s13m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-DataComp.S-s13M-b4K/'),
        'commonpool_s_clip_s13m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.S.clip-s13M-b4K/'),
        'commonpool_s_laion_s13m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.S.laion-s13M-b4K/'),
        'commonpool_s_image_s13m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.S.image-s13M-b4K/'),
        'commonpool_s_text_s13m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.S.text-s13M-b4K/'),
        'commonpool_s_basic_s13m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.S.basic-s13M-b4K/'),
        'commonpool_s_s13m_b4k': _e(hf_hub='laion/CLIP-ViT-B-32-CommonPool.S-s13M-b4K/'),
    },
    'ViT-B-32-256': {
        'datacomp_s34b_b86k': _e(hf_hub='laion/CLIP-ViT-B-32-256x256-DataComp-s34B-b86K/'),
    },
    'ViT-B-32-quickgelu': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt'),
        'laion400m_e31': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e31-d867053b.pt'),
        'laion400m_e32': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_32-quickgelu-laion400m_e32-46683a32.pt'),
        'metaclip_400m': _e(url='https://dl.fbaipublicfiles.com/MMPT/metaclip/b32_400m.pt'),
        'metaclip_fullcc': _e(url='https://dl.fbaipublicfiles.com/MMPT/metaclip/b32_fullcc2.5b.pt'),
    },
    'ViT-B-16': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt'),
        'laion400m_e31': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16-laion400m_e31-00efa78f.pt'),
        'laion400m_e32': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16-laion400m_e32-55e67d44.pt'),
        'laion2b_s34b_b88k': _e(hf_hub='laion/CLIP-ViT-B-16-laion2B-s34B-b88K/'),
        'datacomp_xl_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-B-16-DataComp.XL-s13B-b90K/'),
        'datacomp_l_s1b_b8k': _e(hf_hub='laion/CLIP-ViT-B-16-DataComp.L-s1B-b8K/'),
        'commonpool_l_clip_s1b_b8k': _e(hf_hub='laion/CLIP-ViT-B-16-CommonPool.L.clip-s1B-b8K/'),
        'commonpool_l_laion_s1b_b8k': _e(hf_hub='laion/CLIP-ViT-B-16-CommonPool.L.laion-s1B-b8K/'),
        'commonpool_l_image_s1b_b8k': _e(hf_hub='laion/CLIP-ViT-B-16-CommonPool.L.image-s1B-b8K/'),
        'commonpool_l_text_s1b_b8k': _e(hf_hub='laion/CLIP-ViT-B-16-CommonPool.L.text-s1B-b8K/'),
        'commonpool_l_basic_s1b_b8k': _e(hf_hub='laion/CLIP-ViT-B-16-CommonPool.L.basic-s1B-b8K/'),
        'commonpool_l_s1b_b8k': _e(hf_hub='laion/CLIP-ViT-B-16-CommonPool.L-s1B-b8K/'),
        'dfn2b': _e(hf_hub='apple/DFN2B-CLIP-ViT-B-16/'),
    },
    'ViT-B-16-quickgelu': {
        'metaclip_400m': _e(url='https://dl.fbaipublicfiles.com/MMPT/metaclip/b16_400m.pt'),
        'metaclip_fullcc': _e(url='https://dl.fbaipublicfiles.com/MMPT/metaclip/b16_fullcc2.5b.pt'),
    },
    'ViT-B-16-plus-240': {
        'laion400m_e31': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16_plus_240-laion400m_e31-8fb26589.pt'),
        'laion400m_e32': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_b_16_plus_240-laion400m_e32-699c4b84.pt'),
    },
    'ViT-L-14': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt'),
        'laion400m_e31': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_l_14-laion400m_e31-69988bb6.pt'),
        'laion400m_e32': _e(url='https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/vit_l_14-laion400m_e32-3d133497.pt'),
        'laion2b_s32b_b82k': _e(hf_hub='laion/CLIP-ViT-L-14-laion2B-s32B-b82K/', style='inception'),
        'datacomp_xl_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K/'),
        'commonpool_xl_clip_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-L-14-CommonPool.XL.clip-s13B-b90K/'),
        'commonpool_xl_laion_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-L-14-CommonPool.XL.laion-s13B-b90K/'),
        'commonpool_xl_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-L-14-CommonPool.XL-s13B-b90K/'),
    },
    'ViT-L-14-quickgelu': {
        'metaclip_400m': _e(url='https://dl.fbaipublicfiles.com/MMPT/metaclip/l14_400m.pt'),
        'metaclip_fullcc': _e(url='https://dl.fbaipublicfiles.com/MMPT/metaclip/l14_fullcc2.5b.pt'),
        'dfn2b': _e(hf_hub='apple/DFN2B-CLIP-ViT-L-14/'),
    },
    'ViT-L-14-336': {
        'openai': _e(url='https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt'),
    },
    'ViT-H-14': {
        'laion2b_s32b_b79k': _e(hf_hub='laion/CLIP-ViT-H-14-laion2B-s32B-b79K/'),
    },
    'ViT-H-14-quickgelu': {
        'metaclip_fullcc': _e(url='https://dl.fbaipublicfiles.com/MMPT/metaclip/h14_fullcc2.5b.pt'),
        'dfn5b': _e(hf_hub='apple/DFN5B-CLIP-ViT-H-14/', style='squash'),
    },
    'ViT-H-14-378-quickgelu': {
        'dfn5b': _e(hf_hub='apple/DFN5B-CLIP-ViT-H-14-378/', style='squash'),
    },
    'ViT-g-14': {
        'laion2b_s12b_b42k': _e(hf_hub='laion/CLIP-ViT-g-14-laion2B-s12B-b42K/'),
        'laion2b_s34b_b88k': _e(hf_hub='laion/CLIP-ViT-g-14-laion2B-s34B-b88K/'),
    },
    'ViT-bigG-14': {
        'laion2b_s39b_b160k': _e(hf_hub='laion/CLIP-ViT-bigG-14-laion2B-39B-b160k/'),
    },
    'roberta-ViT-B-32': {
        'laion2b_s12b_b32k': _e(hf_hub='laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k/'),
    },
    'xlm-roberta-base-ViT-B-32': {
        'laion5b_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k/'),
    },
    'xlm-roberta-large-ViT-H-14': {
        'frozen_laion5b_s13b_b90k': _e(hf_hub='laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k/'),
    },
    'convnext_base': {
        'laion400m_s13b_b51k': _e(hf_hub='laion/CLIP-convnext_base-laion400M-s13B-b51K/'),
    },
    'convnext_base_w': {
        'laion2b_s13b_b82k': _e(hf_hub='laion/CLIP-convnext_base_w-laion2B-s13B-b82K/'),
        'laion2b_s13b_b82k_augreg': _e(hf_hub='laion/CLIP-convnext_base_w-laion2B-s13B-b82K-augreg/'),
        'laion_aesthetic_s13b_b82k': _e(hf_hub='laion/CLIP-convnext_base_w-laion_aesthetic-s13B-b82K/'),
    },
    'convnext_base_w_320': {
        'laion_aesthetic_s13b_b82k': _e(hf_hub='laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K/'),
        'laion_aesthetic_s13b_b82k_augreg': _e(hf_hub='laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K-augreg/'),
    },
    'convnext_large_d': {
        'laion2b_s26b_b102k_augreg': _e(hf_hub='laion/CLIP-convnext_large_d.laion2B-s26B-b102K-augreg/'),
    },
    'convnext_large_d_320': {
        'laion2b_s29b_b131k_ft': _e(hf_hub='laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft/'),
        'laion2b_s29b_b131k_ft_soup': _e(hf_hub='laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft-soup/'),
    },
    'convnext_xxlarge': {
        'laion2b_s34b_b82k_augreg': _e(hf_hub='laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg/'),
        'laion2b_s34b_b82k_augreg_rewind': _e(hf_hub='laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-rewind/'),
        'laion2b_s34b_b82k_augreg_soup': _e(hf_hub='laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-soup/'),
    },
    'coca_ViT-B-32': {
        'laion2b_s13b_b90k': _e(hf_hub='laion/CoCa-ViT-B-32-laion2B-s13B-b90k/'),
        'mscoco_finetuned_laion2b_s13b_b90k': _e(hf_hub='laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k/'),
    },
    'coca_ViT-L-14': {
        'laion2b_s13b_b90k': _e(hf_hub='laion/CoCa-ViT-L-14-laion2B-s13B-b90k/'),
        'mscoco_finetuned_laion2b_s13b_b90k': _e(hf_hub='laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k/'),
    },
    'EVA01-g-14': {
        'laion400m_s11b_b41k': _e(hf_hub='timm/eva_giant_patch14_clip_224.laion400m_s11b_b41k/'),
    },
    'EVA01-g-14-plus': {
        'merged2b_s11b_b114k': _e(hf_hub='timm/eva_giant_patch14_plus_clip_224.merged2b_s11b_b114k/'),
    },
    'EVA02-B-16': {
        'merged2b_s8b_b131k': _e(hf_hub='timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k/'),
    },
    'EVA02-L-14': {
        'merged2b_s4b_b131k': _e(hf_hub='timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k/'),
    },
    'EVA02-L-14-336': {
        'merged2b_s6b_b61k': _e(hf_hub='timm/eva02_large_patch14_clip_336.merged2b_s6b_b61k/'),
    },
    'EVA02-E-14': {
        'laion2b_s4b_b115k': _e(hf_hub='timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k/'),
    },
    'EVA02-E-14-plus': {
        'laion2b_s9b_b144k': _e(hf_hub='timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k/'),
    },
    'ViT-B-16-SigLIP': {
        'webli': _e(hf_hub='timm/ViT-B-16-SigLIP/', style='siglip'),
    },
    'ViT-B-16-SigLIP-256': {
        'webli': _e(hf_hub='timm/ViT-B-16-SigLIP-256/', style='siglip'),
    },
    'ViT-B-16-SigLIP-i18n-256': {
        'webli': _e(hf_hub='timm/ViT-B-16-SigLIP-i18n-256/', style='siglip'),
    },
    'ViT-B-16-SigLIP-384': {
        'webli': _e(hf_hub='timm/ViT-B-16-SigLIP-384/', style='siglip'),
    },
    'ViT-B-16-SigLIP-512': {
        'webli': _e(hf_hub='timm/ViT-B-16-SigLIP-512/', style='siglip'),
    },
    'ViT-L-16-SigLIP-256': {
        'webli': _e(hf_hub='timm/ViT-L-16-SigLIP-256/', style='siglip'),
    },
    'ViT-L-16-SigLIP-384': {
        'webli': _e(hf_hub='timm/ViT-L-16-SigLIP-384/', style='siglip'),
    },
    'ViT-SO400M-14-SigLIP': {
        'webli': _e(hf_hub='timm/ViT-SO400M-14-SigLIP/', style='siglip'),
    },
    'ViT-SO400M-14-SigLIP-384': {
        'webli': _e(hf_hub='timm/ViT-SO400M-14-SigLIP-384/', style='siglip'),
    },
    'ViT-L-14-CLIPA': {
        'datacomp1b': _e(hf_hub='UCSC-VLAA/ViT-L-14-CLIPA-datacomp1B/', style='clipa'),
    },
    'ViT-L-14-CLIPA-336': {
        'datacomp1b': _e(hf_hub='UCSC-VLAA/ViT-L-14-CLIPA-336-datacomp1B/', style='clipa'),
    },
    'ViT-H-14-CLIPA': {
        'datacomp1b': _e(hf_hub='UCSC-VLAA/ViT-H-14-CLIPA-datacomp1B/', style='clipa'),
    },
    'ViT-H-14-CLIPA-336': {
        'laion2b': _e(hf_hub='UCSC-VLAA/ViT-H-14-CLIPA-336-laion2B/', style='clipa'),
        'datacomp1b': _e(hf_hub='UCSC-VLAA/ViT-H-14-CLIPA-336-datacomp1B/', style='clipa'),
    },
    'ViT-bigG-14-CLIPA': {
        'datacomp1b': _e(hf_hub='UCSC-VLAA/ViT-bigG-14-CLIPA-datacomp1B/', style='clipa'),
    },
    'ViT-bigG-14-CLIPA-336': {
        'datacomp1b': _e(hf_hub='UCSC-VLAA/ViT-bigG-14-CLIPA-336-datacomp1B/', style='clipa'),
    },
    'nllb-clip-base': {
        'v1': _e(hf_hub='visheratin/nllb-clip-base-oc/'),
    },
    'nllb-clip-large': {
        'v1': _e(hf_hub='visheratin/nllb-clip-large-oc/'),
    },
    'nllb-clip-base-siglip': {
        'v1': _e(hf_hub='visheratin/nllb-clip-base-siglip/', style='siglip'),
    },
    'nllb-clip-large-siglip': {
        'v1': _e(hf_hub='visheratin/nllb-clip-large-siglip/', style='siglip'),
    },
}

# RS-domain checkpoints the reference segmentor loads from local paths by
# clip_type (RemoteCLIP/GeoRSCLIP/BLIP; reference segmentor.py:69-112) —
# not part of the reference registry, listed only with include_rs=True.
RS_PRETRAINED: dict[str, dict[str, dict]] = {
    "ViT-B-32": {
        "remoteclip": _e(url="https://huggingface.co/chendelong/RemoteCLIP/resolve/main/RemoteCLIP-ViT-B-32.pt"),
        "georsclip": _e(url="https://huggingface.co/Zilun/GeoRSCLIP/resolve/main/ckpt/RS5M_ViT-B-32.pt"),
    },
    "ViT-L-14": {
        "remoteclip": _e(url="https://huggingface.co/chendelong/RemoteCLIP/resolve/main/RemoteCLIP-ViT-L-14.pt"),
        "georsclip": _e(url="https://huggingface.co/Zilun/GeoRSCLIP/resolve/main/ckpt/RS5M_ViT-L-14.pt"),
    },
    "ViT-H-14": {
        "georsclip": _e(url="https://huggingface.co/Zilun/GeoRSCLIP/resolve/main/ckpt/RS5M_ViT-H-14.pt"),
    },
    "blip-base": {
        "model_base_14M": _e(url="https://storage.googleapis.com/sfr-vision-language-research/BLIP/models/model_base_14M.pth"),
    },
    "blip-large": {
        "model_large": _e(url="https://storage.googleapis.com/sfr-vision-language-research/BLIP/models/model_large.pth"),
    },
}


def _lookup(model: str, tag: str) -> dict | None:
    model = model.replace("/", "-")
    tag = tag.lower().replace("-", "_")
    for table in (PRETRAINED, RS_PRETRAINED):
        cfg = table.get(model, {}).get(tag)
        if cfg is not None:
            return cfg
    return None


def get_pretrained_cfg(model: str, tag: str) -> dict:
    """(reference pretrained.py:480-485)"""
    return dict(_lookup(model, tag) or {})


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return _lookup(model, tag) is not None


def get_pretrained_url(model: str, tag: str) -> str:
    cfg = _lookup(model, tag)
    return (cfg or {}).get("url", "")


def list_pretrained(as_str: bool = False, include_rs: bool = False):
    """All (model, tag) pairs — reference-registry parity by default
    (reference pretrained.py:449-454)."""
    tables = [PRETRAINED] + ([RS_PRETRAINED] if include_rs else [])
    pairs = [(m, t) for table in tables for m in table for t in table[m]]
    return [f"{m}_{t}" for m, t in pairs] if as_str else pairs


def list_pretrained_models_by_tag(tag: str) -> list[str]:
    tag = tag.lower().replace("-", "_")
    return [m for m in PRETRAINED if tag in PRETRAINED[m]]


def list_pretrained_tags_by_model(model: str) -> list[str]:
    return list(PRETRAINED.get(model.replace("/", "-"), {}))


# --- checkpoint cache: resolution + SHA-256 verification -------------------
#
# A flat cache dir keyed by URL basename, with a SHA-256-prefix check for the
# two distributor URL schemes that embed a hash. The one network call is
# isolated in `_fetch`, which raises with the canonical URL so the caller can
# stage the file into the cache dir by hand.

HF_WEIGHTS_NAME = "open_clip_pytorch_model.bin"


def resolve_cache_dir(cache_dir: str | None = None) -> str:
    """Cache-dir precedence: explicit arg > $RS_OV_CACHE_DIR > ~/.cache/clip
    (the reference's default, so a cache populated by the reference is
    found as-is — reference pretrained.py:512-513)."""
    if not cache_dir:
        cache_dir = os.environ.get("RS_OV_CACHE_DIR") or os.path.expanduser(
            os.path.join("~", ".cache", "clip"))
    return cache_dir


def expected_sha256_for_url(url: str) -> str:
    """SHA-256 prefix embedded in a distributor URL, '' if none.

    openaipublic URLs carry the full hash as the parent path segment;
    mlfoundations release assets carry an 8-hex prefix as the filename's
    final '-' suffix (reference pretrained.py:517-522).
    """
    filename = os.path.basename(url)
    if "openaipublic" in url:
        return url.split("/")[-2]
    if "mlfoundations" in url:
        return os.path.splitext(filename)[0].split("-")[-1]
    return ""


def verify_sha256_prefix(path: str, expected: str) -> bool:
    """True iff sha256(file) starts with `expected` (chunked; checkpoints
    are GB-scale). Empty `expected` verifies trivially."""
    if not expected:
        return True
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest().startswith(expected)


def _fetch(url: str, target: str) -> None:
    """The one network call: refused, nothing is downloaded."""
    raise RuntimeError(
        f"No implicit downloads: cannot fetch {url}. Fetch it "
        f"elsewhere and place it at {target} (or pass a local path as "
        f"`pretrained`).")


def download_pretrained_from_url(url: str,
                                 cache_dir: str | None = None) -> str:
    """Resolve `url` to a verified local file in the cache, fetching on
    miss/corruption (reference pretrained.py:508-560)."""
    cache_dir = resolve_cache_dir(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    expected = expected_sha256_for_url(url)
    target = os.path.join(cache_dir, os.path.basename(url))

    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if verify_sha256_prefix(target, expected):
            return target
        warnings.warn(f"{target} exists but its SHA-256 does not start with "
                      f"{expected}; re-downloading")

    _fetch(url, target)
    if not verify_sha256_prefix(target, expected):
        raise RuntimeError(
            f"downloaded {target} but its SHA-256 does not match {expected}")
    return target


def download_pretrained_from_hf(model_id: str,
                                filename: str = HF_WEIGHTS_NAME,
                                revision: str | None = None,
                                cache_dir: str | None = None) -> str:
    """Resolve an HF-hub artifact. Offline: found iff already staged at
    <cache>/<org>/<model>/<filename> (reference pretrained.py:570-578 goes
    through hf_hub_download; the staging layout here is the repo-id path)."""
    cache_dir = resolve_cache_dir(cache_dir)
    target = os.path.join(cache_dir, *model_id.split("/"), filename)
    if os.path.isfile(target):
        return target
    _fetch(f"https://huggingface.co/{model_id}/resolve/"
           f"{revision or 'main'}/{filename}", target)
    return target


def download_pretrained(cfg: dict, force_hf_hub: bool = False,
                        cache_dir: str | None = None) -> str:
    """Dispatch a registry entry to its source: URL wins unless
    `force_hf_hub`; an `hf_hub` value of 'org/model/' (trailing slash)
    means the default weights filename (reference pretrained.py:581-607)."""
    if not cfg:
        return ""
    url, hf_hub = cfg.get("url", ""), cfg.get("hf_hub", "")
    if hf_hub and force_hf_hub:
        url = ""
    if url:
        return download_pretrained_from_url(url, cache_dir=cache_dir)
    if hf_hub:
        model_id, filename = os.path.split(hf_hub)
        return download_pretrained_from_hf(
            model_id, filename=filename or HF_WEIGHTS_NAME,
            cache_dir=cache_dir)
    return ""
