"""rs_ov_torch — the PyTorch + CUDA port of rs_ov for one NVIDIA H100.

The JAX package ``rs_ov`` stays the reference; this package mirrors its
layout and function names:

  factory     the open_clip entry: create_model(_and_transforms), CLIPModel,
              the transforms, get_tokenizer; open_clip.py is its facade
  gem_api     create_gem_model and the heatmaps (gem.py: the gem surface)
  hub         save_for_hub packaging; pretrained: the weights registry
  core/       model configs and the registry, parameter modules, random
              init, the weight bridge from rs_ov pytrees, checkpoints
  data/       the normalisation constants, decoding, the train transform
  evalsuite/  the ``_base_``-merging config loader
  utils/      separable resize / pad ops
  nn/         layers, the ten attention modes, the decontaminating ViT
  decontam/   similarity map, outlier suppression, global debias, CTD (DBSCAN),
              cross-tile fusion, SOM, layer fusion, self-attention enhancement
  text/       BPE and HF tokenizers, text transformer, prompt-ensemble
              classifier, zero-shot metadata
  kernels/    the hand-written CUDA kernels' wrappers, their plain versions, the build
  upsample/   SimFeatUp jbu_one / jbu_stack, channel-first and channel-last;
              the alternates resize_conv, ifa, carafe, sapa
  pipeline/   tiler, post-processing, SegmentorEx
  csrc/       CUDA C++ sources (sm_90a)

It imports torch, never jax, and nothing of rs_ov: where it needs something
of a jax-free rs_ov module it keeps its own copy.
"""
