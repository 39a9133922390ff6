"""rs_ov_torch — the PyTorch + CUDA port of rs_ov for one NVIDIA H100.

The JAX package ``rs_ov`` stays the reference; this package mirrors its
layout and function names:

  core/       model configs, parameter modules, random init, the weight bridge
              from rs_ov pytrees
  data/       the normalisation constants
  evalsuite/  the ``_base_``-merging config loader
  utils/      separable resize / pad ops
  nn/         layers, attention, the decontaminating ViT
  decontam/   similarity map, outlier suppression, global debias
  text/       BPE tokenizer, text transformer, prompt-ensemble classifier
  kernels/    the hand-written CUDA kernels' wrappers, their plain versions, the build
  upsample/   SimFeatUp jbu_one / jbu_stack, channel-first and channel-last
  pipeline/   tiler, post-processing, SegmentorEx
  csrc/       CUDA C++ sources (sm_90a)

It imports torch, never jax, and nothing of rs_ov: where it needs something
of a jax-free rs_ov module it keeps its own copy.
"""
