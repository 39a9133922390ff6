"""rs_ov_torch — the PyTorch + CUDA port of rs_ov for one NVIDIA H100.

The JAX package ``rs_ov`` stays the reference; this package mirrors its
layout and function names:

  core/      parameter modules, random init, the weight bridge from rs_ov pytrees
  utils/     separable resize / pad ops
  nn/        layers, attention, the decontaminating ViT
  decontam/  similarity map, outlier suppression, global debias
  text/      BPE tokenizer, text transformer, prompt-ensemble classifier
  kernels/   the hand-written CUDA kernels' wrappers, their plain versions, the build
  upsample/  SimFeatUp jbu_one (channel-last, classifier fused into the last stage)
  pipeline/  tiler, post-processing, SegmentorEx
  csrc/      CUDA C++ sources (sm_90a)

It imports torch and never jax; it uses only the jax-free rs_ov modules
(rs_ov.core.config, rs_ov.data.transforms, rs_ov.evalsuite.config).
"""
