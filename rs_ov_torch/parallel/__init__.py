"""Multi-process training on ``torch.distributed`` (rs_ov/parallel/): the
("data", "model") mesh, the differentiable collectives the losses and the
tensor-parallel blocks need, and the CLIP parameters' tensor-parallel
placements."""
