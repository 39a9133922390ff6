"""Training (rs_ov/train/): the contrastive and captioning losses, the
optimiser pieces, the CLIP / SigLIP / CoCa steps, the loop with ``.npz``
checkpoints, and the BLIP retrieval and pretraining steps;
``python -m rs_ov_torch.train`` is the CLIP training CLI."""
