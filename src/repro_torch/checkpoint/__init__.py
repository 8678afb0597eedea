"""Checkpoints of the port's training state (:mod:`repro_torch.checkpoint.ckpt`)."""
