"""Optimizer of the port's training path: AdamW with warmup-cosine schedule
and global-norm clipping (:mod:`repro_torch.optimizer.adamw`), and gradient
compression hooks (:mod:`repro_torch.optimizer.compress`)."""
