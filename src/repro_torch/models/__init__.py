"""Models of the port's training path: the dense decoder-only LM
(:mod:`repro_torch.models.transformer`) and the train-step factory
(:mod:`repro_torch.models.steps`)."""
