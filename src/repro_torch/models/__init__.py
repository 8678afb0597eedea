"""Models of the port's training path: the decoder-only LMs, dense and MoE
(:mod:`repro_torch.models.transformer`), the GNN family
(:mod:`repro_torch.models.gnn`) with its neighbour sampler
(:mod:`repro_torch.models.sampler`), and the train-step factory
(:mod:`repro_torch.models.steps`)."""
