"""pna [arXiv:2004.05718]: 4L d_hidden=75, mean/max/min/std x id/amp/atten."""
from repro_torch.models.gnn import GNNConfig
from .base import GNNArch

CFG = GNNConfig(name="pna", arch="pna", n_layers=4, d_hidden=75,
                d_in=1433, n_out=7)
SPEC = GNNArch("pna", CFG)
