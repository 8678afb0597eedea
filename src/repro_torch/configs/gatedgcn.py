"""gatedgcn [arXiv:2003.00982]: 16L d_hidden=70, gated edge aggregation."""
from repro_torch.models.gnn import GNNConfig
from .base import GNNArch

CFG = GNNConfig(name="gatedgcn", arch="gatedgcn", n_layers=16, d_hidden=70,
                d_in=1433, n_out=7)
SPEC = GNNArch("gatedgcn", CFG)
