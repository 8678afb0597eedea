"""gat-cora [arXiv:1710.10903]: 2L d_hidden=8 8 heads, attn aggregator."""
from repro_torch.models.gnn import GNNConfig
from .base import GNNArch

CFG = GNNConfig(name="gat-cora", arch="gat", n_layers=2, d_hidden=8,
                n_heads=8, d_in=1433, n_out=7)
SPEC = GNNArch("gat-cora", CFG)
