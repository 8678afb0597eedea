"""schnet [arXiv:1706.08566]: 3 interactions d=64 rbf=300 cutoff=10.
Non-geometric cells get synthesized positions (zeros unless the batch
carries them)."""
from repro_torch.models.gnn import GNNConfig
from .base import GNNArch

CFG = GNNConfig(name="schnet", arch="schnet", n_layers=3, d_hidden=64,
                n_rbf=300, cutoff=10.0, d_in=1, n_out=1)
SPEC = GNNArch("schnet", CFG)
