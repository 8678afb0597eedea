"""dcn-v2 [arXiv:2008.13535]: 13 dense + 26 sparse(embed 16), 3 cross layers,
MLP 1024-1024-512, full-rank cross interaction."""
from repro_torch.models.recsys import RecsysConfig
from .base import RecsysArch

CFG = RecsysConfig(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                   n_cross=3, mlp=(1024, 1024, 512))
SPEC = RecsysArch(CFG)
