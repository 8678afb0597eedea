"""internlm2-1.8b [arXiv:2403.17297; hf]: 24L d=2048 16H GQA(kv=8) ff=8192."""
from repro_torch.models.transformer import LMConfig
from .base import LMArch

CFG = LMConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92544, head_dim=128,
)
SPEC = LMArch(CFG)
