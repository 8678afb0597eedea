"""yi-6b [arXiv:2403.04652; hf]: 32L d=4096 32H GQA(kv=4) ff=11008 (llama arch)."""
from repro_torch.models.transformer import LMConfig
from .base import LMArch

CFG = LMConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
)
SPEC = LMArch(CFG)
