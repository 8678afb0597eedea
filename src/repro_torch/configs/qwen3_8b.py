"""qwen3-8b [hf:Qwen/Qwen3-8B]: 36L d=4096 32H GQA(kv=8) ff=12288, qk_norm."""
from repro_torch.models.transformer import LMConfig
from .base import LMArch

CFG = LMConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, head_dim=128, qk_norm=True,
)
SPEC = LMArch(CFG)
