"""mixtral-8x7b [arXiv:2401.04088; hf]: 32L d=4096 32H GQA(kv=8) MoE 8e top-2,
sliding-window attention (window 4096)."""
from repro_torch.models.transformer import LMConfig, MoEConfig
from .base import LMArch

CFG = LMConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
)
SPEC = LMArch(CFG)
