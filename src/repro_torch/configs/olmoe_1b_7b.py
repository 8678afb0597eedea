"""olmoe-1b-7b [arXiv:2409.02060; hf]: 16L d=2048 16H GQA(kv=16) MoE 64e top-8."""
from repro_torch.models.transformer import LMConfig, MoEConfig
from .base import LMArch

CFG = LMConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
)
SPEC = LMArch(CFG)
