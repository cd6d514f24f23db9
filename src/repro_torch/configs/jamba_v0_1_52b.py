"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Period-8 blocks: attention at index 3, Mamba elsewhere; MoE on odd layers.
Recurrent Mamba state + 1:7-minority attention => runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=65536,
    hybrid_period=8, moe_experts=16, moe_top_k=2, moe_d_ff=14336,
    d_state=16, conv_kernel=4, expand=2, subquadratic=True,
)
