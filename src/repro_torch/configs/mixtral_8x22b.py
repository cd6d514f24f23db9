"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
Sliding-window attention bounds the decode cache => runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    attn_kind="swa", window=4096,
    moe_experts=8, moe_top_k=2, moe_d_ff=16384,
    subquadratic=True,
)
