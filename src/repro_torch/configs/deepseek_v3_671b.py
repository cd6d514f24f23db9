"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8
[arXiv:2412.19437].  61L d_model=7168 128H d_ff=2048/expert vocab=129280.
First 3 layers dense-FFN (paper); MTP head omitted (noted in DESIGN.md).
Pure full-softmax attention over the whole context => long_500k skipped.
Optimizer state in bf16 (671B params / 16GB HBM chips)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv=128, d_ff=18432, vocab=129280, head_dim=128,
    mla=True, q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
    v_head_dim=128,
    moe_experts=256, moe_top_k=8, moe_shared=1, moe_d_ff=2048,
    moe_dense_first=3, opt_dtype="bfloat16",
)
