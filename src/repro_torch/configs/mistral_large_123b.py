"""mistral-large-123b [dense]
[hf:mistralai/Mistral-Large-Instruct-2407].  88L d_model=12288 96H (GQA
kv=8) d_ff=28672 vocab=32768.  Full attention => long_500k skipped.
Optimizer state in bf16 (123B params)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv=8, d_ff=28672, vocab=32768, head_dim=128,
    opt_dtype="bfloat16",
)
