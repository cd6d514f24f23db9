"""llava-next-34b [vlm] — anyres tiling (stub frontend)
[hf:llava-hf/llava-v1.6].  60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.  input_specs() supplies precomputed patch embeddings (the
projector/vision tower is the assignment-mandated stub).  Full attention =>
long_500k skipped."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv=8, d_ff=20480, vocab=64000,
    frontend="vision_patches", n_patches=576,
)
