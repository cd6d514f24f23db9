"""gemma3-27b [dense] — 5:1 local:global, 128k
[hf:google/gemma-3].  62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144.  62 layers = ten full (5 local + 1 global) groups + a
2-layer (1 local + 1 global) tail stage, keeping the published 5:1 ratio
and layer count (stage structure noted in DESIGN.md).  Local window 1024;
global layers are sparse (1-in-6) with the 500k KV sequence-sharded over
the mesh => runs long_500k."""
import dataclasses

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP, ArchConfig,
                                Stage, SubBlock)


@dataclasses.dataclass(frozen=True)
class Gemma3Config(ArchConfig):
    def stages(self):
        # 60 layers of (5 local + 1 global) + 2-layer tail (1 local + 1 global)
        main = Stage(tuple(SubBlock(ATTN_GLOBAL if i == 5 else ATTN_LOCAL, MLP)
                           for i in range(6)), 10)
        tail = Stage((SubBlock(ATTN_LOCAL, MLP), SubBlock(ATTN_GLOBAL, MLP)), 1)
        return [main, tail]


CONFIG = Gemma3Config(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv=16, d_ff=21504, vocab=262144, head_dim=128,
    attn_kind="local_global", window=1024, local_global_period=6,
    rope_theta=1e6, subquadratic=True,
)
