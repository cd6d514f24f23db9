"""Architecture configuration system.

An ArchConfig fully determines (a) the model (layers, mixers, FFN kinds,
decode caches), (b) the sharding rules, and (c) the TrafficModelSpec handed
to the workload generator.  Layer patterns are expressed as repeated
*stages*: each stage is a tuple of sub-blocks repeated ``repeat`` times over
parameters stacked along a leading layer axis.  A copy of the reference's
``repro/configs/base.py``; ``tests/test_torch_models.py`` holds every config
to the reference's field by field.
"""
from __future__ import annotations

import dataclasses

from repro_torch.workload.traffic import TrafficModelSpec

# mixer kinds
ATTN, ATTN_LOCAL, ATTN_GLOBAL, MAMBA, MLSTM, SLSTM = (
    "attn", "attn_local", "attn_global", "mamba", "mlstm", "slstm")
# ffn kinds
MLP, MOE, NONE = "mlp", "moe", "none"


@dataclasses.dataclass(frozen=True)
class SubBlock:
    mixer: str
    ffn: str


@dataclasses.dataclass(frozen=True)
class Stage:
    blocks: tuple[SubBlock, ...]
    repeat: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention pattern
    attn_kind: str = "full"      # full|swa|local_global
    window: int = 0
    local_global_period: int = 0  # every k-th layer is global (gemma3: 6)
    rope_theta: float = 1e4
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    moe_dense_first: int = 0     # first k layers use dense FFN (deepseek: 3)
    capacity_factor: float = 1.25
    # 'gather': sort+scatter dispatch (flops ∝ active experts; default).
    # 'einsum': GShard-style dense one-hot dispatch (kept as the §Perf
    # baseline — its [T,E,cap] tensors are catastrophic at DeepSeek scale).
    moe_dispatch: str = "gather"
    moe_a2a_dtype: str = ""      # "" | "float8_e4m3fn": quantised dispatch
                                 # (DeepSeek-V3-style fp8 all-to-all)
    # MLA (deepseek)
    mla: bool = False
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_head_dim: int = 128
    # hybrid / ssm
    hybrid_period: int = 0       # jamba: attn every 8th layer
    ssm_pattern: int = 0         # xlstm: sLSTM every k-th block
    d_state: int = 16
    conv_kernel: int = 4
    expand: int = 2
    # modality stubs
    frontend: str = ""           # "" | "vision_patches" | "audio_frames"
    n_patches: int = 576
    # enc-dec (whisper): n_layers applies to BOTH encoder and decoder
    enc_dec: bool = False
    mlp_kind: str = "swiglu"     # swiglu | gelu
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    opt_dtype: str = "float32"   # bf16 for >=100B params (HBM budget)
    remat: bool = True
    remat_policy: str = "full"   # full | save_moe (keep MoE outputs: no
                                 # recompute all-to-alls in the backward)
    loss_chunk: int = 512        # sequence chunking for the xent loss
    # sub-quadratic? (long_500k eligibility; see DESIGN.md skip table)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # ------------------------------------------------------------------ #
    def stages(self) -> list[Stage]:
        """Layer pattern as scan-able stages."""
        L = self.n_layers
        if self.family in ("dense", "vlm"):
            if self.attn_kind == "local_global" and self.local_global_period:
                p = self.local_global_period
                blocks = tuple(SubBlock(ATTN_GLOBAL if (i == p - 1) else ATTN_LOCAL,
                                        MLP) for i in range(p))
                assert L % p == 0, (self.name, L, p)
                return [Stage(blocks, L // p)]
            return [Stage((SubBlock(ATTN, MLP),), L)]
        if self.family == "moe":
            out = []
            if self.moe_dense_first:
                out.append(Stage((SubBlock(ATTN, MLP),), self.moe_dense_first))
            rest = L - self.moe_dense_first
            if self.moe_every == 1:
                out.append(Stage((SubBlock(ATTN, MOE),), rest))
            else:
                p = self.moe_every
                blocks = tuple(SubBlock(ATTN, MOE if (i % p == p - 1) else MLP)
                               for i in range(p))
                assert rest % p == 0
                out.append(Stage(blocks, rest // p))
            return out
        if self.family == "hybrid":
            p = self.hybrid_period                     # jamba: 8
            assert L % p == 0
            blocks = []
            for i in range(p):
                mixer = ATTN if i % p == p // 2 - 1 else MAMBA   # 1 attn : p-1 mamba
                ffn = MOE if (self.moe_experts and i % 2 == 1) else MLP
                blocks.append(SubBlock(mixer, ffn))
            return [Stage(tuple(blocks), L // p)]
        if self.family == "ssm":                       # xlstm
            p = self.ssm_pattern or 6
            assert L % p == 0
            blocks = tuple(SubBlock(SLSTM if i == p - 1 else MLSTM, NONE)
                           for i in range(p))
            return [Stage(blocks, L // p)]
        if self.family in ("encdec", "audio"):
            # decoder stages (self-attn + cross-attn handled by the encdec
            # model wrapper; here we describe the decoder stack)
            return [Stage((SubBlock(ATTN, MLP),), L)]
        raise ValueError(self.family)

    # ------------------------------------------------------------------ #
    def layer_windows(self) -> list[tuple[str, int]]:
        """Per-sub-block (mixer, window) for attention mixers (0 = full)."""
        out = []
        for st in self.stages():
            for b in st.blocks:
                if b.mixer == ATTN_LOCAL:
                    out.append((b.mixer, self.window))
                elif b.mixer in (ATTN, ATTN_GLOBAL):
                    out.append((b.mixer, self.window if self.attn_kind == "swa" else 0))
                else:
                    out.append((b.mixer, 0))
        return out

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        st = self.stages()
        period = max(len(s.blocks) for s in st)
        layers = period * max(1, 2 if self.family != "moe" else 1)
        if self.moe_dense_first:
            layers = max(layers, 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=layers if not self.moe_dense_first else 1 + 1,
            d_model=128,
            n_heads=4, n_kv=4 if self.enc_dec else (min(self.n_kv, 2) or 2),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            moe_experts=min(self.moe_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=128 if self.moe_experts else 0,
            moe_dense_first=1 if self.moe_dense_first else 0,
            q_lora=64, kv_lora=32, rope_dim=16, nope_dim=32, v_head_dim=32,
            window=min(self.window, 64) if self.window else 0,
            n_patches=16,
            dtype="float32", param_dtype="float32",
            remat=False, loss_chunk=64,
        )

    # ------------------------------------------------------------------ #
    def traffic_spec(self, params: float | None = None,
                     active: float | None = None) -> TrafficModelSpec:
        return TrafficModelSpec(
            name=self.name, n_layers=self.n_layers, d_model=self.d_model,
            d_ff=self.d_ff or self.moe_d_ff, vocab=self.vocab,
            params=params or 0.0, active_params=active or 0.0,
            moe_experts=self.moe_experts, moe_top_k=self.moe_top_k,
            moe_layer_every=self.moe_every,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture × input-shape) dry-run cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
