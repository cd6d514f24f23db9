"""whisper-large-v3 [audio] — enc-dec, conv frontend stub
[arXiv:2212.04356].  32L (encoder AND decoder) d_model=1280 20H d_ff=5120
vocab=51866.  input_specs() supplies precomputed log-mel frame embeddings
(the conv1d stem is the assignment-mandated stub).  Decode shapes run (the
decoder self-attn caches + cross-attends to encoder states); long_500k is
out of the modality domain => skipped (DESIGN.md)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv=20, d_ff=5120, vocab=51866,
    enc_dec=True, frontend="audio_frames", rope_theta=0.0,
    mlp_kind="gelu", tie_embeddings=False,
)
