"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].
12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  Block pattern: 1 sLSTM per 6
blocks (the xLSTM[7:1] ratio rounded to divide 12 layers; noted in
DESIGN.md).  Recurrent state => sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv=4, d_ff=0, vocab=50304, ssm_pattern=6,
    expand=2, subquadratic=True, remat=False, opt_dtype="float32",
    tie_embeddings=True,
)
