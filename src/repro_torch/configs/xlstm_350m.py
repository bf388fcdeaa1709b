"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
d_ff=0: xLSTM blocks carry their own projections (mLSTM pf=2 up/down;
sLSTM a 4/3 GeGLU). Sub-quadratic (recurrent): runs long_500k."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm_pf=2,
    xlstm_conv=4,
    slstm_every=4,
    pos="none",
    rope_fraction=0.0,
    source="arXiv:2405.04517",
    verified="unverified",
)

SMOKE = CONFIG.replace(
    name="xlstm-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    vocab=256, slstm_every=2, dtype="float32",
)
