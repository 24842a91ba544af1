"""xlstm-350m [ssm]: 24 blocks, sLSTM at {3, 11, 19}, mLSTM elsewhere
(7:1 ratio), post-up-projection style, no separate FFN (d_ff=0).
[arXiv:2405.04517; unverified]

Port of ``src/repro/configs/xlstm_350m.py``."""
from repro_torch.models.config import ModelConfig, XLSTMConfig

_SLSTM_AT = frozenset({3, 11, 19})


def _pattern(n):
    return tuple("slstm" if i in _SLSTM_AT else "mlstm" for i in range(n))


def config():
    return ModelConfig(
        name="xlstm-350m", n_layers=24, d_model=1024, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab=50304,
        block_pattern=_pattern(24),
        xlstm=XLSTMConfig(proj_factor=2.0, conv_width=4, chunk=128),
        pos_emb="none", subquadratic=True)


def smoke():
    return ModelConfig(
        name="xlstm-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab=256,
        block_pattern=("mlstm", "slstm", "mlstm", "mlstm"),
        xlstm=XLSTMConfig(proj_factor=2.0, conv_width=4, chunk=8),
        pos_emb="none", subquadratic=True, dtype="float32")
