"""zamba2-2.7b [hybrid]: 54 Mamba2 backbone blocks + 2 alternating shared
GQA+MLP blocks applied every 6 backbone blocks. [arXiv:2411.15242; hf]

Port of ``src/repro/configs/zamba2_2_7b.py``."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config():
    return ModelConfig(
        name="zamba2-2.7b", n_layers=54, d_model=2560, n_heads=32,
        n_kv_heads=32, d_ff=10240, vocab=32000,
        block_pattern=("mamba2",) * 54,
        shared_attn_every=6, n_shared_blocks=2,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1),
        pos_emb="rope", subquadratic=True)


def smoke():
    return ModelConfig(
        name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256,
        block_pattern=("mamba2",) * 4,
        shared_attn_every=2, n_shared_blocks=2,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                      chunk=8),
        pos_emb="rope", subquadratic=True, dtype="float32")
