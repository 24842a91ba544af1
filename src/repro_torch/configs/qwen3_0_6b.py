"""qwen3-0.6b [dense]: 28L GQA kv=8, qk-norm, head_dim 128, tied.
[hf:Qwen/Qwen3-8B; hf]

Port of ``src/repro/configs/qwen3_0_6b.py``."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=3072, vocab=151936, head_dim=128,
        qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
        pos_emb="rope", subquadratic=False)


def smoke():
    return ModelConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, head_dim=32, qk_norm=True,
        tie_embeddings=True, pos_emb="rope", dtype="float32")
