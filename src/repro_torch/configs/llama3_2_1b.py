"""llama3.2-1b [dense]: 16L GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]

Port of ``src/repro/configs/llama3_2_1b.py``."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
        n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=64,
        tie_embeddings=True, rope_theta=500_000.0,
        pos_emb="rope", subquadratic=False)


def smoke():
    return ModelConfig(
        name="llama3.2-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=256, tie_embeddings=True,
        pos_emb="rope", dtype="float32")
