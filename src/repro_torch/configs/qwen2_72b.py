"""qwen2-72b [dense]: 80L GQA kv=8, QKV bias. [arXiv:2407.10671; hf]

Port of ``src/repro/configs/qwen2_72b.py``."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True,
        pos_emb="rope", subquadratic=False)


def smoke():
    return ModelConfig(
        name="qwen2-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=256, qkv_bias=True,
        pos_emb="rope", dtype="float32")
