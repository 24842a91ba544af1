"""codeqwen1.5-7b [dense]: 32L MHA (kv=32), QKV bias (qwen1.5 arch).
[hf:Qwen/CodeQwen1.5-7B; hf]

Port of ``src/repro/configs/codeqwen1_5_7b.py``."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, d_ff=13440, vocab=92416, qkv_bias=True,
        pos_emb="rope", subquadratic=False)


def smoke():
    return ModelConfig(
        name="codeqwen1.5-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, qkv_bias=True,
        pos_emb="rope", dtype="float32")
