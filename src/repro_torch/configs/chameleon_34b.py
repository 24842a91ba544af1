"""chameleon-34b [vlm]: 48L early-fusion, qk-norm; VQ image tokens share the
65536 vocab. VQ frontend is a stub — ``input_specs`` feeds precomputed
patch-token embeddings. [arXiv:2405.09818; unverified]

Port of ``src/repro/configs/chameleon_34b.py``."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="chameleon-34b", n_layers=48, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True,
        pos_emb="rope", embed_inputs=False, subquadratic=False)


def smoke():
    return ModelConfig(
        name="chameleon-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True,
        pos_emb="rope", embed_inputs=False, dtype="float32")
