"""musicgen-medium [audio]: 48L decoder-only over EnCodec tokens, MHA,
sinusoidal positions. Modality frontend (EnCodec) is a stub —
``input_specs`` feeds precomputed frame embeddings. [arXiv:2306.05284; hf]

Port of ``src/repro/configs/musicgen_medium.py``."""
from repro_torch.models.config import ModelConfig


def config():
    return ModelConfig(
        name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
        n_kv_heads=24, d_ff=6144, vocab=2048, mlp_act="gelu",
        pos_emb="sinusoidal", embed_inputs=False, subquadratic=False)


def smoke():
    return ModelConfig(
        name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=64, mlp_act="gelu",
        pos_emb="sinusoidal", embed_inputs=False, dtype="float32")
