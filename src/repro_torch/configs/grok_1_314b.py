"""grok-1-314b [moe]: 64L GQA kv=8, 8 experts top-2.
[hf:xai-org/grok-1; unverified]

Port of ``src/repro/configs/grok_1_314b.py``."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config():
    return ModelConfig(
        name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=32768, vocab=131072,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768,
                      impl="a2a"),
        pos_emb="rope", subquadratic=False)


def smoke():
    return ModelConfig(
        name="grok-1-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, impl="dense"),
        pos_emb="rope", dtype="float32")
