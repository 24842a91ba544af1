"""deepseek-v3-671b [moe]: 61L MLA, 1 shared + 256 routed experts top-8,
first 3 layers dense (d_ff 18432), MTP optional. [arXiv:2412.19437; hf]

Port of ``src/repro/configs/deepseek_v3_671b.py``."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def config():
    return ModelConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, d_ff=18432, vocab=129280,
        attn_type="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                      first_dense_layers=3, d_ff_dense=18432,
                      router="sigmoid", impl="a2a"),
        pos_emb="rope", subquadratic=False)


def smoke():
    return ModelConfig(
        name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=192, vocab=256,
        attn_type="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                      first_dense_layers=1, d_ff_dense=192,
                      router="sigmoid", impl="a2a"),
        pos_emb="rope", dtype="float32")
