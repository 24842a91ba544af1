"""The LM framework's dense GQA models on PyTorch.

Port of ``src/repro/models`` (dense attention stages only):

  config.py       ModelConfig and its sub-configs (copied as they are)
  layers.py       dot, norms, rope, MLP, init, causal_mask, cross_entropy
  attention.py    GQA: naive and flash (CUDA kernels, forward and
                  backward) cores, decode
  transformer.py  init_lm, lm_forward, lm_loss, lm_prefill,
                  lm_decode_step, caches
  weights.py      from_reference / to_reference and the AdamW state: the
                  JAX package's trees carried across
"""
