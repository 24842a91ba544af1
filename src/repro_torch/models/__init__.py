"""The LM framework's dense GQA models on PyTorch.

Port of ``src/repro/models`` (dense attention stages only):

  config.py       ModelConfig and its sub-configs (copied as they are)
  layers.py       dot, norms, rope, MLP, init
  attention.py    GQA: naive and flash (CUDA kernel) cores, decode
  transformer.py  init_lm, lm_forward, lm_prefill, lm_decode_step, caches
  weights.py      from_reference: the JAX package's weights carried across
"""
