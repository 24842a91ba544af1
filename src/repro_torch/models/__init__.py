"""The LM framework's dense GQA and recurrent models on PyTorch.

Port of ``src/repro/models`` (dense attention stages, the recurrent
blocks and zamba2's shared blocks; not yet MoE or MLA):

  config.py       ModelConfig and its sub-configs (copied as they are)
  layers.py       dot, norms, rope, MLP, init, causal_mask, cross_entropy
  attention.py    GQA: naive and flash (CUDA kernels, forward and
                  backward) cores, decode
  ssm.py          Mamba2 (SSD), mLSTM and sLSTM: token loop, chunked
                  form and one-token step of each recurrence
  transformer.py  init_lm, lm_forward, lm_loss, lm_prefill,
                  lm_decode_step, caches (attention, recurrent and
                  shared-block stages)
  weights.py      from_reference / to_reference and the AdamW state: the
                  JAX package's trees carried across
"""
