"""The LM framework's attention, mixture-of-experts and recurrent models
on PyTorch.

Port of ``src/repro/models`` (GQA and MLA attention stages with an MLP or
a mixture of experts, the recurrent blocks and zamba2's shared blocks):

  config.py       ModelConfig and its sub-configs (copied as they are)
  layers.py       dot, norms, rope, MLP, init, causal_mask, cross_entropy;
                  the sharding context (shard_axes, wsc, weight)
  attention.py    GQA and MLA: naive and flash (CUDA kernels, forward
                  and backward) cores, decode (MLA's absorbed in its
                  latent space)
  moe.py          top-k routing, the load-balancing loss, the dense
                  mixture of experts and the expert-parallel paths
  ssm.py          Mamba2 (SSD), mLSTM and sLSTM: token loop, chunked
                  form and one-token step of each recurrence
  transformer.py  init_lm, lm_forward, lm_loss, lm_prefill,
                  lm_decode_step, caches (GQA's K/V, MLA's ckv/kr,
                  recurrent and shared-block stages); the first three and
                  the decode step over a mesh
  weights.py      from_reference / to_reference and the AdamW state: the
                  JAX package's trees carried across
"""
