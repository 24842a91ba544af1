"""Model configuration for the LM-family architecture pool.

Port of ``src/repro/models/config.py``, copied as it is: the dataclasses
are plain stdlib and ``params_count`` sizes the weights and the bounds.
One frozen dataclass covers dense GQA transformers, MLA, MoE, SSM (Mamba2),
xLSTM and hybrid block patterns; the port runs the dense GQA, Mamba2,
xLSTM and shared-block ones (``repro_torch/configs``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # shared (always-on) experts
    first_dense_layers: int = 0    # leading layers with dense MLP
    d_ff_dense: int = 0            # their width (deepseek: 18432)
    router: Literal["softmax", "sigmoid"] = "softmax"
    capacity_factor: float = 1.25
    impl: Literal["a2a", "dense"] = "a2a"   # Step-4: SpDMM vs DDMM mapping


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128               # SSD chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0       # mLSTM up-projection
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # block pattern: tuple of {"attn","mamba2","mlstm","slstm"}, len n_layers.
    # None -> all "attn".
    block_pattern: tuple[str, ...] | None = None
    # zamba2-style shared transformer blocks applied every N backbone blocks
    shared_attn_every: int = 0
    n_shared_blocks: int = 2
    # attention
    attn_type: Literal["gqa", "mla"] = "gqa"
    qk_norm: bool = False
    qkv_bias: bool = False
    pos_emb: Literal["rope", "sinusoidal", "none"] = "rope"
    rope_theta: float = 10_000.0
    # mlp
    mlp_act: Literal["swiglu", "gelu"] = "swiglu"
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    # embeddings / head
    tie_embeddings: bool = False
    embed_inputs: bool = True      # False: frontend stub feeds embeddings
    # training extras
    mtp_depth: int = 0             # deepseek multi-token prediction heads
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # long-context capability (drives the long_500k cell)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> tuple[str, ...]:
        return self.block_pattern or ("attn",) * self.n_layers

    def params_count(self) -> float:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        n = 0.0
        n += v * d * (1 if self.tie_embeddings else 2)
        attn_idx = 0
        for kind in self.pattern:
            if kind == "attn":
                if (self.moe is not None
                        and attn_idx < self.moe.first_dense_layers):
                    ff = self.moe.d_ff_dense or self.d_ff
                    mlp = d * ff * (3 if self.mlp_act == "swiglu" else 2)
                else:
                    mlp = self._mlp_params(full=False)
                n += self._attn_params(d, hd) + mlp
                attn_idx += 1
            elif kind == "mamba2":
                s = self.ssm
                d_in = s.expand * d
                conv_ch = d_in + 2 * s.n_groups * s.d_state
                nheads = d_in // s.head_dim
                n += (d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
                      + conv_ch * s.conv_width + 3 * nheads + d_in
                      + d_in * d + 2 * d)
            elif kind in ("mlstm", "slstm"):
                x = self.xlstm
                d_in = int(x.proj_factor * d) if kind == "mlstm" else d
                if kind == "mlstm":
                    n += d * 2 * d_in + 3 * d_in * d_in + 3 * d_in \
                        + d_in * d + 2 * d
                else:
                    n += 8 * d * d + 4 * d + d * d + 2 * d
        if self.shared_attn_every:
            n += self.n_shared_blocks * (
                self._attn_params(d, hd) + self._mlp_params(full=True))
        n += d  # final norm
        return n

    def _attn_params(self, d, hd):
        if self.attn_type == "mla":
            m = self.mla
            qh = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
            return (d * m.q_lora_rank + m.q_lora_rank * qh
                    + d * (m.kv_lora_rank + m.rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                    + m.q_lora_rank + m.kv_lora_rank + 2 * d)
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        return q * 2 + kv + 2 * d

    def _mlp_params(self, *, full: bool, layer_idx: int | None = None):
        d = self.d_model
        if self.moe is None or full:
            ff = self.d_ff
            return d * ff * (3 if self.mlp_act == "swiglu" else 2)
        mo = self.moe
        per = d * mo.d_ff_expert * 3
        return (mo.n_experts + mo.n_shared) * per + d * mo.n_experts

    def active_params_count(self) -> float:
        """Active (per-token) params — MoE counts only routed top-k."""
        if self.moe is None:
            return self.params_count()
        d = self.d_model
        mo = self.moe
        total = self.params_count()
        per = d * mo.d_ff_expert * 3
        n_moe_layers = sum(1 for i, k in enumerate(self.pattern)
                           if k == "attn" and i >= mo.first_dense_layers)
        inactive = n_moe_layers * (mo.n_experts - mo.top_k) * per
        return total - inactive
