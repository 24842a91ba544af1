"""Carry an LM's weights and optimizer state across: the reference's trees
as numpy arrays <-> the port's tensors.

It has no counterpart file in the reference; it plays for the LM what
``repro_torch/core/weights.py`` plays for a plan.  ``from_reference`` takes
the nested dict the JAX package's ``init_lm`` returns (stacked per stage,
converted to numpy) and returns the same tree of tensors on ``device``;
``to_reference`` is its inverse.  ``opt_state_from_reference`` /
``opt_state_to_reference`` do the same for an AdamW state ``{"step", "m",
"v"}``, with fp32 moments or int8 ``QTensor``s (any object with ``codes``
and ``scale`` is taken for one).  A missing or unknown key, or a shape
that differs from what ``cfg`` implies (``param_shapes``), raises.  Leaves
take the model dtype, except the recurrent blocks' gate and decay leaves
the reference keeps in fp32 (``FP32_LEAVES``, ``param_dtypes``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (_dense_ff, build_stages,
                                            check_supported)
from repro_torch.train.optim import QBLOCK, QTensor


# Leaves the reference keeps in fp32 whatever the model dtype (its
# ``ssm.init_mamba2``, ``init_mlstm`` and ``init_slstm``), by block kind.
FP32_LEAVES = {"mamba2": ("A_log", "dt_bias", "D"), "mlstm": ("if_bias",),
               "slstm": ("bias",)}


def _mlp_shapes(cfg, n, ff):
    d = cfg.d_model
    mlp = {"wi": (n, d, ff), "wo": (n, ff, d)}
    if cfg.mlp_act == "swiglu":
        mlp["wg"] = (n, d, ff)
    return mlp


def _mla_shapes(cfg, n):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    return {"wdq": (n, d, m.q_lora_rank), "q_norm": (n, m.q_lora_rank),
            "wuq": (n, m.q_lora_rank,
                    H * (m.nope_head_dim + m.rope_head_dim)),
            "wdkv": (n, d, m.kv_lora_rank + m.rope_head_dim),
            "kv_norm": (n, m.kv_lora_rank),
            "wukv": (n, m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim)),
            "wo": (n, H * m.v_head_dim, d)}


def _moe_shapes(cfg, n):
    mo, d = cfg.moe, cfg.d_model
    E, ff = mo.n_experts, mo.d_ff_expert
    tree = {"router": (n, d, E), "wi": (n, E, d, ff), "wg": (n, E, d, ff),
            "wo": (n, E, ff, d)}
    if mo.n_shared:
        tree["shared"] = _mlp_shapes(cfg, n, ff * mo.n_shared)
    return tree


def _attn_shapes(cfg, n, ff, variant="mlp", mla=False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = {"wq": (n, d, hq), "wk": (n, d, hkv), "wv": (n, d, hkv),
            "wo": (n, hq, d)}
    if cfg.qkv_bias:
        attn.update(bq=(n, hq), bk=(n, hkv), bv=(n, hkv))
    if cfg.qk_norm:
        attn.update(q_norm=(n, hd), k_norm=(n, hd))
    tree = {"norm1": (n, d), "attn": _mla_shapes(cfg, n) if mla else attn,
            "norm2": (n, d)}
    if variant == "moe":
        tree["moe"] = _moe_shapes(cfg, n)
    else:
        tree["mlp"] = _mlp_shapes(cfg, n, ff)
    return tree


def _rec_body_shapes(cfg, kind, n):
    d = cfg.d_model
    if kind == "mamba2":
        s = cfg.ssm
        d_in = s.expand * d
        gN = s.n_groups * s.d_state
        nh = d_in // s.head_dim
        return {"in_proj": (n, d, 2 * d_in + 2 * gN + nh),
                "conv_w": (n, s.conv_width, d_in + 2 * gN),
                "conv_b": (n, d_in + 2 * gN), "A_log": (n, nh),
                "dt_bias": (n, nh), "D": (n, nh), "norm": (n, d_in),
                "out_proj": (n, d_in, d)}
    H = cfg.n_heads
    if kind == "mlstm":
        d_in = int(cfg.xlstm.proj_factor * d)
        return {"up": (n, d, 2 * d_in),
                "conv_w": (n, cfg.xlstm.conv_width, d_in),
                "conv_b": (n, d_in), "wq": (n, d_in, d_in),
                "wk": (n, d_in, d_in), "wv": (n, d_in, d_in),
                "wif": (n, d_in, 2 * H), "if_bias": (n, 2 * H),
                "skip": (n, d_in), "norm": (n, d_in), "down": (n, d_in, d)}
    hd = d // H
    return {"w": (n, d, 4 * d), "r": (n, H, hd, 4 * hd), "bias": (n, 4 * d),
            "norm": (n, d), "out": (n, d, d)}


def param_shapes(cfg) -> dict:
    """The parameter tree ``init_lm(cfg)`` builds, with shapes as leaves
    (``param_dtypes`` gives each leaf's dtype)."""
    check_supported(cfg)
    d = cfg.d_model
    tree = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        tree["head"] = (d, cfg.vocab)
    for si, (kind, variant, idxs) in enumerate(build_stages(cfg)):
        n = len(idxs)
        tree[f"stage_{si}"] = (
            _attn_shapes(cfg, n, _dense_ff(cfg), variant,
                         mla=cfg.attn_type == "mla") if kind == "attn"
            else {"norm": (n, d), "body": _rec_body_shapes(cfg, kind, n)})
    if cfg.shared_attn_every:
        tree["shared"] = _attn_shapes(cfg, cfg.n_shared_blocks, cfg.d_ff)
    return tree


def param_dtypes(cfg, dtype=None) -> dict:
    """``param_shapes``' tree with each leaf's dtype: ``dtype`` (default
    ``cfg.dtype``), except the recurrent blocks' ``FP32_LEAVES``."""
    dtype = dtype or dtype_of(cfg.dtype)
    shapes = param_shapes(cfg)
    tree = _map(lambda _: dtype, shapes)
    for si, (kind, _, _) in enumerate(build_stages(cfg)):
        for name in FP32_LEAVES.get(kind, ()):
            tree[f"stage_{si}"]["body"][name] = torch.float32
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _convert(spec, dtypes, tree, path, device):
    if isinstance(spec, tuple):
        arr = np.asarray(tree)
        if arr.shape != spec:
            raise ValueError(f"from_reference: {path} has shape {arr.shape}, "
                             f"expected {spec}")
        return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                           dtype=dtypes)
    if not isinstance(tree, dict):
        raise ValueError(f"from_reference: {path} must be a dict")
    missing = sorted(set(spec) - set(tree))
    unknown = sorted(set(tree) - set(spec))
    if missing or unknown:
        raise KeyError(f"from_reference: at {path or '<root>'}: missing "
                       f"{missing}, unknown {unknown}")
    return {k: _convert(spec[k], dtypes[k], tree[k], f"{path}/{k}", device)
            for k in spec}


def from_reference(cfg, tree: dict, *, device="cuda", dtype=None) -> dict:
    """The port's parameters from the reference's ``init_lm`` tree (numpy
    leaves, any float dtype), cast to ``dtype`` (default ``cfg.dtype``)
    but for the leaves the reference keeps in fp32 (``param_dtypes``)."""
    return _convert(param_shapes(cfg), param_dtypes(cfg, dtype), tree, "",
                    device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 widened to fp32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(_host(tree.codes), _host(tree.scale))
    return _host(tree)


def to_reference(params: dict) -> dict:
    """The port's parameters as the reference's tree of numpy arrays
    (fp32 as fp32, bf16 widened to fp32): the inverse of
    ``from_reference``."""
    return _to_numpy(params)


def opt_state_to_reference(state: dict) -> dict:
    """An AdamW state as numpy: ``step`` int32, ``m``/``v`` fp32 arrays or
    ``QTensor(codes int8, scale fp32)`` of numpy arrays."""
    return _to_numpy(state)


def _moment(spec, tree, path, device):
    if isinstance(spec, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"opt_state_from_reference: {path} must be a "
                             f"dict")
        missing = sorted(set(spec) - set(tree))
        unknown = sorted(set(tree) - set(spec))
        if missing or unknown:
            raise KeyError(f"opt_state_from_reference: at {path}: missing "
                           f"{missing}, unknown {unknown}")
        return {k: _moment(spec[k], tree[k], f"{path}/{k}", device)
                for k in spec}
    if hasattr(tree, "codes") and hasattr(tree, "scale"):
        codes, scale = np.asarray(tree.codes), np.asarray(tree.scale)
        last = -(-spec[-1] // QBLOCK)
        want = (spec[:-1] + (last * QBLOCK,), spec[:-1] + (last,))
        if (codes.shape, scale.shape) != want:
            raise ValueError(f"opt_state_from_reference: {path} has codes "
                             f"{codes.shape} and scale {scale.shape}, "
                             f"expected {want[0]} and {want[1]}")
        return QTensor(torch.from_numpy(codes.astype(np.int8)).to(device),
                       torch.from_numpy(scale.astype(np.float32)).to(device))
    arr = np.asarray(tree)
    if arr.shape != spec:
        raise ValueError(f"opt_state_from_reference: {path} has shape "
                         f"{arr.shape}, expected {spec}")
    return torch.from_numpy(arr.astype(np.float32)).to(device)


def opt_state_from_reference(cfg, state: dict, *, device="cuda") -> dict:
    """The port's AdamW state from the reference's ``{"step", "m", "v"}``
    (numpy leaves; int8 moments as objects with ``codes`` and ``scale``)."""
    spec = param_shapes(cfg)
    return {"step": torch.tensor(np.asarray(state["step"]),
                                 dtype=torch.int32, device=device),
            "m": _moment(spec, state["m"], "m", device),
            "v": _moment(spec, state["v"], "v", device)}
