"""Carry an LM's weights across: the reference's ``init_lm`` tree as numpy
arrays -> the port's parameters.

It has no counterpart file in the reference; it plays for the LM what
``repro_torch/core/weights.py`` plays for a plan.  ``from_reference`` takes
the nested dict the JAX package's ``init_lm`` returns (stacked per stage,
converted to numpy) and returns the same tree of tensors on ``device``.
A missing or unknown key, or a shape that differs from what ``cfg``
implies (``param_shapes``), raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (_dense_ff, build_stages,
                                            check_supported)


def param_shapes(cfg) -> dict:
    """The parameter tree ``init_lm(cfg)`` builds, with shapes as leaves."""
    check_supported(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv, ff = cfg.n_heads * hd, cfg.n_kv_heads * hd, _dense_ff(cfg)
    tree = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        tree["head"] = (d, cfg.vocab)
    for si, (_, _, idxs) in enumerate(build_stages(cfg)):
        n = len(idxs)
        attn = {"wq": (n, d, hq), "wk": (n, d, hkv), "wv": (n, d, hkv),
                "wo": (n, hq, d)}
        if cfg.qkv_bias:
            attn.update(bq=(n, hq), bk=(n, hkv), bv=(n, hkv))
        if cfg.qk_norm:
            attn.update(q_norm=(n, hd), k_norm=(n, hd))
        mlp = {"wi": (n, d, ff), "wo": (n, ff, d)}
        if cfg.mlp_act == "swiglu":
            mlp["wg"] = (n, d, ff)
        tree[f"stage_{si}"] = {"norm1": (n, d), "attn": attn,
                               "norm2": (n, d), "mlp": mlp}
    return tree


def _convert(spec, tree, path, device, dtype):
    if isinstance(spec, tuple):
        arr = np.asarray(tree)
        if arr.shape != spec:
            raise ValueError(f"from_reference: {path} has shape {arr.shape}, "
                             f"expected {spec}")
        return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                           dtype=dtype)
    if not isinstance(tree, dict):
        raise ValueError(f"from_reference: {path} must be a dict")
    missing = sorted(set(spec) - set(tree))
    unknown = sorted(set(tree) - set(spec))
    if missing or unknown:
        raise KeyError(f"from_reference: at {path or '<root>'}: missing "
                       f"{missing}, unknown {unknown}")
    return {k: _convert(spec[k], tree[k], f"{path}/{k}", device, dtype)
            for k in spec}


def from_reference(cfg, tree: dict, *, device="cuda", dtype=None) -> dict:
    """The port's parameters from the reference's ``init_lm`` tree (numpy
    leaves, any float dtype), cast to ``dtype`` (default ``cfg.dtype``)."""
    return _convert(param_shapes(cfg), tree, "", device,
                    dtype or dtype_of(cfg.dtype))
