"""The sequence-sharded decode caches: ``init_caches(mesh=)``'s layout
against the reference's ``cache_specs``, and the split softmax a decode
step runs over the sequence blocks (``models/attention.py``).

The layout on a fake group of 256 ranks (``launch.mesh.init_fake_group``,
meta tensors, as the dry run places it): every ``k``, ``v``, ``ckv`` and
``kr`` leaf's local shape equals the reference's ``init_caches`` shape cut
by its ``cache_specs`` over the production (16, 16) mesh, for the ten
archs at ``decode_32k`` and the two sub-quadratic ones at ``long_500k``
(B = 1: the sequence over all 256 ranks).

The split softmax on one process, in fp32: each block's
``gqa_block_partial`` / ``mla_block_partial`` and their
``combine_blocks`` (the reductions over a stacked block axis in place of
the collectives) against ``naive_attention`` over the whole cache within
SPLIT_RTOL of max|out|, over 1, 2, 3 and 4 blocks, with per-row lengths,
a row whose keys lie in the first block only (the later blocks add
exactly zero, no NaN) and a row past the cache's end; the rows written
into the blocks (``_write_row``) against one cache's; and the kv heads
each model rank holds under an uneven head split gathered back to every
kv head once (the index ``_gather_heads`` reads).
"""
from __future__ import annotations

import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.models.transformer import init_caches as ref_init_caches
from repro_torch import configs
from repro_torch.launch.mesh import (destroy_process_group, init_fake_group,
                                     make_process_mesh, production_shape)
from repro_torch.models import attention as attn
from repro_torch.models.layers import shard_axes
from repro_torch.models.transformer import init_caches

SPLIT_RTOL = 1e-6
ATTN_LEAVES = ("k", "v", "ckv", "kr")
LAYOUT_CELLS = [(a, "decode_32k") for a in configs.ARCHS] + [
    ("zamba2-2.7b", "long_500k"), ("xlstm-350m", "long_500k")]


class Mesh16:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


def _ref_cut(arch, B, S):
    """The reference's cache leaves by path: each leaf's shape cut by its
    ``cache_specs`` over (16, 16)."""
    cs = jax.eval_shape(functools.partial(
        ref_init_caches, ref_configs.get(arch), B, S))
    specs = ref_shd.cache_specs(cs, Mesh16, dp=("data",), model="model")
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(cs),
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        out[key] = tuple(d // ref_shd._axsize(Mesh16, ax)
                         for d, ax in zip(leaf.shape, entries))
    return out


def _flat_shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{path}/{k}" if path else k))
        return out
    return {path: tuple(tree.shape)}


@pytest.mark.parametrize("arch,shape", LAYOUT_CELLS)
def test_attention_leaves_are_the_references_cache_specs_cut(arch, shape):
    sh = configs.SHAPES[shape]
    B, S = sh["global_batch"], sh["seq_len"]
    want = _ref_cut(arch, B, S)
    init_fake_group(256)
    try:
        mesh = make_process_mesh(*production_shape())
        got = _flat_shapes(init_caches(configs.get(arch), B, S,
                                       device="meta", mesh=mesh))
    finally:
        destroy_process_group()
    assert set(got) == set(want)
    leaves = [p for p in want if p.split("/")[-1] in ATTN_LEAVES]
    assert {p: got[p] for p in leaves} == {p: want[p] for p in leaves}
    if shape == "long_500k" and leaves:          # over all 256 ranks
        assert all(got[p][2] == S // 256 for p in leaves)
    assert bool(leaves) == (arch != "xlstm-350m")


# ---------------------------------------------------------- split softmax --
def _blocks(n_blocks, max_len):
    size = max_len // n_blocks
    return [(i * size, (i + 1) * size) for i in range(n_blocks)]


def _stacked(parts):
    """The blocks' ``(m, l, acc)`` stacked on a new leading axis, and
    ``combine_blocks``' reductions over it."""
    m, l, acc = (torch.stack(t) for t in zip(*parts))

    def pmax(t):
        return t.amax(0, keepdim=True).expand_as(t)

    def psum(t):
        return t.sum(0, keepdim=True).expand_as(t)

    return attn.combine_blocks(m, l, acc, pmax, psum)


# per-row lengths over a 12-position cache: the first block only, a
# middle block, every position, and a row past the end (its write
# dropped, every key live)
LENGTHS = (1, 7, 12, 13)


@pytest.mark.parametrize("n_blocks", (1, 2, 3, 4))
@pytest.mark.parametrize("heads", ((10, 2), (4, 4), (6, 1)),
                         ids=lambda h: f"{h[0]}q{h[1]}kv")
def test_gqa_split_softmax_matches_naive(n_blocks, heads):
    H, n_kv = heads
    hd, max_len = 8, 12
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((4, 1, H, hd), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, max_len, n_kv, hd),
                                                 np.float32) * 2)
            for _ in range(2))
    length = torch.tensor(LENGTHS)
    want = attn.naive_attention(q, k, v, causal=False, length=length)
    parts = [attn.gqa_block_partial(q, k[:, lo:hi], v[:, lo:hi], lo, length)
             for lo, hi in _blocks(n_blocks, max_len)]
    got = _stacked(parts)[0].reshape(4, 1, H, hd)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= SPLIT_RTOL * want.abs().max()
    # the first row's keys lie in the first block: the later blocks'
    # shares are exactly zero
    for m, l, acc in parts[1:]:
        assert (m[0] == attn.NEG).all() and (l[0] == 0).all()
        assert (acc[0] == 0).all()


@pytest.mark.parametrize("n_blocks", (1, 2, 3, 4))
def test_mla_split_softmax_matches_naive(n_blocks):
    """The latent-space scores ``q_abs·ckv + q_rope·kr`` and the context
    over ``ckv``: ``naive_attention`` with one kv head of ``[ckv, kr]``
    and values ``ckv``."""
    H, kv_lora, rope_d, qk_dim, max_len = 6, 16, 8, 24, 12
    rng = np.random.default_rng(1)
    q_abs = torch.from_numpy(rng.standard_normal((4, 1, H, kv_lora),
                                                 np.float32))
    q_rope = torch.from_numpy(rng.standard_normal((4, 1, H, rope_d),
                                                  np.float32))
    ckv = torch.from_numpy(rng.standard_normal((4, max_len, kv_lora),
                                               np.float32))
    kr = torch.from_numpy(rng.standard_normal((4, max_len, rope_d),
                                              np.float32))
    length = torch.tensor(LENGTHS)
    want = attn.naive_attention(
        torch.cat([q_abs, q_rope], -1),
        torch.cat([ckv, kr], -1)[:, :, None], ckv[:, :, None],
        causal=False, length=length, scale=1.0 / math.sqrt(qk_dim))
    parts = [attn.mla_block_partial(q_abs, q_rope, ckv[:, lo:hi],
                                    kr[:, lo:hi], lo, length, qk_dim)
             for lo, hi in _blocks(n_blocks, max_len)]
    got = _stacked(parts)[0].transpose(1, 2)        # (B, 1, H, kv_lora)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= SPLIT_RTOL * want.abs().max()


@pytest.mark.parametrize("n_blocks", (1, 2, 3, 4))
def test_rows_land_in_their_positions_block(n_blocks):
    """Each row's new entry goes to the block that holds its position;
    the blocks put together are the one cache written as before, the row
    at the cache's end dropped from all of them."""
    max_len = 12
    rng = np.random.default_rng(2)
    new = torch.from_numpy(rng.standard_normal((4, 3, 5), np.float32))
    pos = torch.tensor([0, 5, 11, 12])
    rows = torch.arange(4)
    whole = torch.zeros((4, max_len, 3, 5))
    attn._write_row(whole, rows, pos, new)
    blocks = []
    for lo, hi in _blocks(n_blocks, max_len):
        blk = torch.zeros((4, hi - lo, 3, 5))
        attn._write_row(blk, rows, pos, new, lo)
        blocks.append(blk)
    assert torch.equal(torch.cat(blocks, 1), whole)
    assert (whole[3] == 0).all()


class _ModelAxis:
    """A model axis of ``m`` ranks seen from rank ``k``: what
    ``shard_axes`` reads of a mesh."""

    def __init__(self, m, k):
        self.shape, self.k = {"model": m}, k

    def axis_index(self, axis):
        return self.k


@pytest.mark.parametrize("heads,m", [((10, 2), 4), ((8, 2), 4), ((8, 8), 2),
                                     ((2, 1), 4), ((12, 4), 4)],
                         ids=lambda c: str(c))
def test_uneven_head_split_gathers_each_head_once(heads, m):
    """Each model rank's q heads and the kv heads they read (``10`` q
    heads over 4 ranks split 3, 3, 2, 2 and cut both groups), padded and
    concatenated in rank order as the all-gather lays them: the index
    ``_gather_heads`` reads gives back every q head and every kv head in
    order, each from a rank that holds it."""
    H, n_kv = heads
    full_q = torch.arange(H, dtype=torch.float32).reshape(1, 1, H, 1)
    full_kv = torch.arange(n_kv, dtype=torch.float32).reshape(1, 1, n_kv, 1)
    q_parts, kv_parts = [], []
    for k in range(m):
        with shard_axes((), "model", _ModelAxis(m, k)):
            lo, hi, kv = attn.local_heads(H, n_kv)
            q_held = attn.head_shares(H)
            kv_held = attn._kv_held(H, n_kv)
        q_parts.append(full_q[:, :, lo:hi])
        kv_parts.append(full_kv[:, :, list(kv)])
    for parts, held, n, full in ((q_parts, [range(a, b) for a, b in q_held],
                                  H, full_q),
                                 (kv_parts, kv_held, n_kv, full_kv)):
        width = max(len(h) for h in held)
        assert [p.shape[2] for p in parts] == [len(h) for h in held]
        gathered = torch.cat([attn._pad_heads(p, width) for p in parts], 2)
        idx = attn._head_index(held, width, range(n))
        assert torch.equal(attn._select_heads(gathered, idx), full)
