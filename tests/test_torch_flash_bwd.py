"""The bf16 flash backward's arithmetic and its wrapper's refusals, on the
CPU.

``csrc/flash_attention_bwd.cu`` runs every product on bf16 tensor-core
MMAs with fp32 accumulators; p and ds reach the second-stage products
(``pᵀ dO``, ``dsᵀ q``, ``ds k``) as bf16 values, in ``PARTS`` parts (each
the rounding of what the parts before leave).  ``emulate`` repeats that
arithmetic in fp32 torch: p = exp2(s·scale·log2 e − lse·log2 e) on the
live pairs, ds = p·(dp − D)·scale, p and ds cut into bf16 parts, the
products summed in fp32, each output rounded to bf16 once.  Two parts must
stay within ``BF16_RTOL`` = 2^-7 of max|plain| of ``attention_bwd_ref``
and of the reference's ``jax.vjp`` of ``flash_attention_xla`` (the bar
``chip_smoke.py`` and the card tests hold the kernel to) on small GQA
shapes: causal, non-causal, a continuation, rows with no live key and a
decode row.  One part (FlashAttention-2's single rounding) came within 6%
of that bar; ``PYTHONPATH=src:tests python tests/test_torch_flash_bwd.py``
prints both variants' errors at ``chip_smoke.py``'s backward shapes.

The wrapper: a bf16 q, k, v, out or dout off a 16-byte boundary raises
before anything is built or launched (meta tensors: no card needed).
"""
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_bwd)
from test_torch_attention import jax_vjp

BF16_RTOL = 2.0 ** -7
LOG2E = 1.4426950408889634
PARTS = 2          # csrc/flash_attention_bwd.cu's PARTS

# (B, Hq, Hkv, Sq, Sk, D, causal): GQA groups 1-4, causal and not, a
# continuation (Sq < Sk), rows with no live key (Sq > Sk), a decode row
CASES = [(2, 4, 2, 40, 40, 32, True), (1, 8, 2, 48, 48, 64, False),
         (2, 4, 1, 24, 56, 64, True), (1, 4, 2, 40, 24, 32, True),
         (1, 4, 4, 1, 33, 64, True), (1, 6, 2, 20, 36, 48, False)]


def bf16_inputs(shape, seed=0, dv=None):
    """q, k, v, dout as bf16 torch tensors from a numpy seed (v and dout
    with head dim ``dv``, default D)."""
    b, hq, hkv, sq, sk, d, _ = shape
    dv = dv or d
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            .to(torch.bfloat16)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
                      (b, hq, sq, dv))]


def bf16_parts(x: torch.Tensor, parts: int) -> torch.Tensor:
    """The sum of ``parts`` bf16 parts of fp32 ``x``, small parts first."""
    got, rest = [], x
    for _ in range(parts):
        got.append(rest.to(torch.bfloat16).float())
        rest = rest - got[-1]
    return sum(reversed(got))


def emulate(q, k, v, out, lse, dout, *, causal, scale=None, parts=PARTS):
    """dq, dk, dv in the bf16 kernel's arithmetic (see the module note)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, gf = q.float(), dout.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
    if causal:
        live = (torch.arange(sk)[None, :]
                <= torch.arange(sq)[:, None] + (sk - sq))
        p = torch.where(live, p, 0.0)
    delta = (gf * out.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * scale
    pb, dsb = bf16_parts(p, parts), bf16_parts(ds, parts)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", pb, gf)
    fold = (b, hkv, group, sk)
    return (dq.to(q.dtype), dk.reshape(*fold, d).sum(2).to(k.dtype),
            dv.reshape(*fold, v.shape[3]).sum(2).to(v.dtype))


def rel(got, want) -> float:
    want = want.float() if torch.is_tensor(want) else torch.tensor(
        np.asarray(want, np.float32))
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_two_bf16_parts_hold_the_bar_against_plain_and_jax(case):
    """The kernel's arithmetic (p and ds in two bf16 parts) against the
    plain backward on the same bf16 inputs and the reference's vjp on
    their fp32 values: dq, dk, dv within 2^-7 of each max; the rows with
    no live key get dq = 0 exactly."""
    causal = case[6]
    q, k, v, dout = bf16_inputs(case)
    out, lse = ref.attention_lse_ref(q, k, v, causal=causal)
    got = emulate(q, k, v, out, lse, dout, causal=causal)
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert rel(g, w) <= BF16_RTOL
    sq, sk = case[3], case[4]
    if causal and sq > sk:
        assert (got[0][:, :, :sq - sk] == 0).all()
        return
    f32 = [t.float().numpy() for t in (q, k, v, dout)]
    _, _, jax_grads = jax_vjp(*f32, causal)
    for g, w in zip(got, jax_grads):
        assert rel(g, w) <= BF16_RTOL


# (B, Hq, Hkv, Sq, Sk, D, causal, DV): MLA's (192, 128) causal, with GQA,
# a continuation and rows with no live key, non-causal; DV != D under
# (64, 64)
DV_CASES = [(1, 4, 4, 40, 40, 192, True, 128),
            (2, 4, 2, 24, 56, 192, True, 128),
            (1, 4, 4, 40, 24, 192, True, 128),
            (1, 2, 2, 33, 33, 192, False, 128),
            (2, 4, 4, 37, 37, 24, True, 16)]


@pytest.mark.parametrize("case", DV_CASES, ids=str)
def test_two_bf16_parts_hold_the_bar_with_vs_own_head_dim(case):
    """The same arithmetic with v's head dim apart from q's (the kernel's
    (192, 128) instantiation): within 2^-7 of max|plain| and of the
    reference's vjp."""
    *shape, dv = case
    causal = shape[6]
    q, k, v, dout = bf16_inputs(shape, seed=3, dv=dv)
    out, lse = ref.attention_lse_ref(q, k, v, causal=causal)
    got = emulate(q, k, v, out, lse, dout, causal=causal)
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert rel(g, w) <= BF16_RTOL
    if causal and shape[3] > shape[4]:
        assert (got[0][:, :, :shape[3] - shape[4]] == 0).all()
        return
    f32 = [t.float().numpy() for t in (q, k, v, dout)]
    _, _, jax_grads = jax_vjp(*f32, causal)
    for g, w in zip(got, jax_grads):
        assert rel(g, w) <= BF16_RTOL


def test_bf16_parts_are_exact_remainders():
    """Each part is the bf16 rounding of what the parts before leave, so
    two parts carry p to 2^-16 of itself where one carries 2^-8 (bf16's
    unit roundoff)."""
    x = torch.tensor(np.random.default_rng(1).random(4096),
                     dtype=torch.float32)
    one, two = bf16_parts(x, 1), bf16_parts(x, 2)
    assert ((one - x).abs() <= 2.0 ** -8 * x.abs()).all()
    assert ((two - x).abs() <= 2.0 ** -16 * x.abs()).all()
    assert ((two - x).abs().max() < (one - x).abs().max() / 64)


@pytest.mark.parametrize("bad_at", ["q", "k", "v", "out", "dout"])
def test_flash_bwd_bf16_refuses_misaligned_operands(bad_at):
    """bf16 tiles go through 16-byte copies: an operand whose base or a
    stride is off a 16-byte boundary raises before anything is built or
    launched, on a device tensor that is not the CPU's; nothing falls
    back to another kernel."""
    wide = torch.empty((1, 2, 8, 40), device="meta", dtype=torch.bfloat16)
    ok = wide[..., :32]                       # rows 80 bytes apart
    bad = {"q": wide[..., 1:33], "k": wide[..., 1:33], "v": wide[..., 1:33],
           "out": torch.empty((1, 2, 8, 36), device="meta",
                              dtype=torch.bfloat16)[..., :32],
           "dout": wide[..., 1:33]}[bad_at]
    ops = {name: (bad if name == bad_at else ok)
           for name in ("q", "k", "v", "out", "dout")}
    lse = torch.empty((1, 2, 8), device="meta", dtype=torch.float32)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match=f"bf16 {bad_at} must be 16-byte "
                                         "aligned"):
        flash_attention_bwd(ops["q"], ops["k"], ops["v"], ops["out"], lse,
                            ops["dout"])
    assert flash_attention_bwd.launches == before


def test_flash_bwd_bf16_refuses_a_head_dim_off_eight():
    """D % 8 != 0 in bf16 cannot be staged by 16-byte copies: it raises
    (the forward refuses it too, so the training path never meets it)."""
    t = torch.empty((1, 2, 8, 36), device="meta", dtype=torch.bfloat16)
    lse = torch.empty((1, 2, 8), device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="D % 8 == 0"):
        flash_attention_bwd(t, t, t, t, lse, t)


def test_flash_fn_takes_a_misaligned_bf16_dout_on_the_cpu():
    """On CPU tensors the plain backward takes any alignment: a dout one
    element past an aligned base gives the same grads as an aligned
    one."""
    case = (1, 4, 2, 16, 16, 32, True)
    q, k, v, g = bf16_inputs(case, seed=2)
    flat = torch.empty(g.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(g.shape)
    shifted.copy_(g)

    def grads(dout):
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        FlashAttentionFn.apply(*leaves, True, None).backward(dout)
        return [a.grad for a in leaves]

    for a, b in zip(grads(shifted), grads(g)):
        assert torch.equal(a, b)


def _by_kv_head(fn, q, k, v, out, lse, dout, causal, **kw):
    """``fn`` (emulate or the plain backward) one kv head at a time, to
    bound the CPU's memory at qwen3's 2048-token shape."""
    group = q.shape[1] // k.shape[1]
    res = [fn(q[:, i * group:(i + 1) * group], k[:, i:i + 1],
              v[:, i:i + 1], out[:, i * group:(i + 1) * group],
              lse[:, i * group:(i + 1) * group],
              dout[:, i * group:(i + 1) * group], causal=causal, **kw)
           for i in range(k.shape[1])]
    return [torch.cat(parts, 1) for parts in zip(*res)]


def main() -> None:
    """Both variants' largest error over dq, dk and dv against the plain
    backward at ``chip_smoke.py``'s backward shapes (bf16), seeds 0-5
    (qwen3's 2048-token shape: seed 0)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import FLASH_BWD_EDGES, QWEN_BWD_SHAPE, TRAIN_SHAPE
    torch.set_num_threads(4)
    for shape in (TRAIN_SHAPE, *FLASH_BWD_EDGES, QWEN_BWD_SHAPE):
        worst = {1: 0.0, 2: 0.0}
        for seed in range(1 if shape == QWEN_BWD_SHAPE else 6):
            q, k, v, dout = bf16_inputs(shape, seed)
            causal = shape[6]
            out, lse = ref.attention_lse_ref(q, k, v, causal=causal)
            want = _by_kv_head(ref.attention_bwd_ref, q, k, v, out, lse,
                               dout, causal)
            for parts in worst:
                got = _by_kv_head(emulate, q, k, v, out, lse, dout, causal,
                                  parts=parts)
                worst[parts] = max(worst[parts], *(
                    rel(g, w) for g, w in zip(got, want)))
        print(f"{shape}: one part {worst[1]:.3e}, two parts {worst[2]:.3e} "
              f"of max|plain| (bar {BF16_RTOL:.3e})", flush=True)


if __name__ == "__main__":
    main()
