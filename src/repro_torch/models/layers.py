"""Shared LM building blocks: norms, RoPE, dense MLP, init.

Port of ``src/repro/models/layers.py`` (``dot``, ``rms_norm``,
``head_rms_norm``, ``rope``, ``sinusoidal_pos``, ``mlp_apply``,
``causal_mask``, ``cross_entropy``, ``init_linear``, ``init_mlp``).
Parameters are plain nested dicts of tensors, stacked per stage on a
leading layer axis as in the reference (``transformer._init_stage``
stacks them, in place of the reference's ``stack_params``).  Norms and
the MLP's gate run in fp32 and cast back.

``dot`` returns fp32, as the reference's ``preferred_element_type``
does (float64 operands stay float64: ``wide``, the compute dtype of
norms, products and the recurrences, is fp32 or wider, so a float64 model
runs in float64 throughout, a check free of fp32 rounding).  bf16 operands
give the fp32 result of their product, unrounded, and their VJP is the
reference's: ``dx = bf16(g @ wᵀ)`` and ``dw = bf16(xᵀ @ g)`` with the fp32
cotangent ``g`` unrounded (``WideDot``).  On the card that is cuBLAS with
bf16 operands and an fp32 output (``torch.mm(out_dtype=)``), ``g`` split
into two bf16 parts (about 2^-16 of ``g`` left out, below the result's
own bf16 rounding); no weight is widened there.  On the CPU the operands
are widened, which is the reference's arithmetic.  fp32 and float64
operands take ``torch.matmul`` as they are.

``causal_mask`` and ``cross_entropy`` (the training loss) are ported as
they are.

The sharding context (``shard_axes``, ``wsc``; the reference's
role-based constraints).  ``lm_forward``, ``lm_loss`` and
``lm_decode_step`` given a mesh run their body under ``shard_axes(dp,
model, mesh)``, as the reference does.  There each rank holds local
tensors: the batch rows of its dp coordinate, everything else whole on
the model axis.  ``wsc(x, *roles)`` pins ``x``, held whole on the roles'
axes, to this rank's block of it (the reference constrains a global
array; here the layout change is the slice, differentiable); ``gather``
(``distributed.collectives``) undoes it.  Parameters are read through
``weight``: the leaf all-gathered on its sharded dims, or only this
model rank's block of a dim (``model_part``), the tensor-parallel split
of heads and of the MLP's hidden width.  A row-parallel product's
partial sums meet in ``psum_model``, and a norm over a dim split that way
adds its squares' sums there (``rms_norm_split``).  A scale already read
through ``weight`` goes to ``rms_norm_by`` (``rms_norm`` reads its leaf,
and a second read would count its grad twice).  Without the context every
one of these returns its input.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ------------------------------------------------------- sharding context --
@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The active mesh and the names of its dp axes and model axis."""
    mesh: object
    dp: tuple
    model: str

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model]

    @property
    def model_index(self) -> int:
        return self.mesh.axis_index(self.model)

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp)

    @property
    def dp_index(self) -> int:
        """This rank's place over the dp axes, outer axis first (the
        block ``wsc`` cuts)."""
        i = 0
        for a in self.dp:
            i = i * self.mesh.shape[a] + self.mesh.axis_index(a)
        return i


_AXES: contextvars.ContextVar = contextvars.ContextVar("shard_axes",
                                                       default=None)


@contextlib.contextmanager
def shard_axes(dp=("data",), model="model", mesh=None):
    """Activate the sharding context (module docstring) for the enclosed
    code; ``mesh=None`` turns it off (a rank's local computation)."""
    axes = None
    if mesh is not None:
        axes = MeshAxes(mesh, (dp,) if isinstance(dp, str) else tuple(dp),
                        model)
    token = _AXES.set(axes)
    try:
        yield axes
    finally:
        _AXES.reset(token)


def mesh_axes_active() -> MeshAxes | None:
    """The active ``MeshAxes``, or None."""
    return _AXES.get()


def _role_axes(ax: MeshAxes, role: str) -> tuple:
    axes = ()
    if "dp" in role:
        axes += ax.dp
    if "model" in role:
        axes += (ax.model,)
    return axes


def wsc(x, *roles):
    """Pin ``x`` by role: each entry is None, "dp", "model" or
    "dp+model"; ``x``, held whole on those axes, becomes this rank's block
    of each such dim (a view; its grad is padded with zeros).  A dim that
    does not divide over its axes stays whole, as the reference leaves it
    unconstrained.  Without a mesh context it returns ``x``."""
    ax = _AXES.get()
    if ax is None:
        return x
    for dim, role in enumerate(roles):
        if role is None:
            continue
        axes = _role_axes(ax, role)
        if x.shape[dim] % math.prod(ax.mesh.shape[a] for a in axes) == 0:
            x = collectives.take_block(x, ax.mesh, dim, axes)
    return x


def model_part(n: int) -> tuple[int, int]:
    """This model rank's share ``[lo, hi)`` of ``n`` items (heads, hidden
    units): contiguous, the first ``n % size`` ranks one more; all of
    them without a mesh context."""
    ax = _AXES.get()
    if ax is None:
        return 0, n
    return _share(n, ax.model_size, ax.model_index)


def _share(n: int, m: int, k: int) -> tuple[int, int]:
    """Rank ``k``'s share of ``n`` items over ``m`` ranks (``model_part``)."""
    base, extra = divmod(n, m)
    lo = k * base + min(k, extra)
    return lo, lo + base + (k < extra)


def head_shares(n: int) -> list[tuple[int, int]]:
    """Every model rank's ``head_part(n, uneven=True)``, in the model
    axis' order; ``[(0, n)]`` without a mesh context."""
    ax = _AXES.get()
    if ax is None:
        return [(0, n)]
    m = ax.model_size
    if n < m:
        return [(0, n)] * m
    return [_share(n, m, k) for k in range(m)]


def head_part(n: int, *, uneven: bool = False,
              groups: int | None = None) -> tuple[int, int]:
    """This model rank's heads ``[lo, hi)`` of ``n``: its ``model_part``
    share, or all ``n`` where that share would not be whole, which is the
    reference's rule (``wsc`` leaves a dim that does not divide
    unconstrained): every model rank then runs the heads whole and adds
    no partial sums.  A share is whole where ``n`` divides over the model
    axis and, with SSD's B/C ``groups``, each rank's heads cover whole
    groups or lie in one.  ``uneven`` (attention): any split but one that
    leaves a rank no head is whole, since a GQA rank reads the kv heads of
    its own q heads (``attention.local_heads``) whatever the split; a
    recurrent block's state, conv tail and gated norm are per head group,
    so it splits evenly only.  All heads without a mesh context."""
    ax = _AXES.get()
    if ax is None:
        return 0, n
    m = ax.model_size
    if uneven:
        whole = n < m
    else:
        whole = m > 1 and (n % m != 0 or (groups is not None
                                          and groups % m and m % groups))
    return (0, n) if whole else model_part(n)


def weight(w, dim: int | None = None, index=None):
    """A parameter leaf as this rank computes with it: under a mesh
    context the full tensor (``collectives.materialize``), or with
    ``index`` (a slice, or a tensor of indices, on ``dim``) that part of
    it, which for this model rank's block of a dim sharded over the model
    axis is read without gathering that dim.  Without a context, ``w``
    (indexed)."""
    ax = _AXES.get()
    if dim is not None:
        dim %= w.ndim
    if ax is None:
        return w if index is None else _take(w, dim, index)
    if index is None:
        return collectives.materialize(w, ax.mesh)
    if isinstance(index, slice):
        n, m, k = w.shape[dim], ax.model_size, ax.model_index
        if n % m == 0 and (index.start, index.stop) == (k * n // m,
                                                        (k + 1) * n // m):
            return collectives.materialize(w, ax.mesh, keep={dim: ax.model})
    return _take(collectives.materialize(w, ax.mesh), dim, index)


def _take(t, dim, index):
    if isinstance(index, slice):
        if (index.start, index.stop) == (0, t.shape[dim]):
            return t
        return t.narrow(dim, index.start, index.stop - index.start)
    return t.index_select(dim, index)


def psum_model(t):
    """The sum over the model axis of a row-parallel product's partial
    sums (``t`` held per rank); ``t`` without a mesh context."""
    ax = _AXES.get()
    if ax is None:
        return t
    return collectives.psum(t, ax.mesh, ax.model)


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` as fp32, or as it is in float64."""
    return t if t.dtype == torch.float64 else t.float()


def _parts(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """A bf16 operand as it is; an fp32 one (a cotangent) as two bf16
    parts whose sum is it to about 2^-16 of each entry."""
    if t.dtype == torch.bfloat16:
        return (t,)
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) as fp32, each operand bf16 or an
    fp32 cotangent: widened on the CPU; on the card bf16 cuBLAS products
    with fp32 outputs over ``_parts``, summed in fp32."""
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    mm = torch.mm if a.ndim == 2 else torch.bmm
    out = None
    for x in _parts(a):
        for y in _parts(b):
            part = mm(x, y, out_dtype=torch.float32)
            out = part if out is None else out.add_(part)
    return out


def _wide_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``WideDot``'s forward: x ``(..., K)`` @ w ``(K, N)``, x ``(n, K)``
    against each expert of w ``(E, K, N)``, or each expert's own x ``(E,
    n, K)``."""
    if x.ndim == 3 and w.ndim == 3:
        return _mm32(x, w)
    if w.ndim == 3:
        return _mm32(x.expand(w.shape[0], *x.shape), w)
    return _mm32(x.reshape(-1, x.shape[-1]), w).reshape(
        *x.shape[:-1], w.shape[-1])


class WideDot(torch.autograd.Function):
    """bf16 ``x @ w`` as its fp32 result, the reference's ``dot_general``
    with ``preferred_element_type=float32``, with that product's VJP: each
    input's grad is the fp32 product of the unrounded fp32 cotangent,
    rounded once to bf16.  ``w`` is ``(K, N)`` (x ``(..., K)`` ->
    ``(..., N)``) or a stack of experts ``(E, K, N)`` (x ``(n, K)`` ->
    ``(E, n, N)``, the reference's ``einsum("td,edf->tef")`` in the
    port's layout; x's grad sums over the experts in fp32; or x ``(E, n,
    K)``, each expert's own rows: ``einsum("ecd,edf->ecf")``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _wide_dot(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if x.ndim == 3 and w.ndim == 3:
            if ctx.needs_input_grad[0]:
                dx = _mm32(g, w.mT).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _mm32(x.mT, g).to(w.dtype)
            return dx, dw
        if w.ndim == 3:
            if ctx.needs_input_grad[0]:
                dx = _mm32(g, w.mT).sum(0).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _mm32(x.mT.expand(w.shape[0], *x.mT.shape),
                           g).to(w.dtype)
            return dx, dw
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[0]:
            dx = _mm32(g2, w.mT).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm32(x.reshape(-1, x.shape[-1]).mT, g2).to(w.dtype)
        return dx, dw


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis, as fp32 (``wide``); ``w`` may be a
    stack of experts ``(E, K, N)`` (-> ``(E, n, N)``, against x ``(n, K)``
    or each expert's own rows ``(E, n, K)``).  bf16 operands keep the fp32
    product unrounded (``WideDot``)."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        if w.ndim == 3 and x.ndim == 2:
            # x against each expert as one batched product: ``matmul``'s
            # fold of (n, K) @ (E, K, N) copies the weight, and autograd
            # keeps that copy for the backward
            x = x.expand(w.shape[0], *x.shape)
        return wide(torch.matmul(x, w))
    return WideDot.apply(x, w)


def rms_norm(x, scale, eps=1e-5):
    """``x`` normalized over its last dim and scaled by the parameter leaf
    ``scale`` (read through ``weight``)."""
    return rms_norm_by(x, weight(scale), eps)


def rms_norm_by(x, scale, eps=1e-5):
    """``rms_norm`` with a scale already read (a tensor derived from a
    ``weight`` read, which a second read would count twice in the
    grad)."""
    xf = wide(x)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * wide(scale)).to(x.dtype)


def rms_norm_split(x, scale, n: int, eps=1e-5):
    """``rms_norm_by`` over a last dim of ``n`` of which ``x`` holds this
    model rank's part (``scale`` the same part): the squares' sums added
    over the model axis (``psum_model``)."""
    xf = wide(x)
    var = psum_model((xf * xf).sum(-1, keepdim=True)) / n
    return (xf * torch.rsqrt(var + eps) * wide(scale)).to(x.dtype)


def head_rms_norm(x, scale, eps=1e-5):
    """Per-head qk-norm (qwen3): x ``(..., H, hd)``."""
    return rms_norm(x, scale, eps)


def rope(x, positions, theta: float = 10_000.0):
    """x: ``(..., S, H, hd)``, positions: ``(..., S)`` int."""
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(1.0 / theta, exps)       # no host-to-device copy
    ang = positions[..., :, None].float()[..., None, :] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)       # (..., S, 1, half)
    x1, x2 = wide(x[..., :half]), wide(x[..., half:])
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d_model: int, dtype=torch.float32):
    """The sinusoidal position table ``(..., d_model)`` of integer
    ``positions`` ``(...)``: the sin half, then the cos half, at
    frequencies ``1e-4 ** (i / half)``, in ``dtype`` (fp32 as the
    reference computes it; float64 for a float64 model).  The fp32
    frequencies are the fp32 power rounded once from float64: the
    reference's at musicgen's widths, where ``torch.pow`` in fp32 is an
    ulp off at some ``i`` (an ulp of a frequency moves the angle at
    position 2048 by up to 1.2e-4)."""
    half = d_model // 2
    dev = positions.device
    if dtype == torch.float64:
        exps = torch.arange(half, dtype=dtype, device=dev) / half
        freqs = torch.pow(1e-4, exps)
    else:
        exps = torch.arange(half, dtype=torch.float32, device=dev) / half
        base = float(torch.tensor(1e-4, dtype=torch.float32))
        freqs = torch.pow(base, exps.double()).to(dtype)
    ang = positions[..., None].to(dtype) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def mlp_apply(params, x, act: str = "swiglu"):
    """The MLP; under a mesh context tensor-parallel: this model rank's
    share of the hidden units (``model_part``), the down projection's
    partial sums added in fp32 over the model axis."""
    lo, hi = model_part(params["wi"].shape[-1])
    cols = slice(lo, hi)
    if act == "swiglu":
        h = (F.silu(dot(x, weight(params["wg"], -1, cols)))
             * dot(x, weight(params["wi"], -1, cols)))
    else:                                  # jax.nn.gelu: tanh approximation
        h = F.gelu(dot(x, weight(params["wi"], -1, cols)), approximate="tanh")
    out = dot(h.to(x.dtype), weight(params["wo"], 0, cols))
    return psum_model(out).to(x.dtype)


def causal_mask(sq: int, sk: int, offset: int, device=None):
    """``(sq, sk)`` bool: key j is visible to query i when ``j <= i +
    offset``."""
    q = torch.arange(sq, device=device)[:, None] + offset
    return torch.arange(sk, device=device)[None, :] <= q


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """Mean next-token loss over the labels ``!= ignore_id``: logits
    ``(..., V)`` cast to fp32, labels ``(...)`` integers; the gold logit is
    picked through ``labels.clip(0)`` (an ignored label picks token 0,
    then weighs 0), as the reference does."""
    total, count = cross_entropy_sum(logits, labels, ignore_id=ignore_id)
    return total / count.clamp(min=1.0)


def cross_entropy_sum(logits, labels, *, ignore_id: int = -1):
    """``cross_entropy``'s sum over the labels ``!= ignore_id`` and their
    count (fp32), the parts a sharded loss adds over the ranks."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels != ignore_id).float()
    return ((logz - gold) * valid).sum(), valid.sum()


# ------------------------------------------------------------------- init --
def normal(gen: torch.Generator, shape, dtype, scale) -> torch.Tensor:
    """Standard normal in fp32 from ``gen`` (on ``gen``'s device), times
    ``scale``, cast to ``dtype``: the reference's ``_normal``."""
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    return (out * scale).to(dtype)


def init_linear(gen, fin, fout, dtype, *, scale=None):
    """``(fin, fout)`` with std ``1/sqrt(fin)`` unless ``scale``."""
    return normal(gen, (fin, fout), dtype,
                  scale if scale is not None else 1.0 / math.sqrt(fin))


def init_mlp(gen, d, ff, dtype, act="swiglu"):
    p = {"wi": init_linear(gen, d, ff, dtype),
         "wo": init_linear(gen, ff, d, dtype)}
    if act == "swiglu":
        p["wg"] = init_linear(gen, d, ff, dtype)
    return p


def unbind_params(tree) -> list:
    """The layers of a stacked nested dict, as views (no copies): one
    ``unbind`` per leaf, whose backward stacks all the layers' grads at
    once.  (Indexing each layer on its own makes autograd build and add a
    full-size zero-padded grad of the stacked leaf per layer.)  A
    ``Sharded`` leaf unbinds its local block."""
    if isinstance(tree, dict):
        parts = {k: unbind_params(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, collectives.Sharded):
        return tree.unbind(_AXES.get().mesh)
    return list(torch.unbind(tree, 0))
