"""The port's kernels (``repro_torch.kernels``) against the JAX reference.

The same numpy inputs go through the port's plain versions (what every
wrapper runs on a CPU tensor) and through the reference's Pallas kernels in
interpret mode and its ``kernels/ref.py`` oracles, as the reference's own
tests run them.  Tolerance: ``max|Δ| <= 1e-5 · max|ref|`` (fp32
accumulation in another order).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``, which imports no JAX.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ddmm import ddmm as jddmm
from repro.kernels.shift_conv import shift_conv2d as jshift_conv2d
from repro.kernels.spdmm import dense_to_ell as jdense_to_ell
from repro.kernels.spdmm import spdmm as jspdmm
from repro_torch.core.passes.select import dense_to_ell
from repro_torch.kernels import _build, ref
from repro_torch.kernels.ddmm import ddmm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.shift_conv import (BK, SMS, launch_plan,
                                            shift_conv2d)
from repro_torch.kernels.spdmm import spdmm, spdmm_rows
from test_torch_cuda import (ACTS, CONV_CASES, DDMM_PATH, DDMM_SHAPES,
                             RESNET_CONVS, SPDMM_SHAPES, close, conv_inputs,
                             ddmm_inputs, ell_inputs, t)

# the module, which the package's ``ddmm`` function shadows
ddmm_mod = importlib.import_module("repro_torch.kernels.ddmm")
sddmm_mod = importlib.import_module("repro_torch.kernels.sddmm")
PATH_TASKS = ("b1", "b2", "b3-r50", "b3-r101", "b4", "b5", "b6", "b6-dyn",
              "vip-masked")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ ddmm --
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", DDMM_SHAPES)
def test_ddmm_matches_pallas_and_ref(m, k, n, act):
    x, y, b, r = ddmm_inputs(m, k, n)
    got = ddmm(t(x), t(y), bias=t(b), residual=t(r), act=act).numpy()
    jx, jy, jb, jr = map(jnp.asarray, (x, y, b, r))
    close(got, jddmm(jx, jy, bias=jb, residual=jr, act=act,
                     interpret=True))
    close(got, jref.ddmm_ref(jx, jy, bias=jb, residual=jr, act=act))


def test_ddmm_without_epilogue_and_gelu_is_tanh_form():
    x, y, _, _ = ddmm_inputs(20, 30, 40, seed=1)
    close(ddmm(t(x), t(y)).numpy(), x @ y)
    z = np.linspace(-4, 4, 101).astype(np.float32)
    g = ref.ACTS["gelu"](t(z)).numpy()
    close(g, jax.nn.gelu(jnp.asarray(z)))            # jax default: tanh
    erf_form = torch.nn.functional.gelu(t(z)).numpy()
    assert np.abs(g - erf_form).max() > 1e-5


def path_plan(task):
    from repro_torch.core import CompileOptions, compile_graph
    from repro_torch.core.ir import GraphBuilder
    from repro_torch.gnncv.tasks import build_dynamic_task, build_task
    from test_torch_cuda import vip_masked_graph
    if task == "vip-masked":
        graph = vip_masked_graph(GraphBuilder)
    else:
        graph = (build_dynamic_task if task == "b6-dyn" else build_task)(task)
    return compile_graph(graph, CompileOptions(kernels="cuda"))


def ddmm_path_calls(plan):
    """Every DDMM call of a plan as the runtime makes it: ``(M, K, N, y a
    transposed view, bias handed over, act handed over)``."""
    from repro_torch.core.runtime.matmul import kernel_epilogue
    shapes = dict(plan.meta["input_shapes"])
    calls = set()
    for op in plan.ops:
        xin = tuple(shapes[op.inputs[0]])
        shapes[op.name] = op.out_shape
        if op.kernel == "cuda_sddmm" and "mask" not in op.weights:
            calls.add((xin[0], xin[1], xin[0], True, False, None))
        if op.kernel != "cuda_ddmm" or op.kind != "mm":
            continue
        side = op.attrs["weight_side"]
        if side == "right":
            m, k, n = (int(np.prod(xin[:-1] or (1,))), xin[-1],
                       op.weights["w"].shape[1])
        elif side == "left":
            (m, k), n = op.weights["adj"].shape, xin[-1]
        elif side == "left_runtime":
            (m, k), n = shapes[op.inputs[1]][-2:], xin[-1]
        else:
            assert side == "both_runtime", side
            y = shapes[op.inputs[1]]
            m, k, n = int(np.prod(xin[:-1])), xin[-1], int(np.prod(y[1:]))
        shape = tuple(op.out_shape) if op.out_shape else (m * n,)
        epi = kernel_epilogue(op, {}, None, m, n, shape)
        calls.add((m, k, n, False, epi is not None and epi["bias"] is not None,
                   epi["act"] if epi else None))
    return calls


@pytest.fixture(scope="module")
def path_calls():
    return {task: ddmm_path_calls(path_plan(task)) for task in PATH_TASKS}


def test_ddmm_path_list_is_every_call_of_the_paths(path_calls):
    """``DDMM_PATH`` (the card tests' shapes) is exactly the distinct DDMM
    calls of the paths, with the epilogue the runtime hands over."""
    assert len(set(DDMM_PATH)) == len(DDMM_PATH)
    assert set().union(*path_calls.values()) == set(DDMM_PATH)


@pytest.mark.parametrize("case", DDMM_PATH, ids=str)
def test_ddmm_launch_plan_does_not_depend_on_m(case):
    """Route, column tile and K chunks (their depth and count) follow K
    and N alone; M moves only the tile height and the grid's rows."""
    _, k, n, *_ = case
    plans = [ddmm_mod.launch_plan(m, k, n) for m in (1, 4, 26, 104)]
    chunks = {(p.route, p.bn, p.k_tiles, p.kt_per, p.split,
               p.grid[0] if p.route == "mma" else p.grid[1]) for p in plans}
    assert len(chunks) == 1, chunks
    assert [p.bm for p in plans if p.route == "mma"] in (
        [], [16, 16, 32, 64])
    assert plans[0].route == ("narrow" if n <= ddmm_mod.NARROW_N else "mma")


@pytest.mark.parametrize("case", DDMM_PATH, ids=str)
def test_ddmm_launch_plan_gives_the_blocks_it_promises(case):
    """The chunks cover K exactly, at most MAX_SPLIT of at least MIN_CHUNK
    stages (or all of a shorter K), and every output tile gets at least
    half of min(MAX_SPLIT, ceil(SMS / n_tiles), k_tiles // MIN_CHUNK)
    blocks; the narrow route runs one warp per row."""
    m, k, n, *_ = case
    p = ddmm_mod.launch_plan(m, k, n)
    cdiv = ddmm_mod._cdiv
    assert p.k_tiles == max(1, cdiv(k, ddmm_mod.BK))
    if p.route == "narrow":
        assert p.grid == (cdiv(m, ddmm_mod.NARROW_ROWS), 1) and p.split == 1
        return
    n_tiles, m_tiles = cdiv(n, p.bn), cdiv(m, p.bm)
    assert p.grid == (n_tiles * p.split, m_tiles)
    assert (p.split - 1) * p.kt_per < p.k_tiles <= p.split * p.kt_per
    assert 1 <= p.split <= ddmm_mod.MAX_SPLIT
    assert p.kt_per >= min(ddmm_mod.MIN_CHUNK, p.k_tiles)
    want = min(ddmm_mod.MAX_SPLIT, cdiv(ddmm_mod.SMS, n_tiles),
               p.k_tiles // ddmm_mod.MIN_CHUNK)
    assert 2 * p.split >= want, (p, want)
    assert p.blocks >= m_tiles * n_tiles * -(-want // 2)


@pytest.mark.parametrize("k", [0, 1, 17, 32, 64, 96, 512, 4096, 5000])
def test_sddmm_launch_plan_splits_by_k_alone(k):
    """SDDMM's K chunks follow K alone (M and N move only the grid): they
    cover K exactly, number at most MAX_SPLIT and hold at least MIN_CHUNK
    stages each (or all of a shorter K); the masked VIP's K = 512 gives 8
    chunks of 2 stages."""
    shapes = ((1, 1), (196, 196), (100, 70), (4096, 33))
    plans = [sddmm_mod.launch_plan(m, k, n) for m, n in shapes]
    assert len({(p.k_tiles, p.kt_per, p.split) for p in plans}) == 1
    p = plans[0]
    assert p.k_tiles == max(1, -(-k // sddmm_mod.BK))
    assert 1 <= p.split <= sddmm_mod.MAX_SPLIT
    assert (p.split - 1) * p.kt_per < p.k_tiles <= p.split * p.kt_per
    assert p.kt_per >= min(sddmm_mod.MIN_CHUNK, p.k_tiles)
    if p.k_tiles >= sddmm_mod.MIN_CHUNK * sddmm_mod.MAX_SPLIT:
        assert p.split == sddmm_mod.MAX_SPLIT
    for (m, n), q in zip(shapes, plans):
        edge = sddmm_mod.BLOCK
        assert q.grid == (-(-n // edge) * q.split, -(-m // edge))
        assert (q.bm, q.bn) == (edge, edge)
    if k == 512:
        assert (p.split, p.kt_per) == (8, 2)


def test_ddmm_y_layout_reads_rows_and_transposed_views():
    y = torch.zeros(40, 30)
    assert ddmm_mod.y_layout(y) == (False, 30)
    assert ddmm_mod.y_layout(y.T) == (True, 30)
    assert ddmm_mod.y_layout(torch.zeros(64, 1)) == (False, 1)
    assert ddmm_mod.y_layout(torch.zeros(1, 64)) == (False, 64)
    assert ddmm_mod.y_layout(torch.zeros(40, 60)[:, ::2]) is None
    assert ddmm_mod.y_layout(torch.zeros(40, 60)[:, :30]) == (False, 60)


@pytest.mark.parametrize("task", ["b6", "b1"])
def test_run_mm_hands_bias_and_relu_to_ddmm_bit_for_bit(task):
    """run_mm on the CPU with the epilogue handed to ``ddmm`` equals the
    product without it followed by ``apply_epilogue``, bit for bit, on
    every linear of b6 and b1 (a NaN in the input included); an epilogue
    the kernel cannot take (b2's leaky_relu) is not handed over."""
    from repro_torch.core.runtime.elementwise import apply_epilogue
    from repro_torch.core.runtime.matmul import kernel_epilogue, run_mm
    from repro_torch.core.runtime.residency import weight
    plan = path_plan(task)
    shapes = dict(plan.meta["input_shapes"])
    rng = np.random.default_rng(0)
    handed = 0
    for op in plan.ops:
        xin = tuple(shapes[op.inputs[0]])
        shapes[op.name] = op.out_shape
        if op.kind != "mm" or op.attrs["weight_side"] != "right":
            continue
        x = rng.standard_normal(xin).astype(np.float32)
        x.flat[7] = np.nan
        env = {op.inputs[0]: t(x)}
        x2 = env[op.inputs[0]].reshape(-1, xin[-1])
        w = weight(op, "w", None)
        shape = tuple(op.out_shape)
        assert kernel_epilogue(op, env, None, x2.shape[0], w.shape[1],
                               shape) is not None
        handed += 1
        got = run_mm(op, env)
        want = apply_epilogue(ddmm(x2, w).reshape(shape), op, env)
        assert torch.isnan(got).any()
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert handed == {"b6": 6, "b1": 5}[task]
    leaky = next(op for op in path_plan("b2").ops
                 if op.attrs.get("fused_act") == "leaky_relu")
    assert kernel_epilogue(leaky, {}, None, 80, 1024, (80, 1024)) is None


# ----------------------------------------------------------------- spdmm --
@pytest.mark.parametrize("s1,s2,ell_l,n", SPDMM_SHAPES)
def test_spdmm_matches_pallas_and_ref(s1, s2, ell_l, n):
    idx, val = ell_inputs(s1, s2, ell_l, seed=s1)
    y = np.random.default_rng(1).standard_normal((s2, n)).astype(np.float32)
    got = spdmm(t(idx), t(val), t(y)).numpy()
    ji, jv, jy = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y)
    close(got, jspdmm(ji, jv, jy, interpret=True))
    close(got, jref.spdmm_ref(ji, jv, jy))
    dense = np.zeros((s1, s2), np.float32)
    np.add.at(dense, (np.arange(s1)[:, None], idx), val)
    close(got, dense @ y)


@pytest.mark.parametrize("out_of_range", [False, True])
def test_spdmm_rows_matches_pallas_and_ref_at_b4s_ell(out_of_range):
    """The rows entry (on the CPU: its twin) at b4's skeleton ELL and a
    small C·T equals the JAX kernel in interpret mode and the reference's
    oracle on the transposed layout, and the port's column twin; padding
    slots pointing out of range add nothing (JAX clamps them, the port
    skips them: val is 0 either way)."""
    op = next(op for op in path_plan("b4").ops if op.ell is not None)
    idx, val = (np.array(a) for a in op.ell)
    pad = val == 0
    assert pad.any()
    if out_of_range:
        idx[pad] = np.where(np.arange(pad.sum()) % 2, 25 + 4, -3)
    x2 = np.random.default_rng(0).standard_normal((2 * 12, 25)).astype(
        np.float32)
    got = spdmm_rows(t(idx), t(val), t(x2)).numpy()
    assert got.shape == (24, 25)
    ji, jv, jy = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x2.T)
    close(got, np.asarray(jspdmm(ji, jv, jy, interpret=True)).T)
    close(got, np.asarray(jref.spdmm_ref(ji, jv, jy)).T)
    close(got, spdmm(t(idx), t(val), t(x2.T)).numpy().T)
    close(got, ref.spdmm_ref(t(idx), t(val), t(np.ascontiguousarray(
        x2.T))).numpy().T)


@pytest.mark.parametrize("s1,s2,ell_l,n", SPDMM_SHAPES)
def test_spdmm_twins_skip_out_of_range_slots(s1, s2, ell_l, n):
    """Both twins (the CUDA kernels' semantics): an out-of-range slot adds
    nothing, where an in-range one adds val · y; the two layouts agree."""
    idx, val = ell_inputs(s1, s2, ell_l, seed=s1, out_of_range=True)
    y = np.random.default_rng(2).standard_normal((s2, n)).astype(np.float32)
    ok = (idx >= 0) & (idx < s2)
    assert not ok.all()
    dense = np.zeros((s1, s2), np.float32)
    np.add.at(dense, (np.nonzero(ok)[0], idx[ok]), val[ok])
    got = spdmm(t(idx), t(val), t(y)).numpy()
    rows = spdmm_rows(t(idx), t(val), t(np.ascontiguousarray(y.T))).numpy()
    close(got, dense @ y)
    close(rows.T, dense @ y)


@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
def test_dense_to_ell_bit_identical(density):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((25, 40)).astype(np.float32)
    a *= rng.random(a.shape) < density
    idx, val = dense_to_ell(a)
    jidx, jval = jdense_to_ell(a)
    assert idx.dtype == np.int32 and val.dtype == np.float32
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(val, np.asarray(jval))


# ------------------------------------------------------------ shift_conv --
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_shift_conv_matches_pallas_and_lax(case):
    cin, h, w, k1, k2, cout, stride, padding, groups, dil = case
    x, wt = conv_inputs(cin, h, w, k1, k2, cout, groups)
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dil)
    got = shift_conv2d(t(x), t(wt), **kw).numpy()
    jx, jw = jnp.asarray(x), jnp.asarray(wt)
    close(got, jshift_conv2d(jx, jw, interpret=True, **kw))
    close(got, jref.conv2d_ref(jx, jw, **kw))


def test_conv_geometry_matches_lowering():
    # SAME keeps ceil(H/s); the TF split puts the odd pad row at the bottom
    assert ref.conv_geometry(150, 25, 9, 1, stride=(2, 1), padding="SAME",
                             dilation=(1, 1)) == (75, 25, 3, 4, 0, 0)
    assert ref.conv_geometry(75, 25, 9, 1, stride=(2, 1), padding="SAME",
                             dilation=(1, 1)) == (38, 25, 4, 4, 0, 0)
    assert ref.conv_geometry(10, 10, 3, 3, stride=1, padding="VALID",
                             dilation=2) == (6, 6, 0, 0, 0, 0)
    with pytest.raises(ValueError):
        ref.conv_geometry(10, 10, 3, 3, stride=1, padding="FULL",
                          dilation=1)


def resnet_conv_calls(task):
    """Every distinct conv call of ``task``'s plan at full width:
    ``(x shape, w shape, stride, padding)``."""
    from repro_torch.core import CompileOptions, compile_graph
    from repro_torch.gnncv.tasks import build_task
    plan = compile_graph(build_task(task), CompileOptions(kernels="cuda"))
    shapes = dict(plan.meta["input_shapes"])
    calls = set()
    for op in plan.ops:
        shapes[op.name] = op.out_shape
        if op.kind == "conv":
            assert op.attrs.get("groups", 1) == 1
            assert op.attrs.get("dilation", 1) in (1, (1, 1), None)
            calls.add((tuple(shapes[op.inputs[0]]), op.weights["w"].shape,
                       op.attrs["stride"], op.attrs["padding"]))
    return calls


@pytest.fixture(scope="module")
def resnet_calls():
    return {task: resnet_conv_calls(task)
            for task in ("b2", "b3-r50", "b3-r101")}


def test_resnet_conv_list_is_every_layer_of_b2_and_b3(resnet_calls):
    """``RESNET_CONVS`` (the card tests' shapes) is exactly the distinct
    conv layers of b2 and b3-r50; b3-r101 adds depth, no new shape."""
    listed = {((c, h, w), (k1, k2, c, o), (s, s), "SAME")
              for c, h, w, k1, k2, o, s in RESNET_CONVS}
    assert len(listed) == len(RESNET_CONVS)
    norm = {task: {(x, w, tuple(np.broadcast_to(s, 2)), p)
                   for x, w, s, p in calls}
            for task, calls in resnet_calls.items()}
    assert norm["b2"] | norm["b3-r50"] == listed
    assert norm["b3-r101"] == norm["b3-r50"]


@pytest.mark.parametrize("task", ["b2", "b3-r50", "b3-r101"])
def test_shift_conv_launch_plan_fills_the_card(resnet_calls, task):
    """Every layer's grid reaches one wave of blocks, or every block holds
    a single K tile; the split divides the K tiles."""
    for x, w, stride, padding in resnet_calls[task]:
        plan = launch_plan(x, w, stride=stride, padding=padding)
        assert plan.k_tiles == -(-w[0] * w[1] * w[2] // BK)
        assert plan.k_tiles % plan.split == 0, (x, w, plan)
        assert plan.blocks >= SMS or plan.split == plan.k_tiles, (x, w, plan)
        ho, wo, *_ = ref.conv_geometry(x[1], x[2], w[0], w[1],
                                       stride=stride, padding=padding,
                                       dilation=1)
        assert plan.bn == (32 if ho * wo <= 256 or plan.k_tiles <= 8
                           else 64)


@pytest.mark.parametrize("case", RESNET_CONVS + [
    (64, 7, 7, 3, 3, 64, 1), (1, 28, 28, 3, 3, 64, 1),
    (8, 15, 25, 3, 2, 8, (2, 1))], ids=str)
def test_shift_conv_launch_plan_does_not_depend_on_the_batch(case):
    """Tile and split are functions of the per-image problem: a batch of
    1, 4 or 26 images runs each image as the 3-D call does."""
    cin, h, w, k1, k2, cout, stride = case
    one = launch_plan((cin, h, w), (k1, k2, cin, cout), stride=stride)
    for batch in (1, 4, 26):
        plan = launch_plan((batch, cin, h, w), (k1, k2, cin, cout),
                           stride=stride)
        assert (plan.bm, plan.bn, plan.k_tiles, plan.split, plan.dense) == (
            one.bm, one.bn, one.k_tiles, one.split, one.dense)
        assert plan.grid == (one.grid[0], batch)
    grouped = launch_plan((2, cin * 2, h, w), (k1, k2, cin, 2 * cout),
                          stride=stride, groups=2)
    assert (grouped.split, grouped.grid) == (one.split, (one.grid[0], 4))


def tf32_rna(a):
    """fp32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def mma_dot(terms):
    """The kernel's sum: fp32 products (exact for TF32 operands), summed
    in fp32 in order, one k8 step and one product term at a time."""
    acc = np.zeros(terms[0][0].shape[0], np.float32)
    for k0 in range(0, terms[0][0].shape[1], 8):
        for a, b in terms:
            for k in range(k0, k0 + 8):
                acc = acc + a[:, k] * b[:, k]
    return acc


def test_3xtf32_split_is_fp32_accurate_at_b3_r101_depth():
    """hi = rna(a), lo = rna(a - hi); hi·hi + hi·lo + lo·hi in fp32 agrees
    with an fp64 dot within 1e-6 of sum|a·b| at K = 4608 (b3-r101's 3x3
    512 -> 512), where one TF32 product (hi·hi alone) does not."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 4608)).astype(np.float32)
    b = rng.standard_normal((64, 4608)).astype(np.float32)
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    assert np.array_equal(a_hi.view(np.uint32) & 0x1FFF, np.zeros_like(
        a_hi, np.uint32))
    assert np.abs(a - a_hi - a_lo).max() <= 2.0 ** -21 * np.abs(a).max()
    exact = (a.astype(np.float64) * b).sum(1)
    scale = np.abs(a.astype(np.float64) * b).sum(1)
    three = mma_dot([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)])
    one = mma_dot([(a_hi, b_hi)])
    assert (np.abs(three - exact) / scale).max() <= 1e-6
    assert (np.abs(one - exact) / scale).max() > 1e-6


def test_flash_bf16_refuses_misaligned_operands():
    """bf16 rows go through 16-byte copies: a base or a stride off a
    16-byte boundary raises before anything is built or launched."""
    wide = torch.empty((1, 2, 8, 40), device="meta", dtype=torch.bfloat16)
    odd = torch.empty((1, 2, 8, 36), device="meta", dtype=torch.bfloat16)
    ok = wide[..., :32]
    before = flash_attention.launches
    for bad in (wide[..., 1:33], odd[..., :32]):
        for args in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            with pytest.raises(ValueError, match="aligned"):
                flash_attention(*args)
    assert flash_attention.launches == before


# ------------------------------------------------------ wrapper contract --
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    fns = (ddmm, spdmm, spdmm_rows, shift_conv2d)
    before = [fn.launches for fn in fns]
    x, y, _, _ = ddmm_inputs(4, 5, 6)
    ddmm(t(x), t(y))
    ddmm(t(x), t(y.T.copy()).T)
    idx, val = ell_inputs(4, 4, 2, seed=0)
    spdmm(t(idx), t(val), t(y[:4]))
    spdmm_rows(t(idx), t(val), t(x[:, :4]))
    xc, wc = conv_inputs(3, 5, 5, 3, 3, 4, 1)
    shift_conv2d(t(xc), t(wc))
    assert [fn.launches for fn in fns] == before


def test_non_cuda_device_raises_instead_of_falling_back():
    x = torch.empty((4, 5), device="meta")
    y = torch.empty((5, 6), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ddmm(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        shift_conv2d(torch.empty((3, 5, 5), device="meta"),
                     torch.empty((3, 3, 3, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        spdmm(torch.empty((4, 2), dtype=torch.int32, device="meta"),
              torch.empty((4, 2), device="meta"), y)
    with pytest.raises(ValueError, match="CUDA"):
        spdmm_rows(torch.empty((4, 2), dtype=torch.int32, device="meta"),
                   torch.empty((4, 2), device="meta"), x)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        ddmm(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError):
        ddmm(torch.zeros(3, 4), torch.zeros(4, 6), bias=torch.zeros(5))
    with pytest.raises(ValueError):
        spdmm(torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, 3),
              torch.zeros(4, 4))
    with pytest.raises(ValueError):
        shift_conv2d(torch.zeros(6, 5, 5), torch.zeros(3, 3, 4, 4),
                     groups=2)
    with pytest.raises(ValueError):
        ddmm(torch.zeros(3, 4), torch.zeros(4, 6), act="swish")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
