"""The port's dry run (``repro_torch/launch/dryrun.py``) and its counts
(``launch/step_analysis.py``, ``distributed/collectives.Tally``).

The counts against programs of known cost, as ``tests/test_hlo_analysis.py``
holds the reference's: chained products, a checkpointed layer's
recomputed forward, each collective kind over a fake group of 8 under the
ring model.  The fake-tensor repairs the dry run forced (MoE's fixed-size
slot writes and its expert load) against what they replaced, and the
flash custom ops' fake layouts and FLOP formulas.  Then parity with the
reference on smoke configs over a (2, 4) mesh, for a dense, an MLA + MoE
and a recurrent arch through train, prefill and decode: argument bytes
per device equal to what the reference's own ``param_specs``,
``_opt_specs`` and ``batch_specs`` give over ``jax.eval_shape(init_lm)``'s
shapes, exactly; ``params``, ``active_params`` and the roofline's
``model_flops_per_device`` equal; and one cell's FLOPs against the
reference's ``program_costs`` within FLOPS_RTOL.  Last, the entry point at
256 fake ranks in a subprocess.
"""
import functools
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.launch import roofline as ref_roofline
from repro.models.transformer import init_lm as ref_init_lm
from repro.train.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch.distributed import collectives as col
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import (destroy_process_group, init_fake_group,
                                     make_process_mesh, production_shape)
from repro_torch.launch.step_analysis import StepCounter
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
FA = importlib.import_module("repro_torch.kernels.flash_attention")
META = torch.device("meta")
MESH = ((2, 4), ("data", "model"))
# The port's FLOPs of llama3.2-1b's smoke decode_32k cell against the
# reference's ``program_costs`` of the same cell.  Both count matrix
# products only, and the attention over the 32768-position cache (99% of
# them) is the same product on both sides; they part on the projections'
# partition: the port computes the whole-vocab head on every model rank,
# where GSPMD cuts it over ``model`` (0.63% of the cell on this tree).
# Train and prefill cells are not compared: the reference's ``chunked``
# core computes every (query, key) block of the causal mask, the flash
# kernel's count only the live pairs (about half).
FLOPS_RTOL = 1e-2


def _ref_dryrun():
    """The reference's dry run module, imported without keeping the 512
    forced host devices its first line asks for (jax in this process
    keeps its devices)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# ------------------------------------------------------------- counts ----
def test_chained_products_count_exactly():
    x = torch.empty((128, 256), device=META)
    ws = [torch.empty((256, 256), device=META) for _ in range(16)]
    with StepCounter() as sc:
        y = x
        for w in ws:
            y = y @ w
    assert sc.flops == 16 * 2 * 128 * 256 * 256
    assert sc.bytes == 16 * 4 * (128 * 256 + 256 * 256 + 128 * 256)
    # each product's result is held until the next one's is made
    assert sc.peak == 2 * 128 * 256 * 4


def test_checkpoint_counts_the_recomputed_forward():
    x = torch.empty((128, 256), device=META)
    w = torch.empty((256, 256), device=META, requires_grad=True)
    with StepCounter() as sc:
        y = checkpoint(lambda a, b: torch.tanh(a @ b), x, w,
                       use_reentrant=False)
        y.sum().backward()
    # forward, its recomputation in the backward, and dW
    assert sc.flops == 3 * 2 * 128 * 256 * 256
    assert sc.flops_by_op() == {"aten.mm": 3 * 2 * 128 * 256 * 256}


@pytest.fixture
def fake8():
    init_fake_group(8)
    try:
        yield make_process_mesh((8,), ("x",))
    finally:
        destroy_process_group()


def _collective(kind, mesh):
    t = torch.empty((16, 32), device=META)
    if kind == "all-gather":
        return col.gather(t, mesh, 0, "x")
    if kind == "reduce-scatter":
        return col._scatter_axis(t, 0, mesh, "x")
    if kind == "all-reduce":
        return col.psum(t, mesh, "x")
    if kind == "all-to-all":
        return col.all_to_all(t.reshape(8, 2, 32), mesh, "x")
    return col.ppermute(t, mesh, "x")


# per-device bytes under the ring model of a (16, 32) fp32 operand (2048
# bytes) over 8 ranks
RING = {"all-gather": 8 * 2048, "reduce-scatter": 2048,
        "all-reduce": 2 * 2048, "all-to-all": 2048,
        "collective-permute": 2048}


@pytest.mark.parametrize("kind", list(RING))
def test_collective_kinds_follow_the_ring_model(fake8, kind):
    assert col._TALLY is None            # off by default
    with col.tallied() as tally:
        _collective(kind, fake8)
    got = tally.per_device()
    assert got[kind] == got["total"] == RING[kind]
    assert got["op_counts"][kind] == 1
    assert sum(got["op_counts"].values()) == 1
    assert col._TALLY is None


def test_fake_mesh_holds_meta_devices(fake8):
    assert fake8.device == META and fake8.size == 8
    assert production_shape() == ((16, 16), ("data", "model"))
    assert production_shape(multi_pod=True) == ((2, 16, 16),
                                               ("pod", "data", "model"))


# ------------------------------------------------------- fake repairs ----
@pytest.mark.parametrize("seed", range(3))
def test_into_slots_equals_the_masked_write(seed):
    """MoE's fixed-size slot write against the boolean-mask write it
    replaced (``buf[slot[keep]] = rows[keep]``), rows and ids alike."""
    g = torch.Generator().manual_seed(seed)
    n, m = 24, 40
    rows = torch.randn((m, 5), generator=g)
    slot = torch.randperm(m, generator=g)       # each slot once
    keep = (slot < n) & (torch.rand(m, generator=g) < 0.8)
    ids = torch.randint(0, 9, (m,), generator=g)
    for src, fill in ((rows, 0), (ids, -1)):
        want = src.new_full((n, *src.shape[1:]), fill)
        want[slot[keep]] = src[keep]
        assert torch.equal(moe._into_slots(src, slot, keep, n, fill), want)


@pytest.mark.parametrize("n_experts", [16, 64])
def test_expert_load_equals_bincount(n_experts):
    eid = torch.randint(0, 16, (200,), generator=torch.Generator()
                        .manual_seed(0))
    assert torch.equal(moe._expert_load(eid, n_experts),
                       torch.bincount(eid, minlength=n_experts))


def test_flash_ops_on_meta_give_the_kernels_layouts():
    """A meta tensor goes through the kernels' custom ops: the forward's
    out laid out as q (``_out_like``), the fp32 LSE, dq/dk/dv like q/k/v;
    no launch counted; FlopCounterMode counts the kernel table's
    operations."""
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.empty((2, 40, 6, 64), device=META,
                    dtype=torch.bfloat16).transpose(1, 2)   # (B, H, S, D)
    k = torch.empty((2, 40, 3, 64), device=META,
                    dtype=torch.bfloat16).transpose(1, 2)
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    with FlopCounterMode(display=False) as fc:
        out, lse = FA.flash_attention_fwd(q, k, k, return_lse=True)
        dq, dk, dv = FA.flash_attention_bwd(q, k, k, out, lse, out)
    assert out.shape == q.shape and out.stride() == FA._out_like(
        q, 64).stride()
    assert lse.shape == (2, 6, 40) and lse.dtype == torch.float32
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, k.shape]
    assert dq.stride() == q.stride()
    pairs = 40 * 41 // 2
    assert fc.get_total_flops() == (2 * 128 + 2 * (3 * 64 + 2 * 64)) \
        * 2 * 6 * pairs
    assert (FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("sq,sk", [(16, 16), (5, 9), (9, 5), (1, 100),
                                   (128, 128)])
def test_live_pairs_closed_form(sq, sk):
    loop = sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))
    assert FA.live_pairs(sq, sk, True) == loop
    assert FA.live_pairs(sq, sk, False) == sq * sk


# ------------------------------------------------- reference parity ----
class _FakeMesh:
    shape = {"data": 2, "model": 4}
    axis_names = ("data", "model")


def _spec_bytes(shape, dtype, spec) -> int:
    n = 1
    for ax in tuple(spec):
        if ax is not None:
            n *= ref_shd._axsize(_FakeMesh, ax)
    return math.prod(shape) * np.dtype(dtype).itemsize // n


def _tree_bytes(shapes, specs) -> int:
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_spec_bytes(a.shape, a.dtype, s)
               for a, s in zip(leaves, spec_leaves))


def _ref_argument_bytes(arch, shape) -> dict:
    """What the reference's own spec functions give a device of a (2, 4)
    mesh for the smoke config's cell: parameters, AdamW state, batch."""
    ref_dry = _ref_dryrun()
    cfg = ref_configs.get_smoke(arch)
    kind = ref_configs.SHAPES[shape]["kind"]
    mesh = _FakeMesh
    pshapes = jax.eval_shape(functools.partial(ref_init_lm, cfg=cfg),
                             jax.random.PRNGKey(0))
    pspecs = ref_shd.param_specs(pshapes, mesh, fsdp=("data",),
                                 model="model")
    out = {"params": _tree_bytes(pshapes, pspecs)}
    if kind == "train":
        quant = cfg.params_count() > ref_dry.QUANTIZE_ABOVE
        oshapes = jax.eval_shape(ref_adamw(quantized=quant).init, pshapes)
        ospecs = ref_dry._opt_specs(pspecs, oshapes, mesh)
        out["opt_state"] = _tree_bytes(oshapes, ospecs)
    ins = ref_dry.input_specs(arch, shape)
    bspecs = ref_shd.batch_specs(kind, mesh, dp=("data",), model="model")
    total = 0
    for k, a in ins.items():
        spec = bspecs.get(k, jax.sharding.PartitionSpec())
        if a.shape and a.shape[0] % ref_shd._axsize(mesh, tuple(spec)[0]):
            spec = jax.sharding.PartitionSpec()     # the decode token rule
        total += _spec_bytes(a.shape, a.dtype, spec)
    out["batch"] = total
    return out


# the train and prefill cells' sizes in the parity tests (a smoke
# zamba2's chunk scan over 32768 tokens takes 20 s of the host); decode
# cells keep theirs
DIMS = {"train_4k": {"seq_len": 256, "global_batch": 16},
        "prefill_32k": {"seq_len": 512, "global_batch": 8}}


@functools.lru_cache(maxsize=None)
def _port_cell(arch, shape) -> dict:
    return dryrun.lower_cell(arch, shape, cfg=configs.get_smoke(arch),
                             mesh_shape=MESH, dims=DIMS.get(shape))


PARITY = [(a, s) for a in ("llama3.2-1b", "deepseek-v3-671b", "zamba2-2.7b")
          for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", PARITY)
def test_argument_bytes_equal_the_references_specs(arch, shape,
                                                   monkeypatch):
    rec = _port_cell(arch, shape)
    assert rec["status"] == "ok" and rec["devices"] == 8
    monkeypatch.setitem(ref_configs.SHAPES, shape, {
        **ref_configs.SHAPES[shape], **DIMS.get(shape, {})})
    want = _ref_argument_bytes(arch, shape)
    got = rec["argument_breakdown"]
    assert {k: got[k] for k in want} == want
    # decode caches: their bytes against cache_specs' in
    # test_decode_cache_bytes_against_the_references_layout
    assert set(got) - set(want) == ({"caches"} if shape == "decode_32k"
                                    else set())
    assert rec["memory"]["argument_bytes"] == sum(got.values())
    assert ("cache_layout" in rec) == (shape != "train_4k")
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"]["total"] > 0


@pytest.mark.parametrize("arch,shape", PARITY)
def test_params_and_model_flops_equal_the_references(arch, shape):
    rec = _port_cell(arch, shape)
    cfg = ref_configs.get_smoke(arch)
    assert rec["params"] == cfg.params_count()
    assert rec["active_params"] == cfg.active_params_count()
    ref = ref_roofline.analyze({**rec, "tag": ""})
    got = roofline.analyze(rec)
    assert got["model_flops_per_device"] == ref["model_flops_per_device"]


def test_train_cell_counts_flash_and_remat():
    """The dense train cell runs the flash kernels: each layer's forward
    twice (remat) and its backward once."""
    rec = _port_cell("llama3.2-1b", "train_4k")
    n = configs.get_smoke("llama3.2-1b").n_layers
    assert rec["flash_calls"] == {"flash_fwd": 2 * n, "flash_bwd": n}
    assert rec["remat"] is True


_REF_CELL = """
import json, sys
sys.path.insert(0, {src!r})
from repro import configs
from repro.launch import dryrun
from repro.launch.mesh import make_host_mesh
dryrun.make_production_mesh = lambda multi_pod=False: make_host_mesh(
    (2, 4), ("data", "model"))
dryrun.configs.get = configs.get_smoke
print(json.dumps(dryrun.lower_cell({arch!r}, {shape!r})))
"""


def test_flops_against_the_references_program_costs():
    arch, shape = "llama3.2-1b", "decode_32k"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", _REF_CELL.format(
            src=str(ROOT / "src"), arch=arch, shape=shape)],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    got = _port_cell(arch, shape)["flops_per_device"]
    rel = abs(got - ref["flops_per_device"]) / ref["flops_per_device"]
    assert rel <= FLOPS_RTOL, (got, ref["flops_per_device"], rel)


def test_dryrun_cell_at_256_fake_ranks(tmp_path):
    """The entry point, as ``tests/test_distributed.py`` drives the
    reference's: qwen3-0.6b's decode_32k over the (16, 16) mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"]["total"] > 0
    rows = roofline.load(str(tmp_path))
    assert len(rows) == 1 and rows[0]["dominant"] in (
        "compute", "memory", "collective")


def test_n_a_cells_need_no_group():
    rec = dryrun.lower_cell("qwen3-0.6b", "long_500k")
    assert rec["status"] == "n/a"
    assert not torch.distributed.is_initialized()


def _padded(spec, nd) -> tuple:
    """A rule table's spec with its leading replicated dims written out
    (``P()`` for a norm is ``(None,)`` per dim as placed)."""
    return (None,) * (nd - len(spec)) + tuple(spec)


@pytest.mark.parametrize("quantized", [False, True])
def test_opt_specs_state_the_moments_placements(quantized):
    """``_opt_specs`` over a (2, 4) fake mesh states the placements AdamW's
    ``init`` gives each moment (fp32, or int8 codes and scales, the
    straddling leaves' scales replicated on the last dim), grok-1's smoke
    config."""
    from repro_torch.train.optim import QTensor, adamw, tree_leaves
    init_fake_group(8)
    try:
        mesh = make_process_mesh(*MESH)
        params, pshard = dryrun.place_params(
            configs.get_smoke("grok-1-314b"), mesh, fsdp=("data",),
            model="model")
        state = adamw(quantized=quantized).init(params)
        specs = dryrun._opt_specs(params, pshard, quantized)
        assert specs["step"] == ()
        for mom in ("m", "v"):
            got = tree_leaves(state[mom])
            want = tree_leaves(specs[mom])
            assert len(got) == len(want) == len(tree_leaves(params))
            for g, w in zip(got, want):
                if quantized:
                    assert isinstance(g, QTensor)
                    assert (col.spec_of(g.codes, mesh),
                            col.spec_of(g.scale, mesh)) == (
                        _padded(w.codes, g.codes.ndim),
                        _padded(w.scale, g.scale.ndim))
                else:
                    assert col.spec_of(g, mesh) == _padded(w, g.ndim)
    finally:
        destroy_process_group()


# decode_32k's cache bytes a device over the production (16, 16) mesh:
# the port's layout (``init_caches(mesh=)``, what the dry run's decode
# cells hold) over the reference's ``cache_specs`` (the sequence over
# ``model``), at the published configs: the same layout for the attention
# leaves; the recurrent archs' states are the same but for their small
# leaves, cut otherwise (0.03% / 0.3%)
CACHE_RATIO = {"zamba2-2.7b": 1, "deepseek-v3-671b": 1, "grok-1-314b": 1,
               "qwen2-72b": 1, "codeqwen1.5-7b": 1, "llama3.2-1b": 1,
               "qwen3-0.6b": 1, "musicgen-medium": 1, "xlstm-350m": 1,
               "chameleon-34b": 1}


@pytest.mark.parametrize("arch", sorted(CACHE_RATIO))
def test_decode_cache_bytes_against_the_references_layout(arch):
    from repro.models.transformer import init_caches as ref_init_caches
    from repro_torch.launch.step_analysis import held_bytes
    from repro_torch.models.transformer import init_caches
    sh = configs.SHAPES["decode_32k"]
    B, S = sh["global_batch"], sh["seq_len"]
    cs = jax.eval_shape(functools.partial(
        ref_init_caches, ref_configs.get(arch), B, S))

    class Mesh16:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    specs = ref_shd.cache_specs(cs, Mesh16, dp=("data",), model="model")
    ref = 0
    for a, s in zip(jax.tree.leaves(cs), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        n = math.prod(ref_shd._axsize(Mesh16, ax) for ax in tuple(s)
                      if ax is not None)
        ref += math.prod(a.shape) * np.dtype(a.dtype).itemsize // n
    init_fake_group(256)
    try:
        mesh = make_process_mesh(*production_shape())
        got = held_bytes(init_caches(configs.get(arch), B, S, device=META,
                                     mesh=mesh))
    finally:
        destroy_process_group()
    assert got / ref == pytest.approx(CACHE_RATIO[arch], rel=3e-3), \
        (got, ref)
