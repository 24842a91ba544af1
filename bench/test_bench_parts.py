"""CPU tests of the benchmark's yardstick: the traffic generator, the
due-time latency arithmetic, the interval merge of the device trace, the
FLOP counts against hand formulas, and what the harness may import."""
from __future__ import annotations

import ast
import math
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gcvbench import devtrace, record, spec
from gcvbench import traffic as gen
from gcvbench.small import small_cell

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


# ---------------------------------------------------------- traffic ----
@pytest.mark.parametrize("seed", [0, 2**31 + 77, 2**40 + 3])
def test_poisson_schedule_same_work_every_seed(seed):
    rate, seconds = 800.0, 10.0
    due = gen.arrival_offsets(rate, seconds, seed)
    ref = gen.arrival_offsets(rate, seconds, 1)
    assert abs(len(due) - rate * seconds) <= 3
    assert np.all(np.diff(due) > 0) and due[-1] < seconds
    gaps, gaps_ref = np.diff(due, prepend=0.0), np.diff(ref, prepend=0.0)
    assert abs(np.mean(gaps) * rate - 1.0) < 2e-3
    # the same gaps in another order: their multiset does not move
    k = min(len(gaps), len(gaps_ref))
    assert np.allclose(np.sort(gaps)[:k - 5], np.sort(gaps_ref)[:k - 5])
    if seed != 1:
        assert not np.allclose(gaps[:50], gaps_ref[:50])
    # in one arrangement for every seed, which the seed rotates
    ring = np.concatenate([gaps_ref, gaps_ref])
    hits = [i for i in range(len(gaps_ref))
            if np.allclose(ring[i:i + 8], gaps[:8], rtol=1e-9, atol=0)]
    assert len(hits) == 1
    # exponential: the gaps' coefficient of variation is about one
    assert 0.9 < np.std(gaps) / np.mean(gaps) < 1.1


def test_pool_order_is_a_seeded_permutation():
    o = gen.pool_order(512, 9)
    assert np.array_equal(np.sort(o), np.arange(512))
    assert np.array_equal(o, gen.pool_order(512, 9))


def _run(t_due, t_done, results=None, t0=0.0, seconds=1.0):
    reqs = [types.SimpleNamespace(result=(r if r is not None else None),
                                  t_dispatch=0.0)
            for r in (results or [(0,)] * len(t_due))]
    win = types.SimpleNamespace(t0=t0, t_end=t0 + seconds, t_due=t_due,
                                t_done=t_done, reqs=reqs,
                                pool_idx=list(range(len(t_due))))
    return record.Run(None, 0, seconds, False, 1, 0, 0, 0, win, {}, {},
                      None, np.ones(len(t_due)), np.ones(len(t_due)), 0,
                      np.ones(len(t_due), bool))


def test_latency_from_due_time_and_shed_counts_last():
    due = [0.0, 0.1, 0.2, 0.3]
    done = [0.004, 0.110, float("nan"), 0.302]
    shed = [(0,), (0,), (0,), None]          # the last: shed, no result
    lat = _run(due, done, shed).latencies_ms()
    assert lat[0] == pytest.approx(4.0) and lat[1] == pytest.approx(10.0)
    assert math.isinf(lat[2]) and math.isinf(lat[3])
    assert record.percentile(lat, 50) == pytest.approx(10.0)
    assert math.isinf(record.percentile(lat, 95))


def test_percentile_is_nearest_rank():
    xs = np.arange(1, 101, dtype=float)
    assert record.percentile(xs, 50) == 50.0
    assert record.percentile(xs, 95) == 95.0
    assert record.percentile([3.0], 95) == 3.0


def test_throughput_counts_correct_answers_inside_the_window():
    run = _run([0.0] * 4, [0.5, 0.9, 1.2, 0.7])
    run.ok = np.array([True, True, True, False])
    assert run.completed_in_window().tolist() == [True, True, False, False]


# ------------------------------------------------------------ trace ----
def test_interval_merge():
    spans = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (3.0, 4.0), (6.0, 6.5)]
    assert devtrace.busy(spans) == pytest.approx(6.0)
    assert devtrace.gaps(spans) == [(4.0, 5.0)]
    assert devtrace.busy([]) == 0.0


def test_device_window_idle_and_labels():
    dev = devtrace.DeviceWindow(
        {0: [(0.0, 1.0, "void ns::k<1>(int)"), (3.0, 4.0, "k2"),
             (1.5, 2.0, "Memcpy HtoD (Pinned -> Device)")],
         1: [(0.0, 4.0, "k2")]}, offset=10.0, host=(10.0, 14.0))
    assert dev.window_s() == pytest.approx(4.0)
    assert dev.busy_s() == pytest.approx((2.5 + 4.0) / 2)
    assert dev.kernel_busy_s() == pytest.approx(2.0 + 4.0)
    ops = dict(dev.device_ops())
    assert ops["k2"] == pytest.approx(5.0) and ops["k"] == pytest.approx(1.0)
    # device 0 idles in (11, 11.5) and (12, 13); device 1 never
    spans = [(10.9, 11.2, "poll/harvest"), (11.2, 11.3, "poll/idle"),
             (11.95, 12.5, "submit")]
    idle = dict(dev.idle_gaps(spans))
    assert idle == {"poll/harvest": pytest.approx(0.2),
                    "poll/idle": pytest.approx(0.1),
                    "submit": pytest.approx(0.5),
                    "untraced": pytest.approx(0.7)}


def test_kernel_base():
    assert devtrace.kernel_base(
        "void (anonymous namespace)::shift_conv_tf32x3_kernel<64, false>"
        "(float const*)") == "shift_conv_tf32x3_kernel"
    assert devtrace.kernel_base("Memset (Device)") == "Memset (Device)"


# ------------------------------------------------------------ FLOPs ----
def _meta(leaves):
    return {name: torch.empty(shape, device="meta")
            for name, shape, *_ in leaves}


@pytest.mark.parametrize("which", ["as_run", "small"])
def test_b2_flops_by_hand(which):
    cell = small_cell("b2-open") if which == "small" \
        else spec.load_cell("b2-open")
    cfg = cell.config
    want, (c, h, w) = 0, cfg["image"]
    c0 = cfg["stem_channels"]
    # the ResNet's convs, TF SAME: out = ceil(in / stride)
    size = -(-h // 2)                                          # stem
    want += 2 * c * c0 * cfg["stem_kernel"] ** 2 * size * size
    size = -(-size // 2)                                      # max pool
    cin = c0
    for stage, n in enumerate(cfg["resnet_blocks"]):
        cmid = c0 * 2 ** stage
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            out = -(-size // stride)
            if b == 0:
                want += 2 * cin * 4 * cmid * out * out          # shortcut
            want += 2 * cin * cmid * size * size                # 1x1
            want += 2 * cmid * cmid * 9 * out * out             # 3x3
            want += 2 * cmid * 4 * cmid * out * out             # 1x1
            cin, size = 4 * cmid, out
    labels, d0, (d1, d2) = cfg["n_labels"], cfg["label_dim"], cfg["gcn_dims"]
    want += 2 * labels * labels * d0 + 2 * labels * d0 * d1
    want += 2 * labels * labels * d1 + 2 * labels * d1 * d2 + 2 * labels * d2
    w = _meta(cell.model.layout(cfg))
    req = {"image": np.zeros(cfg["image"], np.float32),
           "label_embeddings": np.zeros((labels, d0), np.float32)}
    cell.reference._FLOPS.clear()
    got = cell.reference.flops(cfg, w, req)
    cell.reference._FLOPS.clear()
    assert got == want
    if which == "as_run":
        assert 62.5e9 < got < 63.1e9  # about 62.8 GFLOP a request


def _counts_graph(cell, counts, draws):
    cfg = cell.config
    mine = cell.model.label_graph(cfg, np.asarray(counts, np.float32),
                                  np.asarray(draws, np.float32))
    ref = cell.reference.correlation(cfg, torch.tensor(counts),
                                     torch.tensor(draws)).numpy()
    return mine, ref


def test_correlation_matrix_by_hand():
    """Eqs. 7-8 of ML-GCN on three labels: N = (100, 200, 1000); the pair
    draws give M_01 = floor(100 * 0.9^3) = 72, M_02 = floor(100 * 0.5^3) =
    12, M_12 = floor(200 * 0.8^3) = 102.  P(L_j | L_i) = M_ij / N_i:
    0.72, 0.12 from label 0; 0.36, 0.51 from label 1; 0.012, 0.102 from
    label 2.  At tau 0.4: A = [[0, 1, 0], [0, 0, 1], [0, 0, 0]]; with p 0.2:
    A' = [[0.8, 0.2, 0], [0, 0.8, 0.2], [0, 0, 0.8]]."""
    cell = spec.load_cell("b2-open")
    draws = [[0.3, 0.9, 0.5], [0.1, 0.7, 0.8], [0.6, 0.2, 0.4]]
    mine, ref = _counts_graph(cell, [100.5, 200.9, 1000.0], draws)
    a = np.array([[0.8, 0.2, 0], [0, 0.8, 0.2], [0, 0, 0.8]])
    d = 1 / np.sqrt(a.sum(1))
    want = d[:, None] * a.T * d[None, :]
    np.testing.assert_allclose(mine, want, rtol=1e-6)
    np.testing.assert_allclose(ref, want, rtol=1e-6)


def test_correlation_matrix_alike_on_both_sides():
    cell = spec.load_cell("b2-open")
    w = cell.model.make_weights(cell.config, 2**31 + 5, torch.device("cpu"))
    mine, ref = _counts_graph(cell, w["label_counts"].numpy(),
                              w["pair_draws"].numpy())
    np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=0)
    edges = (mine > 0).sum() - len(mine)
    assert 0 < edges < len(mine) ** 2 - len(mine)    # a graph, not a clique


# ---------------------------------------------------------- imports ----
def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = _imports(path) & ({"repro_torch", "gcvbench"} | BANNED)
    assert not found, f"{path.name} imports {found}"
    code = ("import importlib.util, sys\n"
            f"s = importlib.util.spec_from_file_location('r', {str(path)!r})\n"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & ({"repro_torch"} | BANNED)


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        found = _imports(path) & BANNED
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_banned_names_are_compared_whole():
    from gcvbench.harness import banned_modules
    for name in ("repro_torch_fake_probe", "jaxfake_probe"):
        sys.modules[name] = types.ModuleType(name)
    try:
        assert "repro_torch_fake_probe" not in banned_modules()
        assert "jaxfake_probe" not in banned_modules()
        sys.modules["repro.fake_probe"] = types.ModuleType("repro.fake_probe")
        assert "repro.fake_probe" in banned_modules()
    finally:
        for name in ("repro_torch_fake_probe", "jaxfake_probe",
                     "repro.fake_probe"):
            sys.modules.pop(name, None)


def test_command_refuses_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "b2-closed",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
