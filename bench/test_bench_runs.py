"""CPU tests that drive whole runs of the harness at test size
(``gcvbench.small``): the references against the port's plans, sound runs
that come out correct, the control and planted faults that come out not
correct, a run that loads no JAX, and a cell added by new files alone."""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gcvbench import compare, harness, spec
from gcvbench import traffic as gen
from gcvbench.small import small_cell

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
SEED = 2**31 + 1234


def _small(cell):
    """The cell at test size; ``<cell>@4`` is the cell spread over four
    cards (on the CPU, four engine devices), 2 rows a card, which the
    harness's multi-card path serves with ``gcv.serve(devices=...)``."""
    name, _, chips = cell.partition("@")
    out = small_cell(name)
    if chips:
        out.chips = int(chips)
        out.traffic = dict(out.traffic, max_batch_per_chip=2)
    return out


def _run(cell, plant=None, seconds=1.0):
    return harness.run_cell(_small(cell), SEED, seconds, False,
                            t_start=time.perf_counter(), device_type="cpu",
                            plant=plant)


# ------------------------------------------- reference against the port --
@pytest.mark.parametrize("config", ["b2-mlgcn"])
def test_reference_matches_the_ports_cpu_plan(config):
    from repro_torch import gcv
    cell = small_cell({"b2-mlgcn": "b2-closed"}[config])
    cfg, cpu = cell.config, torch.device("cpu")
    w = cell.model.make_weights(cfg, 7, cpu)
    pool = cell.model.make_requests(cfg, 7, 6, cpu, w)
    fn, example = cell.model.make_model(cfg, w)
    want = cell.reference.forward(cfg, w, pool, device=cpu)
    model = gcv.compile(fn, example(), device="cpu")
    for req, ref in zip(pool, want):
        got = [o.numpy() for o in model.run(**req)]
        assert compare.gap(got, ref) < 1e-5


# ------------------------------------------------- correct, and not ----
@pytest.mark.parametrize("cell", ["b2-open", "b2-closed", "b2-closed@4"])
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m.name for m in spec.load_cell(cell.split("@")[0])
            .reported(False)}
    assert set(out["metrics"]) == want


def test_open_window_measures_what_is_due_inside_it():
    from gcvbench import devtrace
    cell = _small("b2-open")
    served = harness.start(cell, SEED, "cpu")
    before = harness._counters(served.eng)
    win, c0, c1 = harness.measure(served, cell, cell.traffic, SEED, 1.0,
                                  devtrace.NullTracer())
    assert len(win.reqs) > 0 and win.drained
    want = gen.arrival_offsets(cell.traffic["rate_per_s"], 1.0, SEED)
    assert np.allclose(np.asarray(win.t_due) - win.t0, want)
    # the counters are read as the window opens and as it closes
    assert c0["dispatches"] == before["dispatches"]
    assert c1["completed"] - c0["completed"] <= len(win.reqs)


def _wrap(eng, alter):
    """Break the timed path where answers are produced: ``alter(outs,
    bucket)`` edits each batched runner's outputs."""
    runner = eng._runner

    def broken(task, bucket):
        run = runner(task, bucket)

        def call(**inputs):
            outs = [o.clone() for o in run(**inputs)]
            alter(outs, bucket, eng._ndev)
            return tuple(outs)
        call.input_specs = run.input_specs
        return call
    eng._runner = broken


def _answer_altered(outs, bucket, ndev):
    outs[0][0] *= 1.01                       # one answer a batch, 1% off


def _half_left_out(outs, bucket, ndev):
    half = bucket // 2
    for o in outs:                           # the second half never run:
        o[half:2 * half] = o[:half]          # the first half's rows stand in


def _exchange_left_out(outs, bucket, ndev):
    for o in outs:                           # rows of every card but the
        o[bucket // ndev:] = 0               # first never gathered


@pytest.mark.parametrize("cell,fault", [
    ("b2-closed", _answer_altered), ("b2-closed", _half_left_out),
    ("b2-open", _answer_altered), ("b2-open", _half_left_out),
    ("b2-closed@4", _exchange_left_out)],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_planted_fault_is_not_correct(cell, fault):
    out = _run(cell, plant=lambda eng: _wrap(eng, fault))
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", ["b2-closed", "b2-open"])
def test_control_is_not_correct(cell):
    checks = harness.control(small_cell(cell), SEED, "cpu")
    (c,) = checks.values()
    assert c["value"] > c["limit"], c


# ------------------------------------------------------------ imports --
def test_run_loads_no_jax_nor_the_jax_package():
    code = ("import sys, time\n"
            f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n"
            "from gcvbench import harness\n"
            "from gcvbench.small import small_cell\n"
            "out = harness.run_cell(small_cell('b2-closed'), 3, 0.5, False, "
            "t_start=time.perf_counter(), device_type='cpu')\n"
            "print(out['correct'], harness.banned_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


# ------------------------------------------------------- driven by data --
TINY_CONFIG = {"name": "tiny-mlp", "dtype": "float32", "features": 6,
               "hidden": 12, "classes": 3}
TINY_MODEL = '''
import math
import numpy as np
import torch


def make_weights(cfg, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    f, h, c = cfg["features"], cfg["hidden"], cfg["classes"]
    flat = torch.randn(f * h + h * c, generator=gen, device=device)
    return {"w1": flat[:f * h].view(f, h) / math.sqrt(f),
            "w2": flat[f * h:].view(h, c) / math.sqrt(h)}


def make_requests(cfg, seed, n, device, weights):
    x = np.random.default_rng(seed).standard_normal((n, cfg["features"]))
    return [{"x": x[i].astype(np.float32)} for i in range(n)]


def make_model(cfg, w):
    def model(x):
        return torch.relu(x @ w["w1"]) @ w["w2"]
    return model, lambda: {"x": torch.zeros(cfg["features"])}
'''
TINY_REFERENCE = '''
import numpy as np
import torch

CHECK = {"name": "out_rel_err", "limit": 1e-5}


def forward(cfg, w, requests, *, device, tf32=False):
    x = torch.from_numpy(np.stack([r["x"] for r in requests])).to(device)
    y = torch.relu(x @ w["w1"]) @ w["w2"]
    return [(v,) for v in y.cpu().numpy()]


def flops(cfg, w, request):
    return 2 * cfg["features"] * cfg["hidden"] + 2 * cfg["hidden"] * cfg["classes"]
'''
TINY_METRIC = '''
def read(run):
    return 100.0 * float(run.completed_in_window().mean())
'''


def _digests(root: pathlib.Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_config_traffic_and_metric_by_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy)
    b = copy / "bench"
    (b / "configs" / "tiny-mlp.json").write_text(json.dumps(TINY_CONFIG))
    (b / "configs" / "tiny-mlp.py").write_text(TINY_MODEL)
    (b / "reference" / "tiny-mlp.py").write_text(TINY_REFERENCE)
    (b / "traffic" / "closed_tiny.json").write_text(json.dumps(
        {"loop": "closed", "clients_per_chip": 3, "scheduler": "fifo",
         "pipeline_depth": 2, "max_batch_per_chip": 2, "pool": 8}))
    (b / "metrics" / "answered_share.tiny.py").write_text(TINY_METRIC)
    # the one edit a later change makes: new entries in BENCHMARK.json
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mlp", "source": "a test",
                             "file": "bench/configs/tiny-mlp.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-closed", "config": "tiny-mlp",
                               "traffic": "closed_tiny", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "answered_share.tiny", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving engine",
                               "moves": "throughput_rps",
                               "workloads": ["tiny-closed"]})
    for m in bench["end_to_end"]:
        if m["name"] == "throughput_rps":
            m["workloads"].append("tiny-closed")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(copy)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {pathlib.Path("BENCHMARK.json")}
    code = ("import json, sys, time\n"
            f"sys.path[:0] = [{str(b)!r}, {str(ROOT / 'src')!r}]\n"
            "from gcvbench import harness, spec\n"
            "cell = spec.load_cell('tiny-closed')\n"
            "for trace in (False, True):\n"
            "    out = harness.run_cell(cell, 5, 0.5, trace, "
            "t_start=time.perf_counter(), device_type='cpu')\n"
            "    print(json.dumps({k: out[k] for k in "
            "('correct', 'metrics')}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    plain, traced = (json.loads(x) for x in
                     res.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"throughput_rps", "setup_s"}
    assert traced["metrics"]["answered_share.tiny"]["value"] > 0
