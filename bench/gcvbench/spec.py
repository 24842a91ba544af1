"""Find everything a cell needs by the names in ``BENCHMARK.json``.

The harness is driven by data: a cell names a configuration and a traffic
mix, and each of those, and each metric, lives in files of its own that
are found by name, so a later change adds a cell, a mix, a configuration
or a metric by adding files and entries, never by editing one:

  * ``bench/configs/<config>.json``   the configuration as it is run
    (the entry's ``file``);
  * ``bench/configs/<config>.py``     its weights, requests and model
    function, as a user of ``gcv.compile`` would write them;
  * ``bench/reference/<config>.py``   its plain PyTorch reference and the
    limits of the comparison that decides ``correct``;
  * ``bench/traffic/<traffic>.json``  the traffic mix's parameters, read
    by the one generator in ``gcvbench/traffic.py``;
  * ``bench/metrics/<metric>.py``     one reader per metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: pathlib.Path, name: str):
    """Import the Python file at ``path`` under a private module name (the
    files are named after configurations and metrics, which may hold ``-``
    and ``.``)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file missing: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _private(kind: str, name: str) -> str:
    return f"gcvbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: list | None
    reader: object                    # module with ``read(run)``

    def reported_in(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    chips: int
    config_name: str
    config: dict                      # the configuration file's contents
    model: object                     # bench/configs/<config>.py
    reference: object                 # bench/reference/<config>.py
    traffic: dict                     # bench/traffic/<traffic>.json
    metrics: list                     # every Metric of the benchmark

    def reported(self, trace: bool) -> list[Metric]:
        """The metrics this cell's result line carries: the end-to-end
        ones without tracing, the per-layer ones with it."""
        return [m for m in self.metrics
                if m.end_to_end != trace and m.reported_in(self.name)]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    bdir = root / "bench"
    model = load_module(bdir / "configs" / f"{w['config']}.py",
                        _private("config", w["config"]))
    reference = load_module(bdir / "reference" / f"{w['config']}.py",
                            _private("reference", w["config"]))
    traffic = json.loads(
        (bdir / "traffic" / f"{w['traffic']}.json").read_text())
    metrics = []
    for group, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in bench[group]:
            metrics.append(Metric(
                m["name"], m["unit"], e2e, m.get("workloads"),
                load_module(bdir / "metrics" / f"{m['name']}.py",
                            _private("metric", m["name"]))))
    return Cell(name, int(w["chips"]), w["config"], config, model,
                reference, traffic, metrics)
