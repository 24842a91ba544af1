"""The cells at a size a CPU test can hold: every width cut, the same
code paths.  Only the tests (``bench/test_bench_*.py``) use these; the
benchmark runs the configurations as their files state them."""
from __future__ import annotations

from gcvbench import spec

CONFIGS = {
    "b2-mlgcn": dict(image=[3, 32, 32], stem_channels=8,
                     resnet_blocks=[1, 1, 1, 1], n_labels=8, label_dim=16,
                     gcn_dims=[32, 256]),
}
TRAFFIC = {"pool": 16, "rate_per_s": 50.0, "deadline_ms": 200.0,
           "clients_per_chip": 4}


def small_cell(name: str, root=spec.ROOT) -> spec.Cell:
    """Cell ``name`` with its configuration's widths and its traffic's
    load cut to CPU-test size."""
    cell = spec.load_cell(name, root)
    cell.config = dict(cell.config, **CONFIGS.get(cell.config_name, {}))
    trf = dict(cell.traffic)
    for key, value in TRAFFIC.items():
        if key in trf:
            trf[key] = value
    trf["max_batch_per_chip"] = 4 if cell.chips == 1 else 2
    cell.traffic = trf
    return cell
