"""The port's roofline (``repro_torch.launch.roofline``): the reference's
``test_roofline.py`` cases on the H100's data-sheet peaks, and the table
over records the port's dry run wrote."""
import json

from repro_torch.launch import roofline


def _rec(**over):
    base = {
        "arch": "llama3.2-1b", "shape": "train_4k", "kind": "train",
        "mesh": "16x16", "tag": "", "status": "ok", "multi_pod": False,
        "devices": 256,
        "flops_per_device": 4.6e13,
        "bytes_per_device": 2.8e12,
        "collective_bytes_per_device": {"total": 1.1e11},
        "params": 1.24e9, "active_params": 1.24e9,
    }
    base.update(over)
    return base


def test_h100_peaks():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert roofline.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_terms_and_dominant():
    r = roofline.analyze(_rec())
    assert abs(r["compute_s"] - 4.6e13 / 989e12) < 1e-12
    assert abs(r["memory_s"] - 2.8e12 / 3.35e12) < 1e-12
    assert abs(r["collective_s"] - 1.1e11 / 450e9) < 1e-12
    assert r["dominant"] == "memory"
    assert 0 < r["roofline_fraction"] < 1


def test_model_flops_train_vs_decode():
    tr = roofline.analyze(_rec())
    de = roofline.analyze(_rec(shape="decode_32k", kind="decode",
                               flops_per_device=1e12))
    # train: 6*N*D tokens=4096*256; decode: 2*N*128 tokens
    assert abs(tr["model_flops_per_device"]
               - 6 * 1.24e9 * 4096 * 256 / 256) < 1e3
    assert abs(de["model_flops_per_device"]
               - 2 * 1.24e9 * 128 / 256) < 1e3
    # the reference's roofline_fraction: ideal compute over the worst term
    ideal = tr["model_flops_per_device"] / 989e12
    assert abs(tr["roofline_fraction"] - ideal / tr["memory_s"]) < 1e-12


def test_moe_uses_active_params():
    r = roofline.analyze(_rec(params=671e9, active_params=37e9))
    assert abs(r["model_flops_per_device"]
               - 6 * 37e9 * 4096 * 256 / 256) < 1e6


def test_useful_ratio_flags_waste():
    wasteful = roofline.analyze(_rec(flops_per_device=4.6e14))
    tight = roofline.analyze(_rec(flops_per_device=3.2e13))
    assert wasteful["useful_flops_ratio"] < tight["useful_flops_ratio"]
    assert "useful" in wasteful["note"] or "bound" in wasteful["note"]


def test_collective_bound_note():
    r = roofline.analyze(_rec(collective_bytes_per_device={"total": 1e13}))
    assert r["dominant"] == "collective" and "collective" in r["note"]


def test_markdown_and_na_rows(tmp_path):
    ok = roofline.analyze(_rec())
    rows = [{"status": "ok", **ok},
            {"arch": "qwen2-72b", "shape": "long_500k", "status": "n/a"}]
    md = roofline.to_markdown(rows)
    assert "n/a" in md and "llama3.2-1b" in md
    # load() roundtrip through files: failed records are left out, the
    # multi-pod ones only under pod2
    (tmp_path / "a.json").write_text(json.dumps(_rec()))
    (tmp_path / "b.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "status": "fail"}))
    (tmp_path / "c.json").write_text(json.dumps(_rec(multi_pod=True)))
    out = roofline.load(str(tmp_path))
    assert len(out) == 1 and out[0]["dominant"] == "memory"
    assert len(roofline.load(str(tmp_path), pod="pod2")) == 1


def test_main_renders_markdown(tmp_path, capsys):
    (tmp_path / "a.json").write_text(json.dumps(_rec()))
    roofline.main(["--in", str(tmp_path), "--md", "--json-out",
                   str(tmp_path / "rows.out")])
    assert "| llama3.2-1b | train_4k |" in capsys.readouterr().out
    assert json.loads((tmp_path / "rows.out").read_text())[0][
        "arch"] == "llama3.2-1b"


def test_cells_table_lists_every_record(tmp_path, capsys):
    rec = _rec(memory={"peak_bytes": 3 * 2**30},
               collective_bytes_per_device={"total": 1.1e11})
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "status": "fail",
         "error": "TypeError: boom"}))
    (tmp_path / "c.json").write_text(json.dumps(
        {"arch": "qwen2-72b", "shape": "long_500k", "status": "n/a",
         "reason": "full-attention arch"}))
    roofline.main(["--in", str(tmp_path), "--cells"])
    out = capsys.readouterr().out
    assert "| llama3.2-1b | train_4k | ok | 3.00 | 4.600e+13 |" in out
    assert "TypeError: boom" in out and "full-attention arch" in out
