"""The harness finds every cell, configuration, traffic mix, mode,
reference and metric by its name, and a new one is a new file."""

from __future__ import annotations

import json
import pytest

from kb_helpers import CHECKOUT, write_json
from knnbench import harness, spec

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_every_benchmark_name_has_its_file():
    for c in BENCH["configs"]:
        cfg = spec.config(c["name"])
        assert (CHECKOUT / c["file"]) == spec.ROOT / "configs" / f"{c['name']}.json"
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            want = w[key]
            got = cell[f"{key}_name"] if key in ("config", "traffic") \
                else cell[key]
            assert got == want, (w["name"], key)
        spec.mode(cell["traffic"]["mode"])
        spec.reference(cell["config"]["metric"])
        assert set(cell["limits"]) == {"rank_gap", "id_gap", "bad_ids"}
    readers = spec.metric_readers()
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


def test_every_file_is_named_in_the_benchmark():
    assert set(spec.names("workloads", ".json")) == {
        w["name"] for w in BENCH["workloads"]}
    assert set(spec.names("configs", ".json")) == {
        c["name"] for c in BENCH["configs"]}
    assert set(spec.names("traffic", ".json")) == {
        w["traffic"] for w in BENCH["workloads"]}


def test_end_to_end_metrics_come_from_the_modes():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        mode = spec.mode(spec.cell(w["name"])["traffic"]["mode"])
        for name, unit in mode.END_TO_END.items():
            assert e2e[name]["unit"] == unit
            assert w["name"] in e2e[name].get("workloads", [w["name"]])


def test_bad_names_are_refused(tiny_root):
    for bad in ("../configs/tiny", "a b", "", "x/y"):
        with pytest.raises(ValueError):
            spec.cell(bad, tiny_root)
    with pytest.raises(FileNotFoundError):
        spec.cell("no.such.cell", tiny_root)


def test_new_files_need_no_edit(tiny_root, tmp_path):
    """A cell on a new configuration and a new traffic mix, and a new
    per-layer metric, run through an unchanged ``run.py`` and harness."""
    run_py = (tiny_root / "run.py").read_bytes()
    cfg = json.loads((tiny_root / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny2", d=24, values={"distribution": "uniform",
                                           "low": 0.0, "high": 1.0})
    write_json(tiny_root / "configs" / "tiny2.json", cfg)
    write_json(tiny_root / "traffic" / "batch-k5-small.json",
               {"mode": "batch", "k": 5, "batch": 32, "pool": 96,
                "warmup_steps": 1, "trace_warmup_steps": 1,
                "trace_steps": 3})
    write_json(tiny_root / "workloads" / "tiny2.batch-k5.json",
               {"config": "tiny2", "traffic": "batch-k5-small", "chips": 1,
                "why": "new", "limits": {"rank_gap": 1e-5, "id_gap": 1e-5,
                                         "bad_ids": 0}})
    (tiny_root / "metrics" / "steps_traced.new.py").write_text(
        "UNIT = 'steps'\n\n\ndef read(rec):\n    return rec.steps or None\n")
    assert "tiny2.batch-k5" in spec.names("workloads", ".json", tiny_root)
    assert "steps_traced.new" in spec.metric_readers(tiny_root)
    for trace in (0, 1):
        run = harness.run_cell("tiny2.batch-k5", 5, 1.0, trace, device="cpu",
                               root=tiny_root, trace_dir=tmp_path)
        r = run["result"]
        assert r["correct"], r["checks"]
        if trace:
            assert r["metrics"]["steps_traced.new"] == {"value": 3.0,
                                                        "unit": "steps"}
        else:
            assert set(r["metrics"]) == {"qps", "setup_s"}
    assert (tiny_root / "run.py").read_bytes() == run_py
    assert (tiny_root / "run.py").read_bytes() == (
        CHECKOUT / "knnbench" / "run.py").read_bytes()
