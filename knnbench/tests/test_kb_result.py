"""The run's last lines: the contract's JSON object on standard output,
the compared numbers on standard error; no result without a card or with
JAX loaded.  The card is a stub: the run itself goes to the CPU."""

from __future__ import annotations

import json

import pytest
import torch

from knnbench import harness
from knnbench import run as run_py


@pytest.fixture
def cpu_card(monkeypatch, tiny_root, tmp_path):
    """``run.py`` believes it has one card; its run goes to the CPU."""
    real = harness.run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run_py, "card_info", lambda: "stub card, 700 W")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **kw: real(
        *a, **kw, device="cpu", root=tiny_root, trace_dir=tmp_path))
    monkeypatch.setattr(harness.spec, "ROOT", tiny_root)


def _argv(cell, trace):
    return ["--workload", cell, "--seed", str(2**31 + 3), "--seconds",
            "0.3", "--trace", str(trace)]


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.single"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(cpu_card, capsys, cell, trace):
    assert run_py.main(_argv(cell, trace)) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:3] == ["correct", "attempted", "failed"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    if trace:
        assert set(last["device"]) >= {"busy_s", "window_s"}
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "setup_s" not in last["metrics"]
    else:
        e2e = "qps" if cell == "tiny.batch" else "query_p95_ms"
        assert set(last["metrics"]) == {e2e, "setup_s"}
        assert last["metrics"]["setup_s"]["value"] > 0
    checks = err.strip().splitlines()[-3:]
    assert [c.split()[1] for c in checks] == list(last["checks"])
    for line, (name, c) in zip(checks, last["checks"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"
    notes = [ln for ln in out.splitlines() if ln.startswith("knnbench notes ")]
    assert json.loads(notes[0][len("knnbench notes "):])["card"] == (
        "stub card, 700 W")


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_py.main(_argv("sift1m.batch-k10", 0)) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run_py.main(_argv("sift1m.batch-k10", 0)) != 0
    assert capsys.readouterr().out == ""


def test_jax_loaded_no_result(cpu_card, monkeypatch, capsys):
    monkeypatch.setattr(run_py, "forbidden_modules", lambda: ["jax"])
    assert run_py.main(_argv("tiny.batch", 0)) != 0
    out, err = capsys.readouterr()
    assert not any(ln.startswith("{") for ln in out.splitlines())
    assert "jax" in err
