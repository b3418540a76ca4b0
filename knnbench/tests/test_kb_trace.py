"""The traced run's records and the per-layer readers, on a Chrome trace
made by hand."""

from __future__ import annotations

import json

import pytest

from kb_helpers import TINY
from knnbench import roofline, spec
from knnbench.trace import WAIT_SPAN, Records

readers = spec.metric_readers()
#: a span of the program's, around the kernels it launches
REPAIR_SPAN = "petal.route.repair"


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def batch_trace():
    """Two steps of 100 µs.  Step 1: a kernel 10-40, a repair span 50-70
    on the host launching a kernel that runs 60-80, a copy 85-95.  Step 2:
    one kernel 110-190.  Events outside the steps are left out."""
    return [
        ev("user_annotation", "ProfilerStep#3", 0, 100),
        ev("user_annotation", "ProfilerStep#4", 100, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 2, corr=1),
        ev("kernel", "bcap", 10, 30, corr=1),
        ev("user_annotation", REPAIR_SPAN, 50, 20),
        ev("cpu_op", "aten::nonzero", 52, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=2),
        ev("kernel", "fold", 60, 20, corr=2),
        ev("gpu_memcpy", "Memcpy DtoH", 85, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 105, 1, corr=3),
        ev("kernel", "bcap", 110, 80, corr=3),
        ev("kernel", "outside", 300, 10, corr=4),
        ev("cpu_op", "aten::to", 40, 19),
    ]


def records(events, mode="batch", qps=10):
    return Records(events, mode=mode, config=TINY,
                   traffic={"k": 10}, queries_per_step=qps)


def test_batch_records():
    rec = records(batch_trace())
    assert (rec.steps, rec.queries, rec.window_us()) == (2, 20, 200.0)
    assert rec.busy_us() == 30 + 20 + 10 + 80
    assert rec.kernel_us() == 130
    assert [e["name"] for e in rec.kernels_launched_in(REPAIR_SPAN)] == [
        "fold"]
    assert readers["device_idle_pct.batch"].read(rec) == pytest.approx(30.0)
    assert readers["route_repair_ms_per_batch.batch"].read(
        rec) == pytest.approx(0.010)
    want = 100 * roofline.least_seconds(20, 8192, 40, 10) / 130e-6
    assert readers["knn_roofline_pct.batch"].read(rec) == pytest.approx(want)
    for m in ("device_idle_pct.single", "launches_per_query.single"):
        assert readers[m].read(rec) is None
    ops = dict(rec.top_device_ops())
    assert ops == pytest.approx({"bcap": 110e-6, "fold": 20e-6,
                                 "Memcpy DtoH": 10e-6})
    # gaps: 0-10 (mid 5: the launch 5-7), 40-60 (mid 50: aten::to open
    # 40-59, the repair span opened at 50 is innermost), 80-85, 95-110 and
    # 190-200 with no host event open at their middles
    gaps = dict(rec.idle_gaps())
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["python"] == pytest.approx((5 + 15 + 10) * 1e-6)
    assert gaps[REPAIR_SPAN] == pytest.approx(20e-6)


def test_no_device_events_reads_nothing():
    """A trace without the card's activity gives no device metric, never
    an idle share of 100% or a roofline of 0."""
    evs = [e for e in batch_trace() if e["cat"] not in ("kernel",
                                                        "gpu_memcpy")]
    for mode in ("batch", "single"):
        rec = records(evs, mode=mode, qps=1)
        assert all(r.read(rec) is None for r in readers.values()), mode


def test_single_records_leave_out_the_waits():
    evs = [
        ev("user_annotation", "ProfilerStep#1", 0, 100),
        ev("user_annotation", WAIT_SPAN, 0, 40),
        ev("user_annotation", "knnbench.query", 40, 60),
        ev("gpu_memcpy", "Memcpy HtoD", 45, 5),
        ev("kernel", "bcap", 50, 30),
        ev("gpu_memcpy", "Memcpy DtoH", 90, 5),
        ev("user_annotation", "ProfilerStep#2", 100, 100),
        ev("user_annotation", WAIT_SPAN, 100, 50),
        ev("user_annotation", "knnbench.query", 150, 50),
        ev("kernel", "capped", 160, 20),
    ]
    rec = records(evs, mode="single", qps=1)
    assert rec.serving_us() == 110.0
    assert rec.busy_serving_us() == 60.0
    assert readers["device_idle_pct.single"].read(rec) == pytest.approx(
        100 * 50 / 110)
    assert readers["launches_per_query.single"].read(rec) == 2.0
    assert readers["device_idle_pct.batch"].read(rec) is None
    assert dict(rec.idle_gaps())[WAIT_SPAN] == pytest.approx((45 + 65) * 1e-6)


def test_from_file(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": batch_trace()}))
    rec = Records.from_file(path, mode="batch", config=TINY,
                            traffic={"k": 10}, queries_per_step=10)
    assert rec.busy_us() == 140.0


def test_no_trace_file_reads_nothing(tmp_path):
    rec = Records.from_file(tmp_path / "missing.json", mode="batch",
                            config=TINY, traffic={"k": 10},
                            queries_per_step=10)
    assert rec.steps == 0 and rec.window_us() == 0
    assert all(r.read(rec) is None for r in readers.values())
