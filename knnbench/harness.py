"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the contract's result.

``run_cell`` is what ``run.py`` calls once it has found the card.  The
tests call it on the CPU at small sizes, with the index made by
``index_factory``, to drive every step of a run but the card's.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path

from . import check, data, spec
from .trace import NullTracer, Records, RepairProbe, Tracer

#: where a traced run writes its profile, inside the checkout
TRACE_DIR = spec.ROOT.parent / "build" / "knnbench"


def program_index(points, config, device):
    """The system under test: the port's flat exact index."""
    from petal_neighbors_tpu_torch import BruteForce
    return BruteForce(points, config["metric"], device=device)


class ReferenceIndex:
    """The plain reference put in the program's place, with the program's
    two query calls: the calibration's control (``precision="tf32"``)."""

    def __init__(self, reference, points, precision):
        self.reference, self.points = reference, points
        self.precision = precision

    def query_batch(self, queries, k):
        import torch
        qs = torch.as_tensor(queries).to(self.points.device)
        d, i = self.reference.search(self.points, qs, k,
                                     precision=self.precision)
        return d, i

    def query(self, point, k):
        d, i = self.query_batch(point[None, :], k)
        return i[0].cpu().numpy(), d[0].cpu().numpy()


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _device_info(device, chips):
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i) for i in range(chips)))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def run_cell(name, seed, seconds, trace, *, device="cuda", root=None,
             t_start=None, index_factory=program_index,
             trace_dir=TRACE_DIR, traffic_update=None):
    """Run cell ``name`` once.  Returns ``{"result": <the contract's last
    line>, "notes": <for the run's earlier lines>}``.  ``traffic_update``
    changes traffic keys (the calibration's closed loops and sweeps)."""
    if t_start is None:
        t_start = time.perf_counter()
    import torch

    cell = spec.cell(name, root)
    cfg, trf = cell["config"], {**cell["traffic"], **(traffic_update or {})}
    mode = spec.mode(trf["mode"], root)
    reference = spec.reference(cfg["metric"], root)

    points = data.make_points(cfg, device)
    pool = data.make_pool(cfg, seed, mode.pool_size(cfg, trf))
    index = index_factory(points, cfg, device)
    mode.warm(index, pool, cfg, trf, NullTracer())
    _sync(device)
    setup_s = time.perf_counter() - t_start

    notes = {"cell": name, "seed": seed, "setup_s": setup_s}
    if trace:
        tracer = Tracer(Path(trace_dir) / f"trace-{name}.json",
                        int(trf["trace_warmup_steps"]),
                        int(trf["trace_steps"]),
                        torch.device(device).type == "cuda")
        with RepairProbe() as probe, tracer.stretch():
            window = mode.drive(index, pool, cfg, trf, seconds, tracer)
    else:
        window = mode.drive(index, pool, cfg, trf, seconds, NullTracer())
    _sync(device)
    dev = _device_info(device, int(cell["chips"]))
    notes.update(window["notes"])
    if trace and probe.installed:
        notes["repair_calls"] = probe.calls
        notes["repaired_per_1000_queries"] = (
            1000.0 * probe.repaired() / window["attempted"])

    del index, points
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, wrong = check.compare(window, cfg, pool, reference,
                                   cell["limits"], device)
    correct = wrong == 0 and all(v <= lim for v, lim in numbers.values())

    result = {"correct": correct, "attempted": window["attempted"],
              "failed": wrong}
    if trace:
        rec = Records.from_file(tracer.path, mode=trf["mode"], config=cfg,
                                traffic=trf,
                                queries_per_step=mode.queries_per_step(
                                    cfg, trf),
                                repair_probe=probe.installed)
        metrics = {}
        for mname, reader in spec.metric_readers(root).items():
            value = reader.read(rec)
            if value is not None:
                metrics[mname] = {"value": float(value), "unit": reader.UNIT}
        result["metrics"] = metrics
        dev["busy_s"] = rec.busy_us() * 1e-6
        dev["window_s"] = rec.window_us() * 1e-6
        result["device"] = dev
        result["breakdown"] = {"device_ops": rec.top_device_ops(),
                               "idle_gaps": rec.idle_gaps()}
        notes["traced_steps"] = rec.steps
    else:
        metrics = {m: {"value": float(window["metrics"][m]), "unit": unit}
                   for m, unit in mode.END_TO_END.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        result["metrics"] = metrics
        result["device"] = dev
    result["checks"] = {m: {"value": v, "limit": lim}
                        for m, (v, lim) in numbers.items()}
    return {"result": result, "notes": notes}
