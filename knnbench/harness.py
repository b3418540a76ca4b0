"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the contract's result.

``run_cell`` is what ``run.py`` calls once it has found the card.  The
tests call it on the CPU at small sizes, with the index made by
``index_factory``, to drive every step of a run but the card's.

What a cell runs and how it is checked come from its files: the mode's
``program`` builds the system under test (the flat index where the mode
defines none), the mode's ``REFERENCE`` names the reference file (the
configuration's ``metric`` where it names none), and that file's own
``compare`` checks the window (``check.compare``, the k-NN check, where it
defines none).
"""

from __future__ import annotations

import functools
import gc
import time
from pathlib import Path

from . import check, data, spec
from .trace import NullTracer, Records, Tracer

#: where a traced run writes its profile, inside the checkout
TRACE_DIR = spec.ROOT.parent / "build" / "knnbench"


def program_index(points, config, device):
    """The system under test: the port's flat exact index."""
    from petal_neighbors_tpu_torch import BruteForce
    return BruteForce(points, config["metric"], device=device)


def index_program(points, config, traffic, device):
    """``program_index`` as a mode's ``program``."""
    return program_index(points, config, device)


def program_of(mode):
    """The mode's ``program(points, config, traffic, device)``, which
    builds the system its ``warm`` and ``drive`` call; the flat index
    where it defines none."""
    return getattr(mode, "program", index_program)


def reference_of(mode, config, root=None):
    """The reference file the mode names (``REFERENCE``), else the one of
    the configuration's metric."""
    return spec.reference(getattr(mode, "REFERENCE", config["metric"]), root)


def comparison(reference):
    """The check of a cell whose reference this is, called as
    ``(window, config, pool, limits, device, make_points) -> (numbers,
    wrong)``: the reference's own ``compare``, else the k-NN check against
    it."""
    own = getattr(reference, "compare", None)
    if own is not None:
        return own
    return functools.partial(check.compare, reference=reference)


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
             t_start=None, index_factory=None,
             trace_dir=TRACE_DIR, traffic_update=None):
    """Run cell ``name`` once.  Returns ``{"result": <the contract's last
    line>, "notes": <for the run's earlier lines>}``.  ``index_factory``
    ``(points, config, device)``, where given, builds the system in place
    of the cell's own program (the controls and planted faults of the
    tests and the calibration).  ``traffic_update`` changes traffic keys
    (the calibration's closed loops and sweeps)."""
    if t_start is None:
        t_start = time.perf_counter()
    import torch

    cell = spec.cell(name, root)
    cfg, trf = cell["config"], {**cell["traffic"], **(traffic_update or {})}
    mode = spec.mode(trf["mode"], root)
    compare = comparison(reference_of(mode, cfg, root))

    points = data.make_points(cfg, device, root)
    pool = data.make_pool(cfg, seed, mode.pool_size(cfg, trf), root)
    if index_factory is None:
        system = program_of(mode)(points, cfg, trf, device)
    else:
        system = index_factory(points, cfg, device)
    mode.warm(system, pool, cfg, trf, NullTracer())
    _sync(device)
    setup_s = time.perf_counter() - t_start

    notes = {"cell": name, "seed": seed, "setup_s": setup_s}
    if trace:
        tracer = Tracer(Path(trace_dir) / f"trace-{name}.json",
                        int(trf["trace_warmup_steps"]),
                        int(trf["trace_steps"]),
                        torch.device(device).type == "cuda")
        with tracer.stretch():
            window = mode.drive(system, pool, cfg, trf, seconds, tracer)
    else:
        window = mode.drive(system, pool, cfg, trf, seconds, NullTracer())
    _sync(device)
    dev = _device_info(device, int(cell["chips"]))
    notes.update(window["notes"])

    del system, points
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, wrong = compare(window, cfg, pool, cell["limits"], device,
                             lambda: data.make_points(cfg, device, root))
    notes["check_s"] = time.perf_counter() - t_check
    correct = wrong == 0 and all(v <= lim for v, lim in numbers.values())

    result = {"correct": correct, "attempted": window["attempted"],
              "failed": wrong}
    if trace:
        rec = Records.from_file(tracer.path, mode=trf["mode"], config=cfg,
                                traffic=trf,
                                queries_per_step=mode.queries_per_step(
                                    cfg, trf))
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
