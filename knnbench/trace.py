"""The traced run: spans around the calls into the program, a
``torch.profiler`` stretch of the window, and the records that the
per-layer metrics read.

The benchmark records its spans from its own files (``record_function``
around the calls it makes); the program records its own inside them.
The profiler traces CPU and CUDA activity over
``trace_steps`` steps of the window, after ``trace_warmup_steps`` steps
whose events it drops; the stretch's Chrome trace is written inside the
checkout and read back here.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from pathlib import Path

#: the span the benchmark puts around the time its driver waits for a
#: request's due time: the program is not working then
WAIT_SPAN = "knnbench.pace_wait"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STEP_PREFIX = "ProfilerStep#"


class NullTracer:
    """The untraced run: spans and steps cost nothing."""

    def span(self, name):
        return contextlib.nullcontext()

    def step(self):
        pass


class Tracer:
    """Spans by ``torch.profiler.record_function``; ``stretch()`` profiles
    the steps after ``warmup`` dropped ones, ``active`` of them, and writes
    their Chrome trace to ``path``; the card's activity with ``cuda``."""

    def __init__(self, path: Path, warmup: int, active: int, cuda: bool):
        self.path, self.warmup, self.active = Path(path), warmup, active
        self.cuda = cuda
        self._prof = None

    def span(self, name):
        from torch.profiler import record_function
        return record_function(name)

    def step(self):
        if self._prof is not None:
            self._prof.step()

    @contextlib.contextmanager
    def stretch(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists():
            self.path.unlink()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=self.warmup,
                                       active=self.active, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(self.path))) as prof:
            self._prof = prof
            try:
                yield
            finally:
                self._prof = None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _covered(merged, a, b) -> float:
    """Length of [a, b] that the merged intervals cover."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


class Records:
    """What a traced stretch recorded, for the per-layer readers.

    Times are microseconds on the trace's clock.  ``mode``, ``config`` and
    ``traffic`` describe the cell; ``steps`` and ``queries`` count the
    profiled steps and the queries they sent.  ``repair_probe`` is
    accepted from callers that pass it and read by nothing."""

    def __init__(self, events, *, mode, config, traffic, queries_per_step,
                 repair_probe=None):
        self.mode, self.config, self.traffic = mode, config, traffic
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        steps = [e for e in xs if str(e.get("name", "")).startswith(
            STEP_PREFIX) and e.get("cat") == "user_annotation"]
        self.steps = len(steps)
        self.queries = self.steps * queries_per_step
        if steps:
            self.t0 = min(float(e["ts"]) for e in steps)
            self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
        else:
            self.t0 = self.t1 = 0.0

        def inside(e):
            return (float(e["ts"]) < self.t1
                    and float(e["ts"]) + float(e["dur"]) > self.t0)

        self.device = [e for e in xs
                       if str(e.get("cat", "")).lower() in DEVICE_CATS
                       and inside(e)]
        self.host = [e for e in xs
                     if str(e.get("cat", "")).lower() in HOST_CATS
                     and not str(e.get("name", "")).startswith(STEP_PREFIX)
                     and inside(e)]
        self.waits = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                             for e in self.host if e.get("name") == WAIT_SPAN])
        self._busy = _merge([(max(self.t0, float(e["ts"])),
                              min(self.t1, float(e["ts"]) + float(e["dur"])))
                             for e in self.device])

    @classmethod
    def from_file(cls, path, **kw) -> "Records":
        """The records of a Chrome trace; none where no trace was written
        (a window too short for the stretch's steps)."""
        if not Path(path).is_file():
            return cls([], **kw)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        return cls(events, **kw)

    # -- quantities ---------------------------------------------------------
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_us(self) -> float:
        """Time in the stretch in which a kernel or a copy ran."""
        return sum(b - a for a, b in self._busy)

    def serving_us(self) -> float:
        """The stretch less the driver's waits for due times."""
        return self.window_us() - sum(
            max(0.0, min(self.t1, b) - max(self.t0, a)) for a, b in self.waits)

    def busy_serving_us(self) -> float:
        wait_busy = sum(_covered(self._busy, a, b) for a, b in self.waits)
        return self.busy_us() - wait_busy

    def kernels(self):
        return [e for e in self.device if str(e.get("cat")).lower() == "kernel"]

    def kernel_us(self) -> float:
        return sum(float(e["dur"]) for e in self.kernels())

    def kernels_launched_in(self, span_name: str):
        """Kernels whose launch on the host lies inside a span of that
        name, matched by the profiler's correlation ids."""
        spans = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in self.host if e.get("name") == span_name])
        if not spans:
            return []
        starts = [a for a, _ in spans]
        launch_ts = {}
        for e in self.host:
            if str(e.get("cat", "")).lower() in ("cuda_runtime",
                                                 "cuda_driver"):
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch_ts[c] = float(e["ts"])
        out = []
        for e in self.kernels():
            t = launch_ts.get((e.get("args") or {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(e)
        return out

    def span_count(self, span_name: str) -> int:
        return sum(1 for e in self.host if e.get("name") == span_name)

    # -- the contract's breakdown ------------------------------------------
    def top_device_ops(self, n: int = 10):
        tot = {}
        for e in self.device:
            name = str(e.get("name", "?"))[:200]
            tot[name] = tot.get(name, 0.0) + float(e["dur"]) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle time on the device by what the host was doing: each gap
        between device activity goes to the innermost host event open at
        its middle ("python" where none is)."""
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        str(e.get("name", "?"))[:200]) for e in self.host))
        starts = [h[0] for h in host]
        tot = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            # host events nest: the open one that started last is innermost
            label = "python"
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            tot[label] = tot.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]
