"""Where fold's time goes on the card: torch.profiler over ``knn_fold``'s
two paths at the route's repair shapes on the SIFT-1M index.

    python3 fold_profile.py

Builds the kernels, makes chip_smoke.py's SIFT index (1M x 128 f32, seed
7) and its centered queries, and for each (queries, k_scan) of SHAPES and
each path ("select", "stream"): 3 warm calls, then 10 profiled ones.
Prints the card (nvidia-smi name and power limit), then per shape and path
the wall per call (host clock through a synchronize), the device time per
call (the sum over the trace's CUDA events) and the profiler's table by
device time.  Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: (queries, k_scan): the route's repairs at SIFT k=10, 100 and 1000
SHAPES = ((5, 18), (187, 108), (56, 1008))
CALLS = 10


def main() -> int:
    if not torch.cuda.is_available():
        print("fold_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import petal_neighbors_tpu_torch as pt
    from petal_neighbors_tpu_torch.ops.cuda import _build
    from petal_neighbors_tpu_torch.ops.cuda import knn_kernel as kk

    print(cs.smi_line(), flush=True)
    _build.build_all()
    rng = np.random.default_rng(cs.SEED)
    points = rng.random((cs.N, cs.DIM), dtype=np.float32) * 255.0
    queries = rng.random((cs.N_Q, cs.DIM), dtype=np.float32) * 255.0
    index = pt.BruteForce.euclidean(points)
    qc = torch.from_numpy(queries).cuda() - index._center
    for q, k in SHAPES:
        for path in ("select", "stream"):
            def call():
                return kk.knn_fold(index._pts, qc[:q], index._norms, k=k,
                                   path=path)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(CALLS):
                    call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / CALLS
            device = sum(e.device_time for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            print(f"== q={q} k_scan={k} {path}: wall {wall * 1e3:.3f} ms a "
                  f"call, device {device / CALLS / 1e3:.3f} ms a call",
                  flush=True)
            print(prof.key_averages().table(sort_by="device_time_total",
                                            row_limit=12), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
