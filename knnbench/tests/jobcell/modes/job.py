"""Job mode: one whole operation a step, in a closed loop, as a user who
clusters a data set runs it.  The system is a call with no arguments that
runs the job once over the cell's points: here the port's
mutual-reachability MST, HDBSCAN's backbone, at ``min_samples`` of the
configuration.  ``job_s`` is the window over the jobs it finished."""

import time

END_TO_END = {"job_s": "s"}
REFERENCE = "mst"


def program(points, config, traffic, device):
    from petal_neighbors_tpu_torch.trees.boruvka import (
        mutual_reachability_mst)
    k = int(config["min_samples"])
    return lambda: mutual_reachability_mst(points, k, device=device)


def pool_size(config, traffic):
    return 0


def queries_per_step(config, traffic):
    return 1


def warm(system, pool, config, traffic, tracer):
    system()


def drive(system, pool, config, traffic, seconds, tracer):
    results = []
    t0 = t = time.perf_counter()
    while True:
        with tracer.span("knnbench.job"):
            results.append(system())
        t = time.perf_counter()
        tracer.step()
        if t - t0 >= seconds:
            break
    return {"results": results, "attempted": len(results),
            "metrics": {"job_s": (t - t0) / len(results)},
            "notes": {"jobs": len(results), "window_s": t - t0}}
