"""The comparison that decides ``correct``: a run of the port passes, and
a run whose timed path is broken, or whose answers come from the control
(the reference in TF32), does not.  The harness's look for a card is
skipped: each run drives the rest of a run on the CPU at a tiny size."""

from __future__ import annotations

import pytest

from knnbench import harness, spec


class Faulty:
    """The port's index with a fault planted where its answers are made."""

    def __init__(self, index, fault):
        self.index, self.fault, self.last = index, fault, None

    def query_batch(self, queries, k):
        d, i = self.index.query_batch(queries, k)
        if self.fault == "stale":
            # the state left unchanged: the previous call's answers
            out, self.last = self.last or (d, i), (d, i)
            return out
        d, i = d.clone(), i.clone()
        if self.fault == "half_batch":
            # half of the batch left out: the rest answered twice
            h = (d.shape[0] + 1) // 2
            d[h:], i[h:] = d[:d.shape[0] - h], i[:d.shape[0] - h]
        elif self.fault == "id_altered":
            i[0, 0] = (i[0, 0] + 1) % 8192
        elif self.fault == "distance_altered":
            d[0, 3] = d[0, 3] * (1 + 1e-3)
        return d, i

    def query(self, point, k):
        d, i = self.query_batch(point[None, :], k)
        return i[0].cpu().numpy(), d[0].cpu().numpy()


def run(root, cell, seed, factory, tmp_path):
    return harness.run_cell(cell, seed, 0.3, False, device="cpu", root=root,
                            index_factory=factory,
                            trace_dir=tmp_path)["result"]


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.single"])
def test_the_port_passes(tiny_root, tmp_path, cell):
    r = run(tiny_root, cell, 2**31 + 7, harness.program_index, tmp_path)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["checks"]["rank_gap"]["value"] < 1e-6


FAULTS = [("tiny.batch", f) for f in ("stale", "half_batch", "id_altered",
                                      "distance_altered")] + [
    ("tiny.single", f) for f in ("stale", "id_altered", "distance_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_root, tmp_path, cell,
                                            fault):
    def factory(points, cfg, device):
        return Faulty(harness.program_index(points, cfg, device), fault)

    r = run(tiny_root, cell, 11, factory, tmp_path)
    assert not r["correct"] and r["failed"] > 0, (fault, r["checks"])


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.single"])
def test_the_control_is_not_correct(tiny_root, tmp_path, cell, seed):
    ref = spec.reference("euclidean", tiny_root)

    def control(points, cfg, device):
        return harness.ReferenceIndex(ref, points, "tf32")

    r = run(tiny_root, cell, seed, control, tmp_path)
    assert not r["correct"], r["checks"]
    # the control's gaps are at least ten times the port's
    assert r["checks"]["rank_gap"]["value"] > 1e-5


def test_the_reference_in_float64_passes(tiny_root, tmp_path):
    ref = spec.reference("euclidean", tiny_root)
    r = run(tiny_root, "tiny.batch", 4,
            lambda p, c, d: harness.ReferenceIndex(ref, p, "float64"),
            tmp_path)
    assert r["correct"]
    assert r["checks"]["rank_gap"]["value"] < 1e-6


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.single"])
def test_on_the_card(card, tiny_root, tmp_path, cell):
    """The same on the card: the port passes, the control and a planted
    fault do not, and a traced run reads the device's activity."""
    r = harness.run_cell(cell, 2**31 + 99, 0.5, True, device=card,
                         root=tiny_root, trace_dir=tmp_path)["result"]
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert r["breakdown"]["device_ops"]
    ref = spec.reference("euclidean", tiny_root)
    for factory in (lambda p, c, d: harness.ReferenceIndex(ref, p, "tf32"),
                    lambda p, c, d: Faulty(harness.program_index(p, c, d),
                                           "id_altered")):
        r = harness.run_cell(cell, 5, 0.3, False, device=card,
                             root=tiny_root, index_factory=factory,
                             trace_dir=tmp_path)["result"]
        assert not r["correct"], r["checks"]
