"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell of this benchmark can have (the cells run on
one card, so no exchange between cards can be left out)."""
import pytest
import torch

from benchmark import run, spec
from minisched_tpu_torch.ops import pipeline
from minisched_tpu_torch.state.store import ClusterStore

from .tiny import tiny_run

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _unchanged(fn):
    """The assignment returns the free capacity it was given."""
    def step(scores, requests, free0, *a, **kw):
        return fn(scores, requests, free0, *a, **kw)._replace(
            free_after=free0.clone())
    return step


def _altered(fn):
    """Each assigned pod's node is replaced by the row before it."""
    def step(scores, requests, free0, *a, **kw):
        r = fn(scores, requests, free0, *a, **kw)
        shift = r.assigned & (r.chosen > 0)
        return r._replace(chosen=torch.where(shift, r.chosen - 1, r.chosen))
    return step


def _half_bound(bind_pods):
    """The bulk bind commits the first half of a batch and reports all."""
    def bind(self, assignments):
        assignments = list(assignments)
        bind_pods(self, assignments[:len(assignments) // 2])
        return [k for k, _n in assignments]
    return bind


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_the_batch_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(monkeypatch, cell, fault):
    if fault == "half_the_batch_left_out":
        monkeypatch.setattr(ClusterStore, "bind_pods",
                            _half_bound(ClusterStore.bind_pods))
    else:
        wrap = _unchanged if fault == "state_unchanged" else _altered
        for name in ("greedy_assign", "greedy_assign_shortlist"):
            monkeypatch.setattr(pipeline, name,
                                wrap(getattr(pipeline, name)))
    rec = tiny_run(cell, seconds=2.0)
    correct, shown = run.judge(rec["compared"], run.limits(cell))
    assert not correct, shown
