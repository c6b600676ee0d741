"""The comparison that decides ``correct`` fails what it must: the control
(the reference in TF32, the nearest precision below the configurations'
float32) on three seeds at a size a test run holds, and each cell's run
with its timed path broken underneath: an answer altered where it is
produced, and in the served cell the answers of a batch handed to the
wrong requests.  On the card, the control at the cells' own size."""
import pytest
import torch

from perfbench import check, graphs, harness
from repro_torch.models import gnn

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = [2**31 + 1, 2**31 + 2, 2**31 + 3]


@pytest.mark.parametrize("cell", ["gcn-fl.replay", "gin-fl.replay"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_limit(cell, seed):
    c = harness.load_cell(cell)
    inputs = graphs.make_inputs(c.cfg, seed, 2, torch.device("cpu"),
                                scale=0.05)
    got = check.readings(c.cfg, inputs, [(0, None), (1, None)],
                         control=True)
    assert got["logits_err"] > 3 * c.limits["logits_err"]


def _break_call(monkeypatch, fault):
    call = gnn.CompiledModel.__call__

    def broken(self, h):
        return fault(call(self, h))
    monkeypatch.setattr(gnn.CompiledModel, "__call__", broken)


def _altered(z):
    z = z.clone()
    z[0] += 1e-3 * z.abs().max()
    return z


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(rehearse, monkeypatch, cell):
    _break_call(monkeypatch, _altered)
    r = rehearse(cell)
    assert r["correct"] is False
    c = r["checks"]["logits_err"]
    assert c["value"] > c["limit"]


def test_answers_handed_to_the_wrong_requests_are_not_correct(
        rehearse, monkeypatch):
    """The served batch's column blocks rolled by one request: each request
    of a batch gets a neighbour's logits.  Arrivals faster than the host
    serves them keep every batch full, so most neighbours differ."""
    classes = harness.load_cell("gcn-fl.served").cfg["graph"]["classes"]
    _break_call(monkeypatch, lambda z: torch.roll(z, classes, dims=1))
    r = rehearse("gcn-fl.served", rate_=400.0)
    assert r["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["gcn-fl.replay", "gin-fl.replay"])
def test_control_fails_the_limit_at_the_cells_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell(cell)
    for seed in SEEDS:
        inputs = graphs.make_inputs(c.cfg, seed, 2, torch.device("cuda"))
        got = check.readings(c.cfg, inputs, [(0, None), (1, None)],
                             control=True)
        assert got["logits_err"] > 3 * c.limits["logits_err"], seed
