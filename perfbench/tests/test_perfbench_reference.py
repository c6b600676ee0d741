"""The plain reference against hand-worked cases and a dense float64
forward, its TF32 rounding, and the FLOP and byte count."""
import math

import numpy as np
import pytest
import torch

from perfbench import counts, graphs, harness, reference

S2 = 1 / math.sqrt(2)
# edges 0->1 and 1->2 with self-loops: row degrees 2, 2, 1
A_HAT = np.array([[0.5, 0.5, 0.0],
                  [0.0, 0.5, S2],
                  [0.0, 0.0, 1.0]])
H = np.array([[1.0, -1.0, 0.0],
              [0.0, 2.0, 0.0],
              [0.0, 0.0, -3.0]])


def _adj():
    return reference.Adjacency(3, torch.tensor([0, 1]), torch.tensor([1, 2]))


def _t(a):
    return torch.tensor(a, dtype=torch.float32)


def test_adjacency_is_the_hand_worked_normalization():
    adj = _adj()
    dense = torch.zeros(3, 3).index_put_((adj.rows, adj.cols), adj.vals,
                                         accumulate=True)
    np.testing.assert_allclose(dense.numpy(), A_HAT, rtol=1e-7)
    np.testing.assert_allclose((adj @ _t(H)).numpy(), A_HAT @ H, rtol=1e-6)


def test_gcn_hand_worked():
    eye = _t(np.eye(3))
    # A_HAT relu(A_HAT H): A_HAT H = [[.5, .5, 0], [0, 1, -3/sqrt2],
    # [0, 0, -3]], relu -> [[.5, .5, 0], [0, 1, 0], [0, 0, 0]]
    want = np.array([[0.25, 0.75, 0.0], [0.0, 0.5, 0.0], [0.0, 0.0, 0.0]])
    got = reference.gcn(_adj(), _t(H), {"W1": eye, "W2": eye})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


def test_gin_hand_worked():
    eye = _t(np.eye(3))
    # z = H + A_HAT H = [[1.5, -.5, 0], [0, 3, -3/sqrt2], [0, 0, -6]];
    # two relus -> [[1.5, 0, 0], [0, 3, 0], [0, 0, 0]] = r
    # z = r + A_HAT r = [[2.25, 1.5, 0], [0, 4.5, 0], [0, 0, 0]], relu, M2b
    want = np.array([[2.25, 1.5, 0.0], [0.0, 4.5, 0.0], [0.0, 0.0, 0.0]])
    got = reference.gin(_adj(), _t(H), {k: eye for k in
                                        ("M1a", "M1b", "M2a", "M2b")})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("name", ["gcn-fl", "gin-fl"])
def test_forward_matches_dense_float64(name):
    cfg = harness.load_cell(f"{name}.replay").cfg
    inp = graphs.make_inputs(cfg, 5, 1, torch.device("cpu"), scale=0.005)
    adj = reference.Adjacency(inp.n, inp.src, inp.dst)
    a = np.zeros((inp.n, inp.n))
    np.add.at(a, (adj.rows.numpy(), adj.cols.numpy()), adj.vals.numpy())
    h = inp.pool[0].double().numpy()
    p = {k: v.double().numpy() for k, v in inp.params.items()}
    relu = lambda x: np.maximum(x, 0)  # noqa: E731
    if cfg["model"] == "GCN":
        want = a @ (relu(a @ (h @ p["W1"])) @ p["W2"])
    else:
        z = relu(relu((h + a @ h) @ p["M1a"]) @ p["M1b"])
        want = relu((z + a @ z) @ p["M2a"]) @ p["M2b"]
    got = reference.forward(cfg, adj, inp.pool[0], inp.params)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_round_tf32_keeps_ten_mantissa_bits_ties_to_even():
    x = _t([1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10, -(1 + 3 * 2**-11),
            1 + 2**-11 + 2**-20])
    want = [1.0, 1 + 2**-9, 1 + 2**-10, -(1 + 2**-9), 1 + 2**-10]
    assert reference.round_tf32(x).tolist() == want


def test_counts_per_inference():
    gcn = harness.load_cell("gcn-fl.replay").cfg
    gin = harness.load_cell("gin-fl.replay").cfg
    assert counts.flops(gcn) == 11_850_967_620
    assert counts.flops(gin) == 18_675_215_536
    assert round(counts.flops(gcn) / 1e9, 2) == 11.85
    assert round(counts.flops(gin) / 1e9, 2) == 18.68
    assert [o.name for o in counts.ops(gcn)] == [
        "l1-update", "l1-agg", "l1-relu", "l2-update", "l2-agg"]
    l1_agg = {o.name: o for o in counts.ops(gin)}["l1-agg"]
    assert l1_agg.bytes == 12 * 989_006 + 4 * 2 * 89_250 * 500
    # every FLOP sits in the products
    assert all(o.flops == 0 for o in counts.ops(gin)
               if "relu" in o.name or "combine" in o.name)
    assert counts.bound_s(gcn) == pytest.approx(2.48035e-4, rel=1e-5)
