"""The benchmark's seeded inputs: the Table IV stand-in's counts, the
feature density, and the seed's hold on every array."""
import math

import pytest
import torch

from perfbench import graphs, harness

CPU = torch.device("cpu")
SEED = 2**33 + 17          # wider than 32 bits, as the benchmark's are


def _cfg(name="gcn-fl"):
    return harness.load_cell(f"{name}.replay").cfg


def test_stand_in_matches_table_iv_counts():
    cfg = _cfg()
    n, e, f = graphs.sizes(cfg["graph"])
    assert (n, e, f) == (89250, 899756, 500)
    src, dst = graphs.edges(n, e, cfg["graph"]["degree_skew"],
                            graphs.generator(SEED, "graph", CPU), CPU)
    rows, cols, vals = graphs.program_adjacency(n, src, dst)
    assert rows.shape == cols.shape == vals.shape == (989006,)
    assert int(src.min()) >= 0 and int(src.max()) < n
    assert int(dst.min()) >= 0 and int(dst.max()) < n
    assert bool((rows[1:] >= rows[:-1]).all())       # sorted by row
    assert rows.dtype == cols.dtype == torch.int32
    # hub-skewed destinations: the first 1 % of vertices take ~10 %
    assert 0.08 < float((dst < n // 100).float().mean()) < 0.12


def test_feature_density_matches_table_iv():
    cfg = _cfg()
    n, _, f = graphs.sizes(cfg["graph"])
    (h,) = graphs.feature_pool(n, f, cfg["graph"]["feature_density"], 1,
                               cfg["feature_noise"],
                               graphs.generator(SEED, "features", CPU), CPU)
    assert h.shape == (n, f) and h.dtype == torch.float32
    assert int((h != 0).sum()) == round(n * f * 0.46)
    nz = h[h != 0]
    assert abs(float(nz.mean()) - 1.0) < 1e-3
    assert 0.009 < float(nz.std()) < 0.011


@pytest.mark.parametrize("name", ["gcn-fl", "gin-fl"])
def test_same_seed_same_arrays_and_two_seeds_differ(name):
    cfg = _cfg(name)
    a = graphs.make_inputs(cfg, SEED, 3, CPU, scale=0.01)
    b = graphs.make_inputs(cfg, SEED, 3, CPU, scale=0.01)
    c = graphs.make_inputs(cfg, SEED + 1, 3, CPU, scale=0.01)
    for x, y in [(a.src, b.src), (a.dst, b.dst)] + list(zip(a.pool, b.pool)):
        assert torch.equal(x, y)
    assert a.params.keys() == b.params.keys() == set(
        graphs.PARAM_SHAPES[cfg["model"]])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
        assert torch.equal(a.params[k], c.params[k])   # the model is fixed
    assert not torch.equal(a.src, c.src)
    assert not torch.equal(a.pool[0], c.pool[0])
    # pool members share the pattern and differ in their values
    assert torch.equal(a.pool[0] != 0, a.pool[1] != 0)
    assert not torch.equal(a.pool[0], a.pool[1])


def test_glorot_weights_have_their_std():
    w = graphs.glorot("GIN", {"in": 500, "hidden": 128, "out": 7},
                      graphs.generator(SEED, "weights", CPU), CPU)
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        "M1a": (500, 128), "M1b": (128, 128), "M2a": (128, 128),
        "M2b": (128, 7)}
    for k, v in w.items():
        want = math.sqrt(2.0 / sum(v.shape))
        assert abs(float(v.std()) / want - 1) < 0.1, k
