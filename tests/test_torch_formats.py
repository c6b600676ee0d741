"""The port's BlockCSR packers, pairing and first-visit flags equal the JAX
package's element for element on the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import formats as jf
from repro_torch.kernels import formats as tf


def _sparse_dense(rng, m, k, density):
    x = rng.normal(size=(m, k)).astype(np.float32)
    return x * (rng.uniform(size=(m, k)) < density)


def _assert_same_bcsr(t, j):
    assert t.shape == j.shape and t.block_size == j.block_size
    assert t.nnzb == j.nnzb and t.stored_blocks == j.stored_blocks
    for name in ("row_ids", "col_ids", "first"):
        tv, jv = getattr(t, name), np.asarray(getattr(j, name))
        assert tv.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))


@pytest.mark.parametrize("m,k,density,eps,capacity", [
    (40, 24, 0.2, 0.0, None),
    (37, 29, 0.05, 0.0, None),        # ragged edges, empty block-rows
    (64, 64, 0.5, 0.8, None),         # eps drops small-but-nonzero blocks
    (30, 20, 0.1, 0.0, 64),           # capacity padding on the last row
])
def test_pack_blockcsr_matches_reference(m, k, density, eps, capacity):
    rng = np.random.default_rng(m * 7 + k)
    x = _sparse_dense(rng, m, k, density)
    t = tf.pack_blockcsr(x, 8, eps=eps, capacity=capacity)
    j = jf.pack_blockcsr(x, 8, eps=eps, capacity=capacity)
    _assert_same_bcsr(t, j)
    np.testing.assert_array_equal(t.todense().numpy(),
                                  np.asarray(j.todense()))
    assert t.block_density() == j.block_density()


@pytest.mark.parametrize("eps,capacity", [(0.0, None), (0.3, None),
                                          (0.0, 200)])
def test_pack_blockcsr_coo_matches_reference(eps, capacity):
    rng = np.random.default_rng(11)
    M, K, nnz = 45, 70, 300
    rows = rng.integers(0, M, nnz).astype(np.int32)      # with duplicates
    cols = rng.integers(0, K, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    t = tf.pack_blockcsr_coo((M, K), rows, cols, vals, 8, eps=eps,
                             capacity=capacity)
    j = jf.pack_blockcsr_coo((M, K), rows, cols, vals, 8, eps=eps,
                             capacity=capacity)
    _assert_same_bcsr(t, j)


def test_pack_blockcsr_coo_rejects_out_of_bounds():
    with pytest.raises(ValueError):
        tf.pack_blockcsr_coo((8, 8), np.array([8]), np.array([0]),
                             np.array([1.0], np.float32), 8)


@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_block_nonzero_mask_namespaces_agree(eps):
    rng = np.random.default_rng(2)
    blocks = _sparse_dense(rng, 12 * 8, 8, 0.05).reshape(12, 8, 8)
    want = np.asarray(jf.block_nonzero_mask(jnp.asarray(blocks), eps,
                                            axis=(1, 2), xp=jnp))
    np.testing.assert_array_equal(
        tf.block_nonzero_mask(blocks, eps, axis=(1, 2)), want)
    np.testing.assert_array_equal(
        tf.block_nonzero_mask(torch.as_tensor(blocks), eps, axis=(-2, -1),
                              xp=torch).numpy(), want)


def test_pair_block_triples_and_first_flags_match_reference():
    rng = np.random.default_rng(5)
    a = _sparse_dense(rng, 40, 32, 0.15)
    y = _sparse_dense(rng, 32, 24, 0.2)
    ta, tb = tf.pack_blockcsr(a, 8), tf.pack_blockcsr(y, 8)
    ja, jb = jf.pack_blockcsr(a, 8), jf.pack_blockcsr(y, 8)
    kw = dict(a_sentinel=99, y_sentinel=77, a_offset=3, y_offset=5,
              base_row=2, base_col=4, n_row_blocks=5, n_col_blocks=3)
    got = tf.pair_block_triples(ta, tb, **kw)
    want = jf.pair_block_triples(ja, jb, **kw)
    assert got == want
    got.sort()
    orow = np.array([t[0] for t in got], np.int32)
    ocol = np.array([t[1] for t in got], np.int32)
    np.testing.assert_array_equal(tf.first_visit_flags(orow, ocol),
                                  jf.first_visit_flags(orow, ocol))
    for g, w in zip(tf.spmm_triples(ta, tb), jf.spmm_triples(ja, jb)):
        np.testing.assert_array_equal(g, w)


def test_run_starts_follow_key_changes_not_first_flags():
    orow = torch.tensor([0, 0, 0, 1, 1, 3], dtype=torch.int32)
    ocol = torch.tensor([0, 0, 1, 1, 1, 0], dtype=torch.int32)
    np.testing.assert_array_equal(tf.run_starts(orow, ocol).numpy(),
                                  [0, 2, 3, 5, 6])
    empty = torch.zeros(0, dtype=torch.int32)
    np.testing.assert_array_equal(tf.run_starts(empty, empty).numpy(), [0])
