"""The port's kernel layer on the CPU: each plain PyTorch version equals
the JAX wrapper (Pallas interpret mode) on the same numpy inputs, including
ragged tiles, canvas blocks no entry covers, a ``first`` reset in the middle
of a run and a run with no ``first`` that adds onto the canvas.  The CUDA
kernels are held against these plain versions in
``test_torch_kernels_cuda.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.formats import pack_blockcsr as jpack
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.formats import pack_blockcsr as tpack
from test_torch_kernels_cuda import (ATOL, RTOL, STRIDED, _gemm_case,
                                     _spdmm_case, _spmm_case,
                                     _spmm_walk_case, _t, _walk_case,
                                     check_strided_spdmm, strided_spdmm)


@pytest.mark.parametrize("k", [7, 20, 32, 300, 500])
def test_gemm_batch_scatter_plain_matches_pallas(k):
    rng = np.random.default_rng(k)
    x, y, rows, cols, z = _gemm_case(rng, k=k)
    want = np.asarray(jops.gemm_batch_scatter(
        jnp.asarray(x), jnp.asarray(y), rows, cols, jnp.asarray(z),
        interpret=True))
    tz = torch.as_tensor(z.copy())
    got = tops.gemm_batch_scatter(*_t(x, y), rows, cols, tz)
    assert got is tz                                  # updated in place
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    covered = np.zeros(z.shape, bool)
    for r, c in zip(rows, cols):
        covered[r * 16:(r + 1) * 16, c * 8:(c + 1) * 8] = True
    np.testing.assert_array_equal(got.numpy()[~covered], z[~covered])


@pytest.mark.parametrize("k", [7, 20, 500])
def test_ops_gemm_batch_scatter_hands_the_callers_k(monkeypatch, k):
    """``ops.gemm_batch_scatter`` passes x and y to the kernel module at the
    caller's k, with no padded copy, and its canvas equals bit for bit the
    call on operands zero-padded to the reference wrapper's K multiple."""
    rng = np.random.default_rng(100 + k)
    x, y, rows, cols, z = _gemm_case(rng, k=k)
    seen = []
    kernel = tgemm.gemm_batch_scatter

    def record(xs, ys, *args, **kw):
        seen.append((tuple(xs.shape), tuple(ys.shape)))
        return kernel(xs, ys, *args, **kw)

    monkeypatch.setattr(tgemm, "gemm_batch_scatter", record)
    got = tops.gemm_batch_scatter(*_t(x, y), rows, cols, torch.as_tensor(z))
    assert seen == [(x.shape, y.shape)]
    bk = min(128, -(-k // 8) * 8)
    kp = -(-k // bk) * bk
    padded = kernel(torch.as_tensor(np.pad(x, ((0, 0), (0, 0), (0, kp - k)))),
                    torch.as_tensor(np.pad(y, ((0, 0), (0, kp - k), (0, 0)))),
                    *_t(rows, cols), torch.as_tensor(z))
    assert torch.equal(got, padded)


@pytest.mark.parametrize("seed", [0, 1])
def test_spdmm_fused_plain_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    a, y, desc, z = _spdmm_case(rng)
    want = np.asarray(jops.spdmm_fused(
        jnp.asarray(a), jnp.asarray(y), *desc, block_size=8, bn=16,
        m_pad=z.shape[0], interpret=True, z=jnp.asarray(z)))
    got = tops.spdmm_fused(*_t(a, y), *desc, block_size=8, bn=16,
                           m_pad=z.shape[0], z=torch.as_tensor(z.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    covered = np.zeros(z.shape, bool)
    for r, c in zip(desc[2], desc[3]):
        covered[r * 8:(r + 1) * 8, c * 16:(c + 1) * 16] = True
    assert (~covered).any()
    np.testing.assert_array_equal(got.numpy()[~covered], z[~covered])


# the run walk's cases at interpret-mode size: (block, bn, entries of the
# long run, its `first` positions as fractions, zero-column and filler
# shares)
WALKS = {
    "long-run": (2, 8, 200, (0,), 0.0, 0.0),
    "zero-columns": (4, 8, 40, (0, 2 / 3), 0.6, 0.3),
    "first-mid-run": (8, 16, 60, (1 / 3,), 0.3, 0.1),
}


@pytest.mark.parametrize("case", list(WALKS))
def test_spdmm_fused_plain_matches_pallas_walks(case):
    """The semantics the CUDA run walk is held to, against the Pallas
    kernel: a long run, blocks with all-zero columns and all-zero fillers,
    a ``first`` in the middle of a run (the canvas and the entries before
    it are discarded), short runs of every ``first`` pattern."""
    B, bn, n, resets, zero_cols, fillers = WALKS[case]
    rng = np.random.default_rng(len(case))
    a, y, desc, z = _walk_case(rng, B, bn, n, nrb=3, K_blocks=12, P=24,
                               zero_cols=zero_cols, fillers=fillers,
                               resets=resets)
    want = np.asarray(jops.spdmm_fused(
        jnp.asarray(a), jnp.asarray(y), *desc, block_size=B, bn=bn,
        m_pad=z.shape[0], interpret=True, z=jnp.asarray(z)))
    got = tops.spdmm_fused(*_t(a, y), *desc, block_size=B, bn=bn,
                           m_pad=z.shape[0], z=torch.as_tensor(z.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["long-run", "zero-columns"])
def test_spdmm_plain_matches_pallas_walks(case):
    """``spdmm`` against the Pallas ``spdmm`` on two block-rows of up to
    150 stored blocks, dense or with all-zero columns inside the blocks."""
    B, n, ncb = 4, 8, 150
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2 * B - 1, ncb * B)).astype(np.float32)
    if case == "zero-columns":
        x *= rng.uniform(size=(1, ncb * B)) >= 0.6
    y = rng.normal(size=(ncb * B, n)).astype(np.float32)
    want = jops.spdmm(jpack(x, B), jnp.asarray(y), bn=n, interpret=True)
    got = tops.spdmm(tpack(x, B), torch.as_tensor(y))
    assert tpack(x, B).stored_blocks > ncb       # rows of >75 blocks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# the triple walk's cases at interpret-mode size: (block, triples of the
# long run, its `first` positions as fractions, zero A column, zero Y row
# and filler shares)
SPMM_WALKS = {
    "long-run": (8, 200, (0,), 0.0, 0.0, 0.0),
    "zero-columns-rows": (8, 40, (0, 2 / 3), 0.6, 0.6, 0.3),
    "first-mid-run": (8, 60, (1 / 3,), 0.3, 0.3, 0.1),
    "block-4": (4, 40, (0, 1 / 2), 0.5, 0.5, 0.2),
    "block-16": (16, 30, (0, 1 / 2), 0.5, 0.5, 0.2),
}


@pytest.mark.parametrize("case", [0, 1, *SPMM_WALKS])
def test_spmm_fused_plain_matches_pallas(case):
    """Random short runs of every ``first`` pattern (cases 0 and 1), and
    the semantics the CUDA triple walk is held to: a long run, A blocks
    with all-zero columns and Y blocks with all-zero rows, zero fillers and
    the sentinels, a ``first`` in the middle of a run, other block sizes
    (the named cases)."""
    if case in SPMM_WALKS:
        B, n, resets, zero_cols, zero_rows, fillers = SPMM_WALKS[case]
        rng = np.random.default_rng(len(case))
        a, yb, desc, z = _spmm_walk_case(
            rng, B, n, nrb=3, ncb=2, Pa=12, Py=10, zero_cols=zero_cols,
            zero_rows=zero_rows, fillers=fillers, resets=resets)
    else:
        B = 8
        rng = np.random.default_rng(10 + case)
        a, yb, desc, z = _spmm_case(rng)
    want = np.asarray(jops.spmm_fused(
        jnp.asarray(a), jnp.asarray(yb), *desc, block_size=B,
        m_pad=z.shape[0], n_pad=z.shape[1], interpret=True,
        z=jnp.asarray(z)))
    got = tops.spmm_fused(*_t(a, yb), *desc, block_size=B, m_pad=z.shape[0],
                          n_pad=z.shape[1], z=torch.as_tensor(z.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [4, 8])
def test_ops_spmm_matches_pallas(B):
    """``ops.spmm`` on one BlockCSR pair (zero columns inside A's blocks,
    zero rows inside Y's, whole zero blocks, ragged edges) against the
    reference's ``spmm`` in interpret mode."""
    rng = np.random.default_rng(500 + B)
    m, k, n = 5 * B - 3, 7 * B, 3 * B - 2
    x = rng.normal(size=(m, k)).astype(np.float32)
    x *= rng.uniform(size=(1, k)) >= 0.5
    x *= np.kron(rng.uniform(size=(5, 7)) >= 0.3, np.ones((B, B)))[:m]
    y = rng.normal(size=(k, n)).astype(np.float32)
    y *= rng.uniform(size=(k, 1)) >= 0.5
    y *= np.kron(rng.uniform(size=(7, 3)) >= 0.3, np.ones((B, B)))[:, :n]
    want = jops.spmm(jpack(x, B), jpack(y, B), interpret=True)
    got = tops.spmm(tpack(x, B), tpack(y, B))
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), x @ y, rtol=1e-4, atol=1e-4)


def test_first_reset_and_accumulate_semantics():
    """Hand-checked: a run with no ``first`` adds onto the canvas, a
    mid-run ``first`` discards what came before it, uncovered blocks keep
    their content."""
    a = np.stack([np.eye(2, dtype=np.float32) * s for s in (1, 2, 3)])
    yb = np.ones((1, 2, 2), np.float32)
    z = np.full((4, 4), 10.0, np.float32)
    # block (0,0): no first -> 10 + 1 + 2; block (0,1): reset at entry 2
    # -> 3 only; block (1,*): uncovered.
    desc = [np.array(v, np.int32) for v in
            ([0, 1, 1, 2], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 1, 1],
             [0, 0, 0, 1])]
    got = tops.spmm_fused(*_t(a, yb), *desc, block_size=2, m_pad=4,
                          n_pad=4, z=torch.as_tensor(z.copy())).numpy()
    want = z.copy()
    want[:2, :2] = 10 + 1 + 2          # A_s @ ones(2, 2) == s * ones
    want[:2, 2:] = 3
    np.testing.assert_array_equal(got, want)


def test_wrappers_count_calls_and_never_launch_on_cpu():
    rng = np.random.default_rng(3)
    x, y, rows, cols, z = _gemm_case(rng)
    tops.reset_kernel_call_count()
    tops.reset_cuda_launch_counts()
    tops.gemm_batch_scatter(*_t(x, y), rows, cols, torch.as_tensor(z))
    a, yd, desc, z2 = _spdmm_case(rng)
    tops.spdmm_fused(*_t(a, yd), *desc, block_size=8, bn=16,
                     m_pad=z2.shape[0])
    assert tops.kernel_call_count() == 2
    assert tops.cuda_launch_counts() == {}


def test_refs_and_blockize_match_reference():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(24, 16)).astype(np.float32)
    a *= rng.uniform(size=a.shape) < 0.3
    y = rng.normal(size=(16, 24)).astype(np.float32)
    y *= rng.uniform(size=y.shape) < 0.4
    ta, ty = tpack(a, 8), tpack(y, 8)
    ja, jy = jpack(a, 8), jpack(y, 8)
    np.testing.assert_allclose(tref.spdmm_ref(ta, torch.as_tensor(y)).numpy(),
                               np.asarray(jref.spdmm_ref(ja, jnp.asarray(y))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tref.spmm_ref(ta, ty).numpy(),
                               np.asarray(jref.spmm_ref(ja, jy)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tref.gemm_ref(torch.as_tensor(a), torch.as_tensor(y)).numpy(),
        np.asarray(jref.gemm_ref(jnp.asarray(a), jnp.asarray(y))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        tops.blockize(torch.as_tensor(a), 8).numpy(),
        np.asarray(jops.blockize(jnp.asarray(a), 8)))


@pytest.mark.parametrize("case", STRIDED)
def test_spdmm_fused_plain_on_strided_operands_equals_padded_layout(case):
    """The plain version keeps the kernel's contract for strided, clipped
    operands (held on the card in ``test_torch_kernels_cuda.py``): bitwise
    the padded layout's result, Z's border untouched."""
    check_strided_spdmm(*strided_spdmm("cpu", *case))
