"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: the dense GEMM kernels at every tile and load variant, bitwise
equal across tiles, the stacked batch and the scatter kernel, and
predicated; ragged tiles, every block size the kernels are
built for, canvas blocks no entry covers, ``first`` resets in the middle
of a run, runs that add onto the canvas, and bitwise repeatability; the
SpDMM run walk on runs of thousands of entries, all-zero columns and
filler blocks at every width,
and bitwise equal to the dense ``gemm`` kernel; the SpMM triple walk on a
run of thousands of triples, all-zero A columns and Y rows, sentinel
blocks, runs that straddle the warps' shares, and bitwise equal to the
dense ``gemm`` kernel through ``ops.spmm``; the predicated overflow
route on both branches, run-time descriptors under one CUDA graph, the
compiled and per-task paths against the CPU, and the in-place sparse
route: ``spdmm_fused`` on strided, clipped operands bitwise the padded
layout, and compiled models without the pads.  Every case needs a card and
skips without one; this file imports no JAX, so it runs on a machine that
has only the port's dependencies::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spdmm as tspdmm
from repro_torch.kernels import spmm as tspmm

# f32 with another summation order: the tolerance of tests/test_kernels.py
RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _runs(rng, n_row_blocks, n_col_blocks, pool, ids_hi, cover=0.6):
    """Descriptor lists sorted by output block: every covered block gets
    one consecutive run whose ``first`` pattern is drawn from: reset at the
    start, no reset (adds onto the canvas), or a reset in the middle."""
    orow, ocol, aid, yid, first = [], [], [], [], []
    for r in range(n_row_blocks):
        for c in range(n_col_blocks):
            if rng.uniform() > cover:
                continue
            n = int(rng.integers(1, 5))
            kind = rng.integers(0, 3)
            f = np.zeros(n, np.int32)
            if kind == 0:
                f[0] = 1
            elif kind == 2:
                f[int(rng.integers(0, n))] = 1
            orow += [r] * n
            ocol += [c] * n
            aid += list(rng.integers(0, pool, n))
            yid += list(rng.integers(0, ids_hi, n))
            first += list(f)
    as32 = lambda a: np.asarray(a, np.int32)
    return as32(aid), as32(yid), as32(orow), as32(ocol), as32(first)


def _gemm_case(rng, T=4, m=16, k=20, n=8, grid=(3, 2)):
    x = rng.normal(size=(T, m, k)).astype(np.float32)
    y = rng.normal(size=(T, k, n)).astype(np.float32)
    tiles = rng.permutation(grid[0] * grid[1])[:T]
    rows = (tiles // grid[1]).astype(np.int32)
    cols = (tiles % grid[1]).astype(np.int32)
    z = rng.normal(size=(grid[0] * m, grid[1] * n)).astype(np.float32)
    return x, y, rows, cols, z


def _spdmm_case(rng, B=8, bn=16, nrb=5, ncs=2, K_blocks=6, P=9):
    a = rng.normal(size=(P, B, B)).astype(np.float32)
    y = rng.normal(size=(K_blocks * B, ncs * bn)).astype(np.float32)
    desc = _runs(rng, nrb, ncs, P, K_blocks)
    z = rng.normal(size=(nrb * B, ncs * bn)).astype(np.float32)
    return a, y, desc, z


def _spmm_case(rng, B=8, nrb=4, ncb=3, Pa=7, Py=5):
    a = rng.normal(size=(Pa, B, B)).astype(np.float32)
    yb = rng.normal(size=(Py, B, B)).astype(np.float32)
    desc = _runs(rng, nrb, ncb, Pa, Py)
    z = rng.normal(size=(nrb * B, ncb * B)).astype(np.float32)
    return a, yb, desc, z


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _values(rng, size, scale, dyadic):
    """Normal values, or with ``dyadic`` small multiples of ``1/scale``."""
    if dyadic:
        return (rng.integers(-4, 5, size=size) / scale).astype(np.float32)
    return rng.normal(size=size).astype(np.float32)


def _walk_runs(rng, long_run, nrb, ncb, resets):
    """``(out_rows, out_cols, first)`` of a walk case: one run of
    ``long_run`` entries on output block (0, 0) with a ``first`` at each
    fraction ``resets`` of its length, then short runs (1-40 entries) on
    the blocks of rows 1.. of every ``first`` pattern: reset at the start,
    none (adds onto the canvas), reset in the middle.  Row 0's other
    blocks are covered by no entry."""
    first = np.zeros(long_run, np.int32)
    first[[int(f * long_run) for f in resets]] = 1
    orow, ocol = [0] * long_run, [0] * long_run
    firsts = [first]
    for r in range(1, nrb):
        for c in range(ncb):
            n = int(rng.integers(1, 41))
            f = np.zeros(n, np.int32)
            kind = (r * ncb + c) % 3        # reset at start, none, mid-run
            if kind == 0:
                f[0] = 1
            elif kind == 2:
                f[int(rng.integers(0, n))] = 1
            orow += [r] * n
            ocol += [c] * n
            firsts.append(f)
    as32 = lambda v: np.asarray(v, np.int32)
    return as32(orow), as32(ocol), np.concatenate(firsts)


def _walk_case(rng, B, bn, long_run, *, nrb=6, ncs=2, K_blocks=40, P=64,
               zero_cols=0.5, fillers=0.2, dyadic=False, resets=(0, 2 / 3)):
    """A fused SpDMM case that exercises the run walk
    (:func:`_walk_runs`, by default with a ``first`` at the long run's
    start and in its middle).  Every pool block has each column all-zero
    with probability ``zero_cols``, and a share ``fillers`` of the blocks
    is all zero (the packer's fillers).  With ``dyadic`` every value is a
    small multiple of 1/4 (A) or 1/8 (Y, the canvas), so every partial sum
    is exact in float32 and two summation orders agree exactly."""
    a = _values(rng, (P, B, B), 4, dyadic)
    a *= (rng.uniform(size=(P, 1, B)) >= zero_cols)
    a *= (rng.uniform(size=(P, 1, 1)) >= fillers)
    y = _values(rng, (K_blocks * B, ncs * bn), 8, dyadic)
    z = _values(rng, (nrb * B, ncs * bn), 8, dyadic)
    orow, ocol, first = _walk_runs(rng, long_run, nrb, ncs, resets)
    E = len(orow)
    desc = (rng.integers(0, P, E).astype(np.int32),
            rng.integers(0, K_blocks, E).astype(np.int32), orow, ocol, first)
    return a, y, desc, z


def _spmm_walk_case(rng, B, long_run, *, nrb=6, ncb=3, Pa=40, Py=30,
                    zero_cols=0.5, zero_rows=0.5, fillers=0.2, dyadic=False,
                    resets=(0, 2 / 3)):
    """A fused SpMM case that exercises the triple walk: the runs of
    :func:`_walk_runs`; every A pool block has each column all-zero with
    probability ``zero_cols``, every Y pool block each row with
    probability ``zero_rows``, a share ``fillers`` of both pools is all
    zero, and the last block of each pool is the zero sentinel.
    ``dyadic`` as in :func:`_walk_case`."""
    a = _values(rng, (Pa, B, B), 4, dyadic)
    a *= rng.uniform(size=(Pa, 1, B)) >= zero_cols
    a *= rng.uniform(size=(Pa, 1, 1)) >= fillers
    yb = _values(rng, (Py, B, B), 8, dyadic)
    yb *= rng.uniform(size=(Py, B, 1)) >= zero_rows
    yb *= rng.uniform(size=(Py, 1, 1)) >= fillers
    a[-1] = 0
    yb[-1] = 0
    z = _values(rng, (nrb * B, ncb * B), 8, dyadic)
    orow, ocol, first = _walk_runs(rng, long_run, nrb, ncb, resets)
    E = len(orow)
    desc = (rng.integers(0, Pa, E).astype(np.int32),
            rng.integers(0, Py, E).astype(np.int32), orow, ocol, first)
    return a, yb, desc, z


# strided operands of spdmm_fused: (B, bn, N, M, K, Y's column offset, Z's
# column offset); row strides are multiples of 4 floats, so an offset of 4
# keeps rows 16-byte aligned and 2 or 3 does not
STRIDED = [(8, 128, 500, 90, 90, 4, 4), (8, 128, 126, 37, 61, 4, 2),
           (8, 8, 7, 45, 45, 3, 2), (4, 16, 37, 30, 50, 4, 4),
           (16, 32, 40, 19, 70, 2, 3)]


def strided_spdmm(device, B, bn, N, M, K, y_off, z_off):
    """``spdmm_fused`` on ``Y`` ``(K, N)`` and ``Z`` ``(M, N)`` that are
    column windows of wider buffers (Y's other columns and trailing rows
    NaN, Z's border a sentinel), against the same call on the padded
    layout.  Entries have a run of every ``first`` pattern on random
    output blocks; each entry's A block is zero in the columns past K, as
    the packer makes it.  Returns ``(Z's buffer after the call, the
    padded call's result, Z's window in the buffer)``."""
    rng = np.random.default_rng(B * N + M + K)
    nrb, ncb, ncs = -(-M // B), -(-K // B), -(-N // bn)
    orow, ocol, first = _runs(rng, nrb, ncs, 1, 1, cover=0.8)[2:]
    E = len(orow)
    y_rows = rng.integers(0, ncb, E).astype(np.int32)
    a = rng.normal(size=(E, B, B)).astype(np.float32)
    a *= rng.uniform(size=(E, 1, B)) >= 0.3
    tail = np.arange(B)[None, :] + y_rows[:, None] * B >= K
    a *= ~tail[:, None, :]
    y = rng.normal(size=(K, N)).astype(np.float32)
    z0 = rng.normal(size=(M, N)).astype(np.float32)
    ceil4 = lambda v: -(-v // 4) * 4        # row strides of 16-B multiples
    ybuf = torch.full((K + 5, ceil4(y_off + N + 9)), float("nan"),
                      device=device)
    ybuf[:K, y_off:y_off + N] = torch.as_tensor(y, device=device)
    zbuf = torch.full((M + 3, ceil4(z_off + N + 5)), 7.0, device=device)
    window = (slice(0, M), slice(z_off, z_off + N))
    zbuf[window] = torch.as_tensor(z0, device=device)
    args = _t(np.arange(E, dtype=np.int32), y_rows, orow, ocol, first,
              device=device)
    pool = torch.as_tensor(a, device=device)
    got = tspdmm.spdmm_fused(pool, ybuf[:K, y_off:y_off + N], *args,
                             block_size=B, bn=bn, z=zbuf[window])
    assert got.data_ptr() == zbuf[window].data_ptr()
    yp = torch.zeros((ncb * B, ncs * bn), device=device)
    yp[:K, :N] = torch.as_tensor(y, device=device)
    zp = torch.zeros((nrb * B, ncs * bn), device=device)
    zp[:M, :N] = torch.as_tensor(z0, device=device)
    want = tspdmm.spdmm_fused(pool, yp, *args, block_size=B, bn=bn, z=zp)
    return zbuf, want, window


def check_strided_spdmm(zbuf, want, window):
    M, N = zbuf[window].shape
    assert torch.equal(zbuf[window], want[:M, :N])
    border = torch.ones_like(zbuf, dtype=torch.bool)
    border[window] = False
    assert bool((zbuf[border] == 7.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", STRIDED)
def test_spdmm_fused_on_strided_operands_equals_padded_layout(cuda, case):
    """The kernel reads Y at its row stride and writes Z at its own, with
    the last stripe, Z's last block row and Y's last block row clipped:
    bitwise the same kernel on the padded layout, nothing read from Y's
    NaN border, nothing written to Z's."""
    check_strided_spdmm(*strided_spdmm(cuda, *case))


# the in-place sparse body's cases: (vertices, width N, tile_m, tile_n,
# the strided operand's column offset and row stride or None, dense
# leading rows, the (i, j) task left out of the lowering or None)
INPLACE = {
    "n500-ragged-stripe": (90, 500, 32, 128, None, 0, None),
    "n128": (77, 128, 32, 128, None, 0, None),
    "n7": (45, 7, 16, None, None, 0, None),
    "strided-aligned": (90, 124, 32, 128, (4, 140), 0, None),
    "strided-odd": (45, 7, 16, None, (3, 20), 0, None),
    "uncovered-block": (77, 128, 32, 128, None, 0, (1, 0)),
    "mixed-gemm": (90, 64, 32, 32, None, 32, None),
}


def _inplace_case(name, device):
    """A compiled dispatch of case ``name`` of :data:`INPLACE` on
    ``device`` and its operands: ``(dispatch, densified x or None, y,
    dense adjacency)``.  The adjacency has a self-loop on every vertex and
    ~4 % other entries; where the case asks, its leading rows are dense
    and the Analyzer sends their stripe to the dense engine, else every
    task goes to the sparse one.  ``y`` is normal, and where the
    case is strided it is a column window of a wider matrix whose other
    columns and trailing rows hold NaN, so any read outside the window
    would show in the result."""
    from repro_torch.core import DynasparseEngine, SparseCOO
    from repro_torch.core import dispatch as td
    n, N, tm, tn, window, dense, drop = INPLACE[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    a = (rng.uniform(size=(n, n)) < 0.04) * rng.normal(size=(n, n))
    np.fill_diagonal(a, 1.0 + rng.uniform(size=n))
    a[:dense] = rng.normal(size=(dense, n))
    a = a.astype(np.float32)
    r, c = np.nonzero(a)
    adj = SparseCOO((n, n), torch.as_tensor(r.astype(np.int32), device=device),
                    torch.as_tensor(c.astype(np.int32), device=device),
                    torch.as_tensor(a[r, c], device=device), tag="adjacency")
    yd = rng.normal(size=(n, N)).astype(np.float32)
    if window is None:
        y = torch.as_tensor(yd, device=device)
    else:
        off, width = window
        buf = torch.full((n + 8, width), float("nan"), device=device)
        buf[:n, off:off + N] = torch.as_tensor(yd, device=device)
        y = buf[:n, off:off + N]
        assert y.stride() == (width, 1)
    eng = DynasparseEngine(tile_m=tm, tile_n=tn, literal=True, device=device,
                           mode="dynamic" if dense else "sparse_only")
    plan = eng.plan(adj, y)
    prims = {t.primitive for t in plan.stq + plan.dtq}
    assert prims == ({"GEMM", "SpDMM"} if dense else {"SpDMM"}), prims
    d, xd = eng.compiled_operands(plan, adj)
    if drop is not None:
        _, entry = eng._packed_structure(plan, adj)
        stq = [t for t in plan.stq if (t.i, t.j) != drop]
        assert len(stq) == len(plan.stq) - 1
        d = td.build_dispatch(plan.part, stq, plan.dtq, entry.stripes,
                              block=eng.block)
        a[drop[0] * tm:(drop[0] + 1) * tm] = 0   # its rows' answer
    return d, xd, y, a


def inplace_against_padded(name, device, monkeypatch):
    """Run case ``name`` through ``apply_dispatch`` and through the padded
    ``apply_prepared`` body; assert the route each takes, the coverage
    flag, that no entry reads a row of Y at or past K, and that the two
    agree bitwise.  Returns ``(in-place result, dense adjacency, y)``."""
    from repro_torch.core import dispatch as td
    d, xd, y, a = _inplace_case(name, device)
    g = d.geom
    padded = []
    prepared = td.apply_prepared
    monkeypatch.setattr(td, "apply_prepared",
                        lambda *args: padded.append(1) or prepared(*args))
    assert td.in_place(g) == (name != "mixed-gemm")
    if td.in_place(g):
        assert d.covered == (name != "uncovered-block")
    # the K tail: the entries address Y's last, ragged block row, but
    # every non-zero A column of an entry maps to a row below K
    arr = d.arrays
    blocks = arr["sp_pool"][arr["sp_a_ids"].long()].cpu()
    live = (blocks != 0).any(dim=1)                      # (E, B) columns
    rows = (arr["sp_y_rows"].long().cpu()[:, None] * g.B
            + torch.arange(g.B)[None, :])
    assert int(rows[live].max()) < g.K
    assert g.K % g.B == 0 or int(rows.max()) >= g.K
    # garbage where an uninitialized result would be allocated
    junk = torch.full((g.M * g.N + 4096,), float("nan"), device=device)
    del junk
    got = td.apply_dispatch(g, arr, xd, y, covered=d.covered)
    assert padded == ([1] if name == "mixed-gemm" else [])
    want = prepared(g, arr, xd, td._stripe_padded_y(g, y),
                    td._gemm_y_panel(g, y) if g.has_gemm else None)
    assert got.shape == (g.M, g.N) and got.is_contiguous()
    assert torch.equal(got, want)
    return got, a, y


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(INPLACE))
def test_inplace_sparse_body_equals_padded_body_on_card(cuda, case,
                                                        monkeypatch):
    """The in-place sparse body on the card (``spdmm_fused`` reading Y at
    its stride, clipping its ragged stripe, K and M tails) is bitwise the
    padded body's result, takes ``torch.zeros`` where a block is
    uncovered, leaves mixed plans on ``apply_prepared``, and equals the
    CPU's answer."""
    got, a, y = inplace_against_padded(case, cuda, monkeypatch)
    assert not torch.isnan(got).any()
    want = a.astype(np.float64) @ y.cpu().double().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-4)


def compile_small(model, device, *, dense=0):
    """``compile_model`` of ``model`` on a 90-vertex graph with 12
    features on ``device``: ``(compiled model, features, warm-up
    logits)``.  The graph
    has a self-loop on every vertex and ~4 % other edges; with ``dense``
    its leading rows are dense and the Analyzer chooses every kernel's
    queues (the dense stripe goes to the dense engine), else every task
    goes to the sparse engine."""
    from repro_torch.core import DynasparseEngine, SparseCOO
    from repro_torch.models import gnn
    rng = np.random.default_rng(90 + dense)
    n = 90
    a = (rng.uniform(size=(n, n)) < 0.04) * rng.uniform(size=(n, n))
    np.fill_diagonal(a, 1.0)
    a[:dense] = rng.uniform(size=(dense, n))
    a = a.astype(np.float32)
    r, c = np.nonzero(a)
    adj = SparseCOO((n, n), torch.as_tensor(r.astype(np.int32), device=device),
                    torch.as_tensor(c.astype(np.int32), device=device),
                    torch.as_tensor(a[r, c], device=device), tag="adjacency")
    h = torch.as_tensor(rng.normal(size=(n, 12)).astype(np.float32),
                        device=device)
    params = gnn.init_params(model, 12, 16, 5, device=device)
    eng = DynasparseEngine(tile_m=32, literal=True, device=device,
                           mode="dynamic" if dense else "sparse_only")
    warm, cm = gnn.compile_model(model, eng, adj, h, params)
    assert cm is not None
    return cm, h, warm


def _device_ops(fn):
    """Device operations (kernels, copies, fills) of one eager call of
    ``fn``, counted by ``torch.profiler`` after a warm call: the most of
    three profiles (a profile may drop a record, never add one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    counts = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA))
    return max(counts)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_inplace_body_drops_the_pads_on_card(cuda, model, monkeypatch):
    """Every adjacency kernel of GCN and GIN on a small graph takes the
    in-place body, and the model's device operations fall by at least
    four per aggregation (the pad's fill and copy, the stripe clone, the
    canvas fill) against the same model on the padded body, with the
    replayed logits bitwise the same."""
    from repro_torch.core import dispatch as td
    cm, h, _ = compile_small(model, cuda)
    assert cm.n_inplace == cm.n_sparse == 2
    inplace_ops = _device_ops(lambda: cm.run(cm.payload, h))
    logits = cm(h)
    monkeypatch.setattr(td, "in_place", lambda geom: False)
    padded, _, _ = compile_small(model, cuda)
    assert padded.n_inplace == 0
    padded_ops = _device_ops(lambda: padded.run(padded.payload, h))
    assert padded_ops - inplace_ops >= 4 * cm.n_inplace, (padded_ops,
                                                          inplace_ops)
    assert torch.equal(padded(h), logits)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16, 20, 8), (100, 500, 128), (64, 7, 3),
                                   (130, 128, 70)])
def test_gemm_batch_scatter_kernel_matches_plain(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, y, rows, cols, z = _gemm_case(rng, T=5, m=m, k=k, n=n, grid=(3, 2))
    xs, ys, rs, cs = _t(x, y, rows, cols, device=cuda)
    tops.reset_cuda_launch_counts()
    got = tgemm.gemm_batch_scatter(xs, ys, rs, cs,
                                   torch.as_tensor(z, device=cuda))
    assert tops.cuda_launch_counts() == {"gemm_batch_scatter": 1}
    want = tgemm.gemm_batch_scatter_plain(xs, ys, rs, cs,
                                          torch.as_tensor(z, device=cuda))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,bn", [(8, 16), (8, 128), (8, 8), (8, 200),
                                  (4, 16), (16, 32)])
def test_spdmm_fused_kernel_matches_plain(cuda, B, bn):
    rng = np.random.default_rng(B * bn)
    a, y, desc, z = _spdmm_case(rng, B=B, bn=bn, nrb=9, ncs=2, K_blocks=7)
    args = _t(a, y, *desc, device=cuda)
    got = tspdmm.spdmm_fused(*args, block_size=B, bn=bn,
                             z=torch.as_tensor(z, device=cuda))
    again = tspdmm.spdmm_fused(*args, block_size=B, bn=bn,
                               z=torch.as_tensor(z, device=cuda))
    want = tspdmm.spdmm_fused_plain(*args, block_size=B, bn=bn,
                                    z=torch.as_tensor(z, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, again)                 # no atomics: bitwise
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["short-runs", "walk"])
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32])
def test_spmm_fused_kernel_matches_plain(cuda, B, case):
    """Short random runs of every ``first`` pattern, and the triple walk's
    case (:func:`_spmm_walk_case`: a run of 2,100 triples with a ``first``
    in its middle, all-zero A columns, Y rows and blocks, sentinel blocks;
    dyadic values, so any wrong or missing term shows), at every block
    size.  The kernel repeats bitwise and equals the plain version."""
    if case == "walk":
        rng = np.random.default_rng(200 + B)
        a, yb, desc, z = _spmm_walk_case(rng, B, 2100, dyadic=True)
    else:
        rng = np.random.default_rng(B)
        a, yb, desc, z = _spmm_case(rng, B=B, nrb=11, ncb=6)
    args = _t(a, yb, *desc, device=cuda)
    canvas = lambda: torch.as_tensor(z, device=cuda)
    tops.reset_cuda_launch_counts()
    got = tspmm.spmm_fused(*args, block_size=B, z=canvas())
    again = tspmm.spmm_fused(*args, block_size=B, z=canvas())
    assert tops.cuda_launch_counts() == {"spmm_fused": 2}
    want = tspmm.spmm_fused_plain(*args, block_size=B, z=canvas())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_operands(cuda):
    rng = np.random.default_rng(0)
    x, y, rows, cols, z = _gemm_case(rng)
    xs, ys, rs, cs, zs = _t(x, y, rows, cols, z, device=cuda)
    with pytest.raises(TypeError):
        tgemm.gemm_batch_scatter(xs.double(), ys, rs, cs, zs)
    with pytest.raises(ValueError):
        tgemm.gemm_batch_scatter(xs, ys, rs, cs, zs.t().contiguous().t())
    with pytest.raises(ValueError):
        tgemm.gemm_batch_scatter(xs, ys, rs, cs, zs.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_literal_engine_on_card_matches_cpu(cuda, model):
    """The whole slice at a small size: the literal engine on the card
    launches the kernels and gives the CPU run's logits."""
    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.models import gnn

    out = {}
    for dev in ("cpu", cuda):
        g = load_graph("CO", scale=0.05, device=dev)
        p = gnn.init_params(model, g.features_dense.shape[1], 16,
                            g.stats.classes, device=dev)
        eng = DynasparseEngine(tile_m=64, tile_n=16, literal=True,
                               device=dev)
        tops.reset_cuda_launch_counts()
        out[str(dev)], _ = gnn.run_inference(model, eng, g.adj,
                                             g.features_dense, p, device=dev)
    launches = tops.cuda_launch_counts()
    assert launches.get("spdmm_fused", 0) > 0, launches
    np.testing.assert_allclose(out[str(cuda)].cpu().numpy(),
                               out["cpu"].numpy(), rtol=1e-4, atol=1e-4)


# ------------------------------------------------ kernels of the 2nd slice
@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 500, 128), (64, 7, 3),
                                   (130, 128, 70), (257, 33, 129),
                                   (131, 128, 7), (300, 2708, 16),
                                   (129, 500, 64), (200, 33, 7),
                                   (70, 1, 128), (257, 7, 16),
                                   (128, 2708, 1), (129, 500, 9)])
@pytest.mark.parametrize("dtype,out", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.bfloat16, torch.bfloat16)])
def test_gemm_kernel_matches_plain(cuda, m, k, n, dtype, out):
    """Every tile (narrow n <= 8 and <= 16, 128 x 64, 128 x 128), with
    vector loads (k % 4 == 0) and without, ragged M, N and K tails, f32 and
    bf16 in and out.  Past k = 500 the values are dyadic (:func:`_values`):
    the sums of normal values reach ~50 there, where two rounding orders
    drift apart by about the f32 tolerance, and dyadic sums are exact in
    both."""
    rng = np.random.default_rng(m * k + n)
    x, y = (torch.as_tensor(_values(rng, s, sc, k > 500),
                            device=cuda).to(dtype)
            for s, sc in (((m, k), 4), ((k, n), 8)))
    tops.reset_cuda_launch_counts()
    got = tgemm.gemm(x, y, out_dtype=out)
    assert tops.cuda_launch_counts() == {"gemm": 1}
    want = tgemm.gemm_plain(x, y, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out and got.shape == (m, n)
    tol = dict(rtol=RTOL, atol=ATOL) if out == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)           # one bf16 rounding apart
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(96, 300, 40), (96, 500, 128),
                                   (96, 500, 7), (96, 33, 16),
                                   (96, 2708, 16), (96, 7, 129)])
def test_gemm_tile_equals_batched_scatter_bitwise(cuda, m, k, n):
    """Every GEMM kernel sums each element with fmaf in increasing k from
    +0, whatever its tile: the dense kernel's product equals, bit for bit,
    the batched scatter kernel's tiles (stored into a canvas), the
    same columns of the dense kernel at the widths of its other tiles
    (narrow, 128 x 64, 128 x 128), and each task of the stacked batch
    kernel equals the dense kernel on that task's operands."""
    rng = np.random.default_rng(m + k + n)
    rand = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                      device=cuda)
    x, y = rand(m, k), rand(k, n)
    full = tgemm.gemm(x, y)
    z = torch.zeros((m, n), device=cuda)
    rows = torch.arange(3, dtype=torch.int32, device=cuda)
    cols = torch.zeros(3, dtype=torch.int32, device=cuda)
    tgemm.gemm_batch_scatter(x.reshape(3, m // 3, k).contiguous(),
                             y.expand(3, k, n).contiguous(), rows, cols, z)
    assert torch.equal(full, z)
    for width in (16, 40, 130):
        if width > n:
            wide = torch.cat([y, rand(k, width - n)], dim=1)
            assert torch.equal(tgemm.gemm(x, wide)[:, :n], full)
    x3, y3 = rand(3, m + 5, k), rand(3, k, n)
    stacked = tgemm.gemm_batch(x3, y3)
    for t in range(3):
        assert torch.equal(stacked[t], tgemm.gemm(x3[t].contiguous(),
                                                  y3[t].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 16, 64, 128])
@pytest.mark.parametrize("flag", [0, 1])
def test_predicated_gemm_writes_or_leaves_output(cuda, n, flag):
    """A launch predicated on ``flag == 1`` writes the product when the
    device flag is 1 and leaves every output element as it was when it is
    0, in each tile (the C entry is called on a pre-filled output)."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(n + flag)
    m, k = 130, 68
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32),
                        device=cuda)
    y = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32),
                        device=cuda)
    z = torch.full((m, n), 1234.5, device=cuda)
    f = torch.tensor([flag], dtype=torch.int32, device=cuda)
    err = _build.library().gemm_tiled(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), m, k, n, 0, 0, f.data_ptr(),
        1, torch.cuda.current_stream(cuda).cuda_stream)
    _build.check(err, "gemm")
    want = tgemm.gemm(x, y) if flag == 1 else torch.full_like(z, 1234.5)
    assert torch.equal(z, want)
    assert torch.equal(tgemm.gemm(x, y, pred=(f, flag)), tgemm.gemm(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 16, 64, 128])
@pytest.mark.parametrize("flag", [0, 1])
def test_predicated_scatter_writes_or_leaves_canvas(cuda, n, flag):
    """The scatter predicated on ``flag == 1`` writes its tasks' tiles when
    the device flag is 1 and leaves the whole canvas as it was when it is
    0, in each tile."""
    rng = np.random.default_rng(10 * n + flag)
    x, y, rows, cols, z = _gemm_case(rng, T=5, m=40, k=68, n=n)
    xs, ys, rs, cs = _t(x, y, rows, cols, device=cuda)
    f = torch.tensor([flag], dtype=torch.int32, device=cuda)
    canvas = lambda: torch.as_tensor(z, device=cuda)
    got = tgemm.gemm_batch_scatter(xs, ys, rs, cs, canvas(), pred=(f, 1))
    want = (tgemm.gemm_batch_scatter(xs, ys, rs, cs, canvas()) if flag == 1
            else canvas())
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("T,m,k,n", [(8, 100, 500, 128), (3, 5, 7, 9),
                                     (1, 64, 64, 64), (2, 131, 128, 7),
                                     (3, 129, 33, 16), (2, 70, 500, 1),
                                     (2, 257, 2708, 64), (4, 130, 1, 129),
                                     (2, 200, 7, 128)])
def test_gemm_batch_kernel_matches_plain(cuda, T, m, k, n):
    """Each tile and both load variants, as for ``gemm`` (dyadic values
    past k = 500)."""
    rng = np.random.default_rng(T + m)
    x = torch.as_tensor(_values(rng, (T, m, k), 4, k > 500), device=cuda)
    y = torch.as_tensor(_values(rng, (T, k, n), 8, k > 500), device=cuda)
    tops.reset_cuda_launch_counts()
    got = tgemm.gemm_batch(x, y)
    assert tops.cuda_launch_counts() == {"gemm_batch": 1}
    want = tgemm.gemm_batch_plain(x, y)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def _block_sparse(rng, m, k, block_density, block=8):
    nrb, ncb = -(-m // block), -(-k // block)
    mask = (rng.uniform(size=(nrb, ncb)) < block_density).astype(np.float32)
    full = rng.normal(size=(nrb * block, ncb * block))
    return (full * np.kron(mask, np.ones((block, block))))[:m, :k].astype(
        np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("B,m,k,n,cap", [(8, 40, 70, 36, 0),
                                         (8, 64, 64, 200, 5),
                                         (16, 50, 70, 36, 3),
                                         (4, 9, 13, 5, 0)])
def test_spdmm_kernel_matches_plain_and_fused(cuda, B, m, k, n, cap):
    from repro_torch.kernels.formats import pack_blockcsr
    rng = np.random.default_rng(B + m + n)
    a = pack_blockcsr(_block_sparse(rng, m, k, 0.4, block=B), B,
                      device=cuda)
    if cap:
        a = pack_blockcsr(a.todense(), B, capacity=a.stored_blocks + cap)
    y = torch.as_tensor(rng.normal(size=(a.n_block_cols * B, n)).astype(
        np.float32), device=cuda)
    tops.reset_cuda_launch_counts()
    got = tspdmm.spdmm(a, y)
    assert tops.cuda_launch_counts() == {"spdmm": 1}
    want = tspdmm.spdmm_plain(a, y)
    # the same entries through the fused kernel: bitwise the same tile
    ids = torch.arange(a.stored_blocks, dtype=torch.int32, device=cuda)
    fused = tspdmm.spdmm_fused(
        a.blocks, y, ids, a.col_ids, a.row_ids, torch.zeros_like(ids),
        a.first, block_size=B, bn=n, z=torch.zeros_like(got))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, fused)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("bn", [1, 7, 8, 16, 128, 200])
def test_spdmm_fused_walk_matches_plain(cuda, B, bn):
    """The pipelined run walk: a run of 2,100 entries with a ``first`` in
    its middle, short runs of every ``first`` pattern, all-zero columns and
    all-zero filler blocks, every block size and width.  It repeats
    bitwise and equals the plain version (dyadic values: every partial sum
    is exact, so any wrong or missing term shows)."""
    rng = np.random.default_rng(100 * B + bn)
    a, y, desc, z = _walk_case(rng, B, bn, 2100, dyadic=True)
    args = _t(a, y, *desc, device=cuda)
    kw = dict(block_size=B, bn=bn)
    canvas = lambda: torch.as_tensor(z, device=cuda)
    tops.reset_cuda_launch_counts()
    got = tspdmm.spdmm_fused(*args, z=canvas(), **kw)
    again = tspdmm.spdmm_fused(*args, z=canvas(), **kw)
    assert tops.cuda_launch_counts() == {"spdmm_fused": 2}
    want = tspdmm.spdmm_fused_plain(*args, z=canvas(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4, 8, 16])
def test_spmm_fused_share_boundaries_and_predicate(cuda, B):
    """Thousands of runs of one to four triples (an entry count that is no
    multiple of the warps' shares, so run starts fall on both sides of
    every share boundary), runs with no ``first`` that add onto the
    canvas, zero A columns and Y rows, and the overflow predicate both
    ways: the launch that matches the flag equals the plain version and
    repeats bitwise, the other leaves the canvas untouched."""
    rng = np.random.default_rng(300 + B)
    nrb, ncb, Pa, Py = 700, 3, 97, 61
    a = rng.normal(size=(Pa, B, B)).astype(np.float32)
    a *= rng.uniform(size=(Pa, 1, B)) >= 0.6
    yb = rng.normal(size=(Py, B, B)).astype(np.float32)
    yb *= rng.uniform(size=(Py, B, 1)) >= 0.4
    desc = _runs(rng, nrb, ncb, Pa, Py, cover=0.9)
    assert len(desc[0]) % 32 != 0
    z = rng.normal(size=(nrb * B, ncb * B)).astype(np.float32)
    args = _t(a, yb, *desc, device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    canvas = lambda: torch.as_tensor(z, device=cuda)
    got = tspmm.spmm_fused(*args, block_size=B, z=canvas(), pred=(flag, 0))
    again = tspmm.spmm_fused(*args, block_size=B, z=canvas(), pred=(flag, 0))
    idle = tspmm.spmm_fused(*args, block_size=B, z=canvas(), pred=(flag, 1))
    want = tspmm.spmm_fused_plain(*args, block_size=B, z=canvas())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(idle, canvas())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_spmm_fused_empty_list_keeps_canvas(cuda):
    """No triple: no launch, and the canvas is returned unchanged."""
    B = 8
    z = torch.arange(64 * 16, dtype=torch.float32, device=cuda).reshape(64,
                                                                         16)
    pool = torch.zeros((1, B, B), device=cuda)
    empty = [torch.zeros(0, dtype=torch.int32, device=cuda)
             for _ in range(5)]
    tops.reset_cuda_launch_counts()
    got = tspmm.spmm_fused(pool, pool, *empty, block_size=B, z=z.clone())
    torch.cuda.synchronize()
    assert tops.cuda_launch_counts() == {}
    assert torch.equal(got, z)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4, 8, 16])
def test_spmm_equals_dense_gemm_bitwise(cuda, B):
    """The k-order invariant of the SpMM walk: block-sparse operands with
    all-zero columns inside A's blocks, all-zero rows inside Y's blocks and
    whole zero blocks, multiplied through ``ops.spmm`` (only the pairs of
    stored blocks, in block-column order), are bitwise the dense ``gemm``
    kernel's product, which sums every k from 0 with fmaf."""
    from repro_torch.kernels.formats import pack_blockcsr
    rng = np.random.default_rng(400 + B)
    nrb, ncb, ncy = 5, 120, 4
    k = ncb * B
    x = rng.normal(size=(nrb * B, k)).astype(np.float32)
    x *= np.repeat(rng.uniform(size=(nrb, k)) >= 0.6, B, axis=0)
    x *= np.kron(rng.uniform(size=(nrb, ncb)) >= 0.3, np.ones((B, B)))
    y = rng.normal(size=(k, ncy * B)).astype(np.float32)
    y *= np.repeat(rng.uniform(size=(k, ncy)) >= 0.5, B, axis=1)
    y *= np.kron(rng.uniform(size=(ncb, ncy)) >= 0.3, np.ones((B, B)))
    x = np.ascontiguousarray(x[:nrb * B - 3])
    y = np.ascontiguousarray(y[:, :ncy * B - 2])
    a, yb = pack_blockcsr(x, B, device=cuda), pack_blockcsr(y, B,
                                                            device=cuda)
    xs, ys = (torch.as_tensor(v, device=cuda) for v in (x, y))
    tops.reset_cuda_launch_counts()
    got = tops.spmm(a, yb)
    want = tops.gemm(xs, ys, out_dtype=torch.float32)
    assert tops.cuda_launch_counts() == {"spmm_fused": 1, "gemm": 1}
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.cpu().numpy(), x.astype(np.float64) @ y,
                               rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [8, 16, 128])
def test_spdmm_fused_many_runs_padded_slots_and_predicate(cuda, bn):
    """More runs than thread blocks on the card (each thread block walks
    the runs that start in its share of the entries), runs of one to four
    entries, normal values, and the overflow predicate both ways: the
    launch that matches the flag equals the plain version, the other
    leaves the canvas untouched."""
    rng = np.random.default_rng(bn)
    B, nrb, ncs = 8, 1500, 2
    a = rng.normal(size=(97, B, B)).astype(np.float32)
    a *= rng.uniform(size=(97, 1, B)) >= 0.6
    y = rng.normal(size=(50 * B, ncs * bn)).astype(np.float32)
    desc = _runs(rng, nrb, ncs, 97, 50, cover=0.9)
    z = rng.normal(size=(nrb * B, ncs * bn)).astype(np.float32)
    args = _t(a, y, *desc, device=cuda)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    kw = dict(block_size=B, bn=bn)
    got = tspdmm.spdmm_fused(*args, z=torch.as_tensor(z, device=cuda),
                             pred=(flag, 0), **kw)
    idle = tspdmm.spdmm_fused(*args, z=torch.as_tensor(z, device=cuda),
                              pred=(flag, 1), **kw)
    want = tspdmm.spdmm_fused_plain(*args, z=torch.as_tensor(z, device=cuda),
                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(idle, torch.as_tensor(z, device=cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n", [(8, 16), (8, 128), (16, 40), (4, 7)])
def test_spdmm_equals_dense_gemm_bitwise(cuda, B, n):
    """The k-order invariant: a dense matrix whose blocks have zeroed
    columns (and whole zero blocks), packed as a BlockCSR with rows of
    ~200 stored blocks, times a dense operand through ``spdmm`` is bitwise
    the dense ``gemm`` kernel's product, which sums every k from 0 with
    fmaf: the sparse walk keeps that order and leaves out only zeros."""
    from repro_torch.kernels.formats import pack_blockcsr
    rng = np.random.default_rng(B * n)
    nrb, ncb = 6, 300
    m, k = nrb * B - 3, ncb * B
    x = rng.normal(size=(nrb * B, k)).astype(np.float32)
    x *= np.repeat(rng.uniform(size=(nrb, k)) >= 0.6, B, axis=0)
    x *= np.kron(rng.uniform(size=(nrb, ncb)) >= 0.3, np.ones((B, B)))
    x = np.ascontiguousarray(x[:m])
    y = rng.normal(size=(k, n)).astype(np.float32)
    a = pack_blockcsr(x, B, device=cuda)
    assert a.stored_blocks > 150 * nrb
    xs, ys = (torch.as_tensor(v, device=cuda) for v in (x, y))
    tops.reset_cuda_launch_counts()
    got = tops.spdmm(a, ys)
    want = tops.gemm(xs, ys, out_dtype=torch.float32)
    assert tops.cuda_launch_counts() == {"spdmm": 1, "gemm": 1}
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # against float64: K = 2,400 float32 terms
    np.testing.assert_allclose(got.cpu().numpy(), x.astype(np.float64) @ y,
                               rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_ops_spmm_and_spdmm_match_dense(cuda):
    from repro_torch.kernels.formats import pack_blockcsr
    rng = np.random.default_rng(3)
    ad = _block_sparse(rng, 20, 28, 0.5)
    yd = _block_sparse(rng, 28, 12, 0.5)
    a, y = pack_blockcsr(ad, 8, device=cuda), pack_blockcsr(yd, 8,
                                                            device=cuda)
    tops.reset_cuda_launch_counts()
    got = tops.spmm(a, y).cpu().numpy()
    got2 = tops.spdmm(a, torch.as_tensor(yd, device=cuda)).cpu().numpy()
    assert tops.cuda_launch_counts() == {"spmm_fused": 1, "spdmm": 1}
    np.testing.assert_allclose(got, ad @ yd, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got2, ad @ yd, rtol=RTOL, atol=ATOL)


# ---------------------------------- activation route, capture, whole paths
def _act_case(dev, rng, M=64, K=48, N=16, bd=0.35, tm=16, tn=8):
    from repro_torch.core import DynasparseEngine
    x = torch.as_tensor(_block_sparse(rng, M, K, bd), device=dev)
    y = torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32),
                        device=dev)
    eng = DynasparseEngine(tile_m=tm, tile_n=tn, literal=True, device=dev)
    return eng, eng.plan(x, y), x, y


@pytest.mark.gpu
def test_predicated_overflow_route_both_branches(cuda):
    """Exact budget: the skip kernels run and equal the eager batched and
    per-task paths bitwise; one slot short: only the dense gemm runs and
    the route's result is its result bitwise."""
    from repro_torch.core import dispatch as td
    from repro_torch.core.scheduler import execute_plan
    eng, plan, x, y = _act_case(cuda, np.random.default_rng(17))
    assert plan.stq
    need = td.activation_capacity(x, plan.part, eng.block, slack=1.0)
    ad = eng.activation_dispatch_for(plan, x, capacity=need)
    z, diag = td.execute_activation(ad, x, y)
    assert not bool(diag["overflow"])
    z_b = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=True)
    z_p = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=False)
    assert torch.equal(z, z_b) and torch.equal(z, z_p)
    ad2 = eng.activation_dispatch_for(plan, x, capacity=need - 1)
    z_o, diag2 = td.execute_activation(ad2, x, y)
    assert bool(diag2["overflow"])
    assert torch.equal(z_o, tops.gemm(x, y, out_dtype=torch.float32))


def _keyed_runs(rng, E, n_runs, n_row_blocks, n_col_blocks):
    """E entries sorted by output block, split into ``n_runs`` runs of
    random lengths over distinct output blocks, ``first`` at each start."""
    keys = np.sort(rng.choice(n_row_blocks * n_col_blocks, n_runs,
                              replace=False))
    cuts = np.sort(rng.choice(np.arange(1, E), n_runs - 1, replace=False))
    run_of = np.zeros(E, np.int64)
    run_of[cuts] = 1
    run_of = np.cumsum(run_of)
    first = np.zeros(E, np.int32)
    first[np.concatenate([[0], cuts])] = 1
    return ((keys[run_of] // n_col_blocks).astype(np.int32),
            (keys[run_of] % n_col_blocks).astype(np.int32), first)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["spdmm_fused", "spmm_fused"])
def test_fused_kernels_find_varying_run_counts_under_one_capture(cuda,
                                                                 kernel):
    """The fused kernels launched with device-found run offsets inside one
    CUDA graph: replays with 1, 7 and 40 runs over the same 40 entries
    equal the uncaptured kernel bitwise and the plain version within
    tolerance."""
    rng = np.random.default_rng(23)
    B, bn, E, nrb, ncb = 8, 16, 40, 9, 5
    pool = torch.as_tensor(rng.normal(size=(7, B, B)).astype(np.float32),
                           device=cuda)
    if kernel == "spdmm_fused":
        y = torch.as_tensor(rng.normal(size=(4 * B, ncb * bn)).astype(
            np.float32), device=cuda)
        ids_hi, fn, plain = 4, tspdmm.spdmm_fused, tspdmm.spdmm_fused_plain
        kw = dict(block_size=B, bn=bn)
        z0 = rng.normal(size=(nrb * B, ncb * bn)).astype(np.float32)
    else:
        y = torch.as_tensor(rng.normal(size=(6, B, B)).astype(np.float32),
                            device=cuda)
        ids_hi, fn, plain = 6, tspmm.spmm_fused, tspmm.spmm_fused_plain
        kw = dict(block_size=B)
        z0 = rng.normal(size=(nrb * B, ncb * B)).astype(np.float32)
    desc = [torch.zeros(E, dtype=torch.int32, device=cuda) for _ in range(5)]
    z = torch.as_tensor(z0, device=cuda)

    def fill(n_runs):
        rows, cols, first = _keyed_runs(rng, E, n_runs, nrb, ncb)
        ids = (rng.integers(0, 7, E), rng.integers(0, ids_hi, E))
        for d, v in zip(desc, (*ids, rows, cols, first)):
            d.copy_(torch.as_tensor(v.astype(np.int32), device=cuda))
        z.copy_(torch.as_tensor(z0, device=cuda))

    fill(1)
    fn(pool, y, *desc, z=z, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(pool, y, *desc, z=z, **kw)
    for n_runs in (1, 7, 40):
        fill(n_runs)
        graph.replay()
        got = z.clone()
        args = [t.clone() for t in desc]
        want = fn(pool, y, *args, z=torch.as_tensor(z0, device=cuda), **kw)
        ref = plain(pool, y, *args, z=torch.as_tensor(z0, device=cuda), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), n_runs
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_activation_route_varies_under_one_capture(cuda):
    """One CUDA graph of the activation route replays inputs of different
    block sparsity (different run lengths and stored counts) and matches
    the uncaptured route and the eager batched path bitwise each time."""
    from repro_torch.core import dispatch as td
    from repro_torch.core.scheduler import execute_plan
    rng = np.random.default_rng(19)
    eng, plan, x0, y = _act_case(cuda, rng, bd=0.30)
    ad = eng.activation_dispatch_for(plan, x0, slack=1.0)
    static_x = x0.clone()
    td.apply_activation_dispatch(ad.geom, ad.arrays, static_x, y)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        z_s, diag_s = td.apply_activation_dispatch(ad.geom, ad.arrays,
                                                   static_x, y)
    stored = set()
    for keep in (1.0, 0.6, 0.2):
        blocks = rng.uniform(size=(8, 6)) < keep       # 8 x 8 blocks
        xi = x0 * torch.as_tensor(np.kron(blocks, np.ones((8, 8))),
                                  dtype=torch.float32, device=cuda)
        static_x.copy_(xi)
        graph.replay()
        want, _ = td.apply_activation_dispatch(ad.geom, ad.arrays, xi, y)
        z_b = execute_plan(plan.part, plan.stq, plan.dtq, xi, y)
        assert not bool(diag_s["overflow"])
        assert torch.equal(z_s, want) and torch.equal(z_s, z_b)
        stored.add(int(diag_s["stored"]))
    assert len(stored) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_compiled_model_on_card_matches_cpu(cuda, model):
    """compile_model on the card captures one graph, whose replays are
    bitwise repeatable, bitwise the eager warmup pass's logits, and give
    the CPU program's logits."""
    from repro_torch.core import DynasparseEngine
    from repro_torch.data.graphs import load_graph
    from repro_torch.models import gnn

    out = {}
    for dev in ("cpu", cuda):
        g = load_graph("CO", scale=0.05, device=dev)
        p = gnn.init_params(model, g.features_dense.shape[1], 16,
                            g.stats.classes, device=dev)
        eng = DynasparseEngine(tile_m=64, tile_n=16, literal=True,
                               device=dev)
        warm, cm = gnn.compile_model(model, eng, g.adj, g.features_dense,
                                     p)
        z1 = cm(g.features_dense)
        z2 = cm(g.features_dense)
        assert cm.traces == 1 and cm.calls == 2
        assert torch.equal(z1, z2) and torch.equal(z1, warm)
        out[str(dev)] = z1
    assert cm.n_act >= 1 or model == "GCN"
    assert sum(cm.capture_launches[next(iter(cm.capture_launches))].values())
    np.testing.assert_allclose(out[str(cuda)].cpu().numpy(),
                               out["cpu"].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_pertask_path_on_card_equals_batched(cuda):
    """batched=False launches gemm / spdmm / spmm per task and equals the
    batched drain bit for bit on a plan mixing all three primitives."""
    from repro_torch.core import DynasparseEngine, SparseCOO
    from repro_torch.core.scheduler import execute_plan
    rng = np.random.default_rng(1)
    xd = rng.normal(size=(90, 64)).astype(np.float32)
    xd[:32] *= (rng.uniform(size=(32, 64)) < 0.01)
    xd[32:64] *= (rng.uniform(size=(32, 64)) < 0.3)
    yd = rng.normal(size=(64, 44)).astype(np.float32)
    yd[:, :24] *= (rng.uniform(size=(64, 24)) < 0.05)
    r, c = np.nonzero(xd)
    adj = SparseCOO(xd.shape, torch.as_tensor(r.astype(np.int32),
                                              device=cuda),
                    torch.as_tensor(c.astype(np.int32), device=cuda),
                    torch.as_tensor(xd[r, c], device=cuda), tag="adjacency")
    x, y = torch.as_tensor(xd, device=cuda), torch.as_tensor(yd, device=cuda)
    eng = DynasparseEngine(tile_m=32, tile_n=24, literal=True, device=cuda)
    plan = eng.plan(adj, y)
    assert {t.primitive for t in plan.stq + plan.dtq} == {"GEMM", "SpDMM",
                                                          "SpMM"}
    tops.reset_cuda_launch_counts()
    z_p = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=False)
    launches = tops.cuda_launch_counts()
    assert set(launches) == {"gemm", "spdmm", "spmm_fused"}, launches
    z_b = execute_plan(plan.part, plan.stq, plan.dtq, x, y, batched=True)
    z_c = eng.execute(plan, adj, y)
    assert torch.equal(z_p, z_b) and torch.equal(z_p, z_c)
    np.testing.assert_allclose(z_p.cpu().numpy(), xd @ yd, rtol=1e-4,
                               atol=1e-4)
