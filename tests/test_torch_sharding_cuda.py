"""Sharded dispatch of the port on the card: a 4-shard mesh whose shards
all sit on one card (``DataMesh((cuda,) * 4)``) runs the CUDA kernels on
each band, and the halo exchange between the shards' buffers.  Every case
needs a card and skips without one; this file imports no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sharding_cuda.py

- sharded == the single-device eager executor of the same placed plan,
  bitwise; halo == replicate, bitwise;
- a compiled mesh model's CUDA-graph replay == its eager run, bitwise;
- a mesh of one card == the single-device engine, bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DynasparseEngine, SparseCOO
from repro_torch.core import scheduler as _scheduler
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.models import gnn

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-4)

# (n, tile_m, tile_n, width, nnz, mode, strategy, eps, y zero share, seed),
# the reference's pinned sharding cases
PINNED = [
    (100, 16, 8, 12, 400, "dynamic", "balanced", 0.0, 0.0, 1),
    (100, 16, 8, 12, 400, "dynamic", "greedy", 0.0, 0.0, 2),
    (64, 8, 8, 4, 2000, "dynamic", "balanced", 0.0, 0.0, 3),
    (64, 8, 8, 4, 2000, "dynamic", "greedy", 0.5, 0.8, 4),
    (40, 8, 16, 20, 60, "sparse_only", "balanced", 0.0, 0.8, 5),
    (129, 16, 8, 8, 800, "dense_only", "balanced", 0.0, 0.0, 6),
    (17, 8, 8, 8, 40, "dynamic", "balanced", 0.5, 0.5, 7),
    (56, 8, 8, 8, 900, "sparse_only", "balanced", 0.5, 0.8, 8),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _graph(dev, n, nnz, seed):
    r = np.random.default_rng(seed)
    rows = np.sort(r.integers(0, n, nnz)).astype(np.int32)
    cols = r.integers(0, n, nnz).astype(np.int32)
    vals = r.standard_normal(nnz).astype(np.float32)
    return SparseCOO((n, n), torch.as_tensor(rows, device=dev),
                     torch.as_tensor(cols, device=dev),
                     torch.as_tensor(vals, device=dev), tag="adjacency")


def _y(dev, n, w, seed, zero_frac):
    r = np.random.default_rng(seed + 1)
    y = r.standard_normal((n, w)).astype(np.float32)
    if zero_frac:
        y = np.where(r.random((n, w)) < zero_frac, 0.0, y)
    return torch.as_tensor(y.astype(np.float32), device=dev)


@pytest.mark.parametrize("case", PINNED, ids=[f"seed{c[-1]}" for c in PINNED])
def test_sharded_equals_eager_and_halo_equals_replicate(cuda, case):
    n, tm, tn, w, nnz, mode, strategy, eps, y_zero, seed = case
    adj, y = _graph(cuda, n, nnz, seed), _y(cuda, n, w, seed, y_zero)
    mesh = DataMesh((cuda,) * 4)
    kw = dict(tile_m=tm, tile_n=tn, literal=True, mode=mode,
              strategy=strategy, eps=eps, device=cuda)
    ops.reset_cuda_launch_counts()
    eng = DynasparseEngine(mesh=mesh, **kw)
    z = eng.matmul(adj, y)[0]
    assert sum(ops.cuda_launch_counts().values()) > 0
    z_r = DynasparseEngine(mesh=mesh, operand_sharding="replicate",
                           **kw).matmul(adj, y)[0]
    plan = eng.last_plan
    key, entry = eng._packed_structure(plan, adj)
    xd = eng._ensure_dense(key, entry, adj) if plan.dtq else None
    z_e = _scheduler.execute_plan(plan.part, plan.stq, plan.dtq, xd, y,
                                  block=eng.block, batched=True,
                                  packed=entry.stripes, eps=eps)
    assert torch.equal(z, z_r)
    assert torch.equal(z, z_e)
    z1 = DynasparseEngine(mesh=make_data_mesh(1), **kw).matmul(adj, y)[0]
    assert torch.equal(z1, DynasparseEngine(**kw).matmul(adj, y)[0])


@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_compiled_mesh_model_replays_its_eager_run(cuda, model):
    """A 4-shard halo engine through ``compile_model``: the capture holds
    the exchange and every shard's kernels, the replays are bitwise equal
    to the eager mesh run, and the logits are within 1e-4 of the plain
    run."""
    adj = _graph(cuda, 512, 4000, 3)
    h = _y(cuda, 512, 32, 3, 0.5)
    params = gnn.init_params(model, 32, 16, 8, device=cuda)
    eng = DynasparseEngine(literal=True, tile_m=64, tile_n=16, device=cuda,
                           mesh=DataMesh((cuda,) * 4))
    eager, _ = gnn.run_inference(model, eng, adj, h, params, device=cuda)
    warm, cm = gnn.compile_model(model, eng, adj, h, params)
    assert cm is not None and cm.n_sparse >= 1
    z1, z2 = cm(h), cm(h)
    assert cm.traces == 1 and sum(
        cm.capture_launches[(tuple(h.shape), str(h.dtype))].values()) > 0
    assert torch.equal(warm, eager)
    assert torch.equal(z1, eager) and torch.equal(z2, eager)
    plain, _ = gnn.run_inference(model, DynasparseEngine(device=cuda), adj,
                                 h, params, device=cuda)
    torch.testing.assert_close(z1, plain, **TOL)
