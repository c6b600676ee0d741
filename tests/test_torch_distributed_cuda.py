"""The LM distribution layer on a mesh that mixes devices: coordinates on
the CPU and on the card, so a mesh step runs two replicas, its
microbatches on different devices, and ``psum8`` and ``pipeline_apply``
move data between devices.  Every case needs a card and skips without one;
this file imports no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_distributed_cuda.py

- a ``(data 2, model 2)`` step whose data rank 0 is the CPU and rank 1 the
  card equals the pieces it is made of (each microbatch's loss and
  gradients from the model group of a ``(1, 2)`` mesh of its rank's
  device, each model rank's gradients summed on the CPU in rank order,
  then ``adamw_update``), and the CPU's single-device step within
  ``STEP_TOL``;
- ``psum8`` over ranks on both devices == ``psum8`` of the same inputs on
  the CPU, bitwise, each rank's result on its own device;
- ``pipeline_apply`` over stages on both devices == the serial loop run on
  the same devices, bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.distributed import sharding as ts
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import psum8

pytestmark = pytest.mark.gpu
CPU = torch.device("cpu")
OPT = AdamWConfig(lr=1e-3, warmup_steps=0)
# the mixed step against its single-device pieces: the blocks updated on
# the card may differ from the CPU's update in the last bits
PIECES_ATOL = 1e-7
# against the CPU-only step: one microbatch's forward and backward ran on
# the card
STEP_TOL = dict(rel=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the mesh puts coordinates on it)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _mixed_mesh(cuda):
    devs = np.empty((2, 2), dtype=object)
    for i, j in np.ndindex(2, 2):
        devs[i, j] = CPU if i == 0 else cuda
    return Mesh(devs, ("data", "model"))


def test_mixed_mesh_step_equals_its_single_device_pieces(cuda):
    cfg = dataclasses.replace(reduce_config(ARCHS["phi3-mini-3.8b"]),
                              d_model=64, n_layers=2, microbatches=2,
                              dtype="float32")
    bundle = build_model(cfg)
    # 6 rows: microbatches of 3, which the 2 data ranks do not divide, so
    # each runs whole on the first rank holding its rows
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (6, 16)))}
    mesh = _mixed_mesh(cuda)
    assert steps.MeshCompute(bundle, mesh).owners(batch, 2) == [(CPU,),
                                                                (cuda,)]
    state = steps.init_state(bundle, 0, CPU, mesh=mesh)
    _, m = steps.make_train_step(bundle, OPT, mesh=mesh)(state, batch)

    # the same step from pieces that are tensor-parallel groups too: each
    # microbatch's loss and gradients from the model group of a (1, 2)
    # mesh of its rank's device (microbatch 0 on the CPU, microbatch 1 on
    # the card), each model rank's gradients summed over the two groups'
    # replicas on the CPU in rank order, divided by 2 when assembled, then
    # ``adamw_update``
    micros = steps.split_batch(batch, 2)
    model = bundle.init(0, CPU)
    total = torch.zeros((), dtype=torch.float32)
    groups = []
    for dev, micro in ((CPU, micros[0]), (cuda, micros[1])):
        pair = Mesh(np.array([[dev, dev]], dtype=object), ("data", "model"))
        compute = steps.MeshCompute(bundle, pair)
        loss, _ = compute.loss_and_grads(
            steps.sharded_state(bundle, model, pair)["params"],
            {k: v.to(dev) for k, v in micro.items()})
        total = total + loss.to(CPU)
        groups.append(compute)
    by_rank = []
    for r in range(2):
        named = [dict(c.replicas[(d, r)].named_parameters())
                 for c, d in zip(groups, (CPU, cuda))]
        by_rank.append({n: named[0][n].grad + named[1][n].grad.to(CPU)
                        for n in named[0]})
    pieces = steps.train_state(bundle, model)
    params = dict(pieces["params"].named_parameters())
    grads = tp.piece_grads(
        [(g, groups[0].plan(r).splits) for r, g in enumerate(by_rank)],
        {n: p.shape for n, p in params.items()}, 2)
    want = adamw_update({n: g.whole() for n, g in grads.items()},
                        pieces["opt"], params, OPT)
    assert torch.equal(m["loss"], total / 2)
    assert torch.equal(m["grad_norm"], want["grad_norm"])
    worst = max((ts.unshard(state["params"][n], CPU) - p).abs().max().item()
                for n, p in params.items())
    assert worst <= PIECES_ATOL, worst

    # and the CPU's single-device step
    alone = steps.init_state(bundle, 0, CPU)
    _, m1 = steps.make_train_step(bundle, OPT)(alone, batch)
    assert m["loss"].item() == pytest.approx(m1["loss"].item(), **STEP_TOL)
    assert m["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(),
                                                  **STEP_TOL)


def test_psum8_across_devices_equals_one_device(cuda):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(4, 4096)).astype(np.float32))
    devs = [CPU, cuda, CPU, cuda]
    got = psum8([x[r].to(d) for r, d in enumerate(devs)])
    want = psum8([x[r] for r in range(4)])[0]
    for out, d in zip(got, devs):
        assert out.device == d
        assert torch.equal(out.cpu(), want)
    budget = 4 * 0.5 * x.abs().max().item() / 127
    assert (want - x.sum(0)).abs().max().item() < budget


def test_pipeline_across_devices_equals_the_serial_loop(cuda):
    devs = [CPU, cuda, CPU, cuda]
    mesh = Mesh(np.array(devs, dtype=object), ("pipe",))
    rng = np.random.default_rng(6)
    ws = torch.as_tensor(rng.normal(size=(4, 16, 16)).astype(np.float32)
                         * 0.5)
    xs = torch.as_tensor(rng.normal(size=(6, 3, 16)).astype(np.float32))

    def stage_fn(w, x):
        assert w.device == x.device
        return torch.tanh(x @ w)

    got = pipeline_apply(mesh, stage_fn, ws, xs)
    assert got.device == CPU
    serial = []
    for m in range(xs.shape[0]):
        y = xs[m]
        for s, d in enumerate(devs):
            y = stage_fn(ws[s].to(d), y.to(d))
        serial.append(y.to(CPU))
    assert torch.equal(got, torch.stack(serial))
