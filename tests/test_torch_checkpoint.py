"""The port's checkpoint manager, token pipeline and train CLI on the CPU:
the ports of ``tests/test_distributed.py``'s five checkpoint tests (round
trip, async writes and retention, atomicity, the config-hash guard,
bitwise restart determinism), the state's leaf names and a bfloat16
round trip, a snapshot that an in-place update right after a
non-blocking ``save`` does not reach, ``TokenPipeline`` batches equal to
the reference's (also after a resume), and ``python -m
repro_torch.launch.train`` run twice with ``--resume``."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.data.lm import TokenPipeline as RefTokenPipeline
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt_lib
from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.data.lm import TokenPipeline
from repro_torch.launch import steps, train
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


# ------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    mgr = CheckpointManager(tmp_path, cfg={"arch": "x"})
    mgr.save(5, state, blocking=True)
    template = {"params": {"w": torch.zeros(3, 4)},
                "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    step, restored = mgr.restore(template)
    assert step == 5 and restored is template
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["opt"]["step"]) == 7
    assert restored["opt"]["step"].dtype == torch.int32


def test_checkpoint_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.ones(4) * s})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    _, restored = mgr.restore({"w": torch.zeros(4)})
    torch.testing.assert_close(restored["w"], torch.full((4,), 4.0))


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(2)}, blocking=True)
    (tmp_path / "step_000000099.tmp").mkdir()     # a crashed writer
    assert mgr.latest_step() == 1


def test_checkpoint_config_hash_guard(tmp_path):
    mgr = CheckpointManager(tmp_path, cfg={"arch": "a"})
    mgr.save(1, {"w": torch.ones(2)}, blocking=True)
    mgr2 = CheckpointManager(tmp_path, cfg={"arch": "DIFFERENT"})
    with pytest.raises(ValueError, match="hash"):
        mgr2.restore({"w": torch.ones(2)})


def test_checkpoint_restart_training_is_deterministic(tmp_path):
    """Train 6 steps; train 3, save, restore into a fresh state, train 3:
    the same final parameters, bitwise."""
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=6)

    def step(state, i):
        x = torch.as_tensor(np.random.default_rng(i).normal(size=(4, 3))
                            .astype(np.float32))
        w = state["params"]["w"]
        w.grad = None
        torch.mean((x @ w - 1.0) ** 2).backward()
        adamw_update({"w": w.grad}, state["opt"], state["params"], opt_cfg)

    def fresh():
        p = {"w": (torch.ones(3) * 0.5).requires_grad_()}
        return {"params": p, "opt": adamw_init(p)}

    s = fresh()
    for i in range(6):
        step(s, i)
    s2 = fresh()
    mgr = CheckpointManager(tmp_path)
    for i in range(3):
        step(s2, i)
    mgr.save(3, s2, blocking=True)
    start, s3 = mgr.restore(fresh())
    assert start == 3 and int(s3["opt"]["step"]) == 3
    for i in range(start, 6):
        step(s3, i)
    assert torch.equal(s3["params"]["w"], s["params"]["w"])


def test_train_state_leaves_are_named_by_the_port_and_round_trip(tmp_path):
    """A training state's leaves: the parameters under their module names,
    ``opt.mu.*``, ``opt.nu.*``, ``opt.step``, ``ef.*``; bfloat16 moments
    come back bitwise, into the template's own tensors."""
    from repro_torch.optim.compression import ef_init

    cfg = reduce_config(ARCHS["deepseek-v2-236b"])
    assert cfg.opt_dtype == "bfloat16"
    bundle = build_model(cfg)
    state = steps.init_state(bundle, 0, "cpu")
    state["ef"] = ef_init(dict(state["params"].named_parameters()))
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 8),
                                     generator=torch.Generator().manual_seed(0))}
    steps.make_train_step(bundle, AdamWConfig(warmup_steps=0))(state, batch)
    names = [n for n, _ in state["params"].named_parameters()]
    leaves = [p for p, _ in ckpt_lib.state_leaves(state)]
    assert leaves == ([f"params.{n}" for n in names]
                      + [f"opt.mu.{n}" for n in names]
                      + [f"opt.nu.{n}" for n in names] + ["opt.step"]
                      + [f"ef.{n}" for n in names])
    mgr = CheckpointManager(tmp_path, cfg=cfg)
    mgr.save(1, state, blocking=True)
    manifest = json.loads((tmp_path / "step_000000001" /
                           "manifest.json").read_text())
    assert [l["path"] for l in manifest["leaves"]] == leaves
    assert {l["dtype"] for l in manifest["leaves"]
            if l["path"].startswith("opt.mu")} == {"bfloat16"}

    fresh = steps.init_state(bundle, 1, "cpu")
    fresh["ef"] = ef_init(dict(fresh["params"].named_parameters()))
    held = [t for _, t in ckpt_lib.state_leaves(fresh)]
    mgr.restore(fresh)
    for (path, a), (_, b), t in zip(ckpt_lib.state_leaves(state),
                                    ckpt_lib.state_leaves(fresh), held):
        assert b is t, path                  # the template's own tensor
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert all(p.requires_grad for p in fresh["params"].parameters())


def test_snapshot_is_not_reached_by_an_update_after_a_non_blocking_save(
        tmp_path, monkeypatch):
    """``save`` copies every leaf before it returns, also a CPU tensor
    (whose ``.cpu()`` is itself): the writer is held until the state has
    been updated in place, and the checkpoint still holds the values of
    the save."""
    updated = threading.Event()
    real_save = ckpt_lib.np.save

    def held_save(*args, **kw):
        assert updated.wait(timeout=30)
        return real_save(*args, **kw)

    monkeypatch.setattr(ckpt_lib.np, "save", held_save)
    p = {"w": torch.arange(6.0)}
    opt = adamw_init(p)
    state = {"params": p, "opt": opt}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    adamw_update({"w": torch.ones(6)}, opt, p,
                 AdamWConfig(warmup_steps=0, weight_decay=0.5))
    updated.set()
    mgr.wait()
    assert int(opt["step"]) == 1
    template = {"params": {"w": torch.zeros(6)}, "opt": adamw_init(
        {"w": torch.zeros(6)})}
    mgr.restore(template)
    assert torch.equal(template["params"]["w"], torch.arange(6.0))
    assert int(template["opt"]["step"]) == 0
    assert not torch.equal(p["w"], torch.arange(6.0))


def test_a_failed_write_raises_at_wait(tmp_path, monkeypatch):
    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib.np, "save", broken)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []


# ------------------------------------------------------------ data
@pytest.mark.parametrize("shard,start", [(0, 0), (1, 0), (0, 5)])
def test_token_pipeline_yields_the_reference_batches(shard, start):
    """For one (seed, shard, step) the port's pipeline yields the
    reference's batch exactly, also when it starts at ``start_step`` (a
    resume)."""
    kw = dict(vocab=1000, batch=3, seq_len=17, shard=shard, n_shards=2,
              seed=7, start_step=start)
    ours, ref = TokenPipeline(**kw), RefTokenPipeline(**kw)
    try:
        for i in range(4):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys() == {"tokens"}
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert ours.step == ref.step == start + i + 1
    finally:
        ours.close()
        ref.close()
    assert not ours._thread.is_alive()


# ------------------------------------------------------------ the CLI
def test_train_cli_resumes_on_the_cpu(tmp_path, capsys):
    """``--steps 4 --ckpt-every 2``, then ``--steps 6 --resume``: the
    reference's lines, the second run resumed from step 4 and numbered
    on; the checkpoints of steps 2, 4 and 6 kept; and one run with
    ``--compress-grads``, whose checkpoint holds the error-feedback
    state."""
    argv = ["--arch", "qwen2.5-3b", "--batch", "4", "--seq", "16",
            "--ckpt-every", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "a")]
    first = train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert len(first) == 4 and all(np.isfinite(first))
    assert [l.split()[2] for l in out] == ["0", "1", "2", "3"]
    assert all(l.startswith("[train] step ") and " loss " in l
               and " gnorm " in l and l.endswith("ms") for l in out)
    second = train.main(argv + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] resumed from step 4"
    assert [l.split()[2] for l in out[1:3]] == ["4", "5"]
    assert len(second) == 2 and len(out) == 3    # no summary for 2 losses
    mgr = CheckpointManager(tmp_path / "a")
    assert mgr.all_steps() == [2, 4, 6]

    cdir = tmp_path / "c"
    losses = train.main(["--arch", "qwen2.5-3b", "--batch", "4", "--seq",
                         "16", "--steps", "5", "--ckpt-every", "5",
                         "--device", "cpu", "--compress-grads",
                         "--ckpt-dir", str(cdir)])
    out = capsys.readouterr().out.splitlines()
    assert len(losses) == 5
    assert out[-1].startswith(f"[train] loss {losses[0]:.4f} -> "
                              f"{losses[-1]:.4f} (")
    manifest = json.loads((cdir / "step_000000005" /
                           "manifest.json").read_text())
    assert any(l["path"].startswith("ef.") for l in manifest["leaves"])


def test_train_cli_refuses_the_production_meshes():
    with pytest.raises(NotImplementedError, match="5c"):
        train.main(["--arch", "qwen2.5-3b", "--mesh", "single",
                    "--device", "cpu"])
