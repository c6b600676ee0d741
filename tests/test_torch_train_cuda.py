"""The LM training path on the card, at small sizes, through the phase
functions of ``chip_smoke.py`` (each raises on a failed check): the flash
VJP against autograd in float32 and bfloat16; one float32 step of every
reduced arch on the card against the CPU, two microbatches against one
(MoE: against the two halves) and ``remat="full"`` against none; the
in-process restart bitwise and the train CLI resumed; plus a short
bfloat16 training run whose loss falls.  Every case needs a card and
skips without one; this file imports no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the training path runs on it)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 40, 4, 2, 16, 16),
                                   (2, 256, 8, 2, 64, 64)])
def test_flash_vjp_equals_autograd_on_the_card(cuda, smoke, shape):
    out = smoke.drive_flash_vjp(torch, cuda, shape)
    assert set(out) == {"float32", "bfloat16"}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(ARCHS))
def test_reduced_step_on_the_card_equals_the_cpu(cuda, smoke, arch):
    out = smoke.drive_train_reduced(torch, cuda, [arch])
    assert "card == cpu" in out[arch]


@pytest.mark.gpu
def test_restart_is_bitwise_and_the_cli_resumes(cuda, smoke, tmp_path):
    out = smoke.drive_train_restart(torch, cuda, str(tmp_path))
    assert len(out["losses"]) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m",
                                  "deepseek-v2-lite-16b"])
def test_reduced_training_loss_falls(cuda, smoke, arch):
    out = smoke.drive_train_arch(torch, arch, reduce_config(ARCHS[arch]),
                                 cuda, batch=8, seq=64)
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.gpu
def test_restore_places_a_host_checkpoint_on_the_card(cuda, tmp_path):
    """``restore(..., device=)``: a checkpoint of a CPU state written into
    a CPU template's tensors on the card, values and dtypes kept."""
    from repro_torch.checkpoint import CheckpointManager

    state = {"w": torch.arange(6.0), "m": torch.ones(3, dtype=torch.bfloat16),
             "step": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state, blocking=True)
    template = {k: torch.zeros_like(v) for k, v in state.items()}
    held = dict(template)
    mgr.restore(template, device=cuda)
    for k, v in state.items():
        assert template[k] is held[k] and template[k].device == cuda
        assert torch.equal(template[k].cpu(), v)
