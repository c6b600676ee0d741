"""The port's LM training path against the JAX reference on the CPU, in
the variants of ``test_torch_train.py`` (whose helpers it uses), at
``reduce_config``:

- the config's bfloat16 loss for every arch of ``ARCHS`` within 5e-2
  (the reference compiled with XLA's excess precision off, as in
  ``test_torch_lm.py``), its gradients float32;
- two microbatches: one ``make_train_step`` step held as
  ``test_torch_train.py`` holds one microbatch, against the reference's
  compiled ``make_train_step``, for a dense arch with a tied embedding,
  the MoE arch (expert capacity is per microbatch), the enc-dec arch
  (frames) and the VLM (a frontend prefix and M-RoPE positions);
- ``remat="full"``, for an arch of each kind of cycle and layer (dense
  attention, the RG-LRU hybrid with its tail layer, MLA with MoE, the
  enc-dec stacks, SSD): the loss and every gradient with each cycle
  (enc-dec: each layer) recomputed in the backward
  (``torch.utils.checkpoint``) against the reference's ``jax.checkpoint``
  within float32's tolerances, and against the port's own
  ``remat="none"`` run."""
import jax
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as ref_build
from repro_torch.models.layers import trainable
from repro_torch.models.registry import build_model
from test_torch_train import (ARCH_IDS, GRAD, LOSS_RTOL, assert_tree_close,
                              check_train_step, configs, grads_of,
                              make_batch, port_batch, port_model, ref_batch,
                              ref_params, ref_value_and_grad)

BF16_LOSS = 5e-2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_loss_matches_the_reference(arch):
    cfg, ref = configs(arch, dtype="bfloat16")
    bundle = build_model(cfg)
    model = trainable(port_model(bundle, ref_params(arch)))
    batch = make_batch(cfg)
    loss = bundle.loss(model, port_batch(batch))
    loss.backward()
    assert loss.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)
    rb = ref_build(ref)
    rp, rbatch = ref_params(arch), ref_batch(batch)
    want = jax.jit(rb.loss).lower(rp, rbatch).compile(
        compiler_options={"xla_allow_excess_precision": False})(rp, rbatch)
    np.testing.assert_allclose(loss.item(), float(want), rtol=BF16_LOSS,
                               atol=BF16_LOSS)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "seamless-m4t-medium", "qwen2-vl-72b"])
def test_two_microbatches_match_the_reference_f32(arch):
    check_train_step(arch, mb=2)


def _loss_and_grads(arch, remat):
    cfg, _ = configs(arch, remat=remat)
    bundle = build_model(cfg)
    model = trainable(port_model(bundle, ref_params(arch)))
    loss = bundle.loss(model, port_batch(make_batch(cfg)))
    loss.backward()
    return bundle, loss, grads_of(model)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b",
                                  "seamless-m4t-medium", "mamba2-780m"])
def test_remat_full_matches_the_reference_f32(arch):
    bundle, loss, grads = _loss_and_grads(arch, "full")
    assert bundle.cfg.remat == "full"
    want_loss, want_grads = ref_value_and_grad(arch, remat="full")
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    assert_tree_close(bundle, grads, want_grads, GRAD, f"{arch} remat")
    _, plain_loss, plain = _loss_and_grads(arch, "none")
    np.testing.assert_allclose(loss.item(), plain_loss.item(), rtol=LOSS_RTOL)
    for name, g in grads.items():
        p = plain[name]
        assert (g is None) == (p is None), name
        if g is not None:
            torch.testing.assert_close(g, p, **GRAD, msg=name)
