"""The LM serving path on the card: the decode step captured as one CUDA
graph (``launch.steps.CapturedDecode``) against the same step run eagerly,
bitwise, on reduced configs of all four mixers, MoE and the enc-dec arch;
the MoE reduction repeatable bitwise; decode against forward in float32.
Every case needs a card and skips without one; this file imports no JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch.steps import CapturedDecode, cache_leaves
from repro_torch.models import ffn
from repro_torch.models.registry import build_model


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the decode step is captured as a "
                    "CUDA graph)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def serve(bundle, model, decode, prompts, gen, dev):
    """The serve loop of ``launch/serve.py``: returns every step's logits
    and the generated tokens."""
    batch, plen = prompts.shape
    cache = bundle.init_cache(batch, plen + gen, dev)
    logits, out, toks = None, [], []
    for t in range(plen + gen):
        tok = prompts[:, t:t + 1] if t < plen else logits.argmax(-1)[:, None]
        if t >= plen:
            toks.append(tok)
        logits, cache = decode(model, cache, tok, t)
        out.append(logits)
    return out, torch.cat(toks, dim=1), cache


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "recurrentgemma-9b", "mamba2-780m",
                                  "seamless-m4t-medium", "qwen2-vl-72b"])
def test_captured_decode_equals_eager_bitwise(cuda, arch):
    bundle = build_model(reduce_config(ARCHS[arch]))
    model = bundle.init(0, cuda)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, bundle.cfg.vocab, (4, 8)), device=cuda)
    eager, toks, cache = serve(bundle, model, bundle.decode_step, prompts, 8,
                               cuda)
    graphed = CapturedDecode(bundle)
    replay, rtoks, rcache = serve(bundle, model, graphed, prompts, 8, cuda)
    assert graphed.captures == 1
    for t, (a, b) in enumerate(zip(eager, replay)):
        assert torch.equal(a, b), (arch, t)
    assert torch.equal(toks, rtoks)
    for a, b in zip(cache_leaves(cache), cache_leaves(rcache)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_moe_reduction_is_repeatable(cuda):
    """Many tokens per expert (capacity drops included): two runs of the
    MoE FFN are bitwise equal, eagerly and replayed."""
    cfg = reduce_config(ARCHS["deepseek-v2-lite-16b"])
    model = build_model(cfg).init(1, cuda)
    moe = model.layers()[0].ffn
    x = torch.randn((8, 64, cfg.d_model), generator=torch.Generator(
        cuda).manual_seed(2), device=cuda).to(torch.bfloat16)
    a = ffn.moe_ffn(moe, x)
    b = ffn.moe_ffn(moe, x)
    assert torch.equal(a, b)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ffn.moe_ffn(moe, x)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        c = ffn.moe_ffn(moe, x)
    graph.replay()
    assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_decode_equals_forward_in_float32(cuda, arch):
    cfg = dataclasses.replace(reduce_config(ARCHS[arch]), dtype="float32")
    bundle = build_model(cfg)
    model = bundle.init(3, cuda)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12)), device=cuda)
    full = bundle.forward(model, {"tokens": toks})[..., :cfg.vocab]
    cache = bundle.init_cache(2, 12, cuda)
    for t in range(12):
        logits, cache = bundle.decode_step(model, cache, toks[:, t:t + 1], t)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-4)
