"""``chip_smoke.py``'s work counts of the dense GEMM calls it times, on
``meta`` tensors (shapes only, no data and no card): the bytes each call
must move (inputs read once, output written once), its FLOPs, and whether
the card's FP32 rate or its memory rate bounds it."""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


# (kernel, x shape, y shape, bytes, FLOPs, bound_by, bound ms at the H100
# peaks): compiled GCN-FL's layer-1 update and logits layer (89,250
# vertices, 500 features, hidden 128, 7 classes) and the dense queue's
# stacked batch (8 x 11264 x 500)
CASES = [
    ("gemm", (89250, 500), (500, 128),
     4 * (89250 * 500 + 500 * 128 + 89250 * 128), 2.0 * 89250 * 500 * 128,
     "operations", 0.170507),
    ("gemm", (89250, 128), (128, 7),
     4 * (89250 * 128 + 128 * 7 + 89250 * 7), 2.0 * 89250 * 128 * 7,
     "bytes", 0.014388),
    ("gemm_batch", (8, 11264, 500), (8, 500, 128),
     4 * (8 * 11264 * 500 + 8 * 500 * 128 + 8 * 11264 * 128),
     2.0 * 8 * 11264 * 500 * 128, "operations", 0.172154),
]


@pytest.mark.parametrize("name,xs,ys,nbytes,flops,by,ms", CASES,
                         ids=["gemm-l1-update", "gemm-logits",
                              "gemm_batch-dense-queue"])
def test_gemm_work_and_bound(smoke, name, xs, ys, nbytes, flops, by, ms):
    args = (_meta(*xs), _meta(*ys))
    kw = {"out_dtype": torch.float32} if name == "gemm" else {}
    assert smoke.work_of(name, args, kw) == (nbytes, flops)
    bound = smoke.bound_of(name, args, kw)
    assert bound["bound_by"] == by
    assert (bound["bytes"], bound["flops"]) == (nbytes, flops)
    want_ms = 1e3 * max(nbytes / smoke.PEAK_HBM_BYTES,
                        flops / smoke.PEAK_FP32_FLOPS)
    assert bound["bound_ms"] == pytest.approx(want_ms, rel=1e-12)
    assert bound["bound_ms"] == pytest.approx(ms, abs=1e-6)


def test_bf16_output_halves_the_output_bytes(smoke):
    x, y = _meta(89250, 128), _meta(128, 7)
    f32, _ = smoke.work_of("gemm", (x, y), {"out_dtype": torch.float32})
    bf16, _ = smoke.work_of("gemm", (x, y), {"out_dtype": torch.bfloat16})
    assert f32 - bf16 == 2 * 89250 * 7
