"""Device policy shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
nothing quietly moves to the CPU.  Tensors handed to an engine must already
live on its device (numpy arrays are uploaded there).
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a bare ``"cuda"`` is pinned to the
    current card so device equality checks compare like with like."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``.  numpy arrays and Python values are
    uploaded; a tensor on another device is refused rather than moved."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"tensor on {x.device}, expected {device}: move it explicitly")
        return x if dtype is None else x.to(dtype)
    x = np.asarray(x)
    if not x.flags.writeable:       # e.g. a read-only view of a JAX array
        x = x.copy()
    return torch.as_tensor(x, device=device, dtype=dtype)


def host(t) -> np.ndarray:
    """numpy view of a tensor's contents (a device sync for CUDA tensors).
    numpy has no bfloat16, so a bfloat16 tensor comes back widened to
    float32, which is exact."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return np.asarray(t)


def capture_graph(fn, device: torch.device):
    """Capture ``fn()`` as one ``torch.cuda.CUDAGraph`` on ``device``;
    returns ``(graph, out)``, ``out`` being what the captured call returned
    (its tensors are the graph's static outputs).  One uncaptured call on a
    side stream comes first, as CUDA graph capture asks: it makes the lazy
    one-time work (loading the kernel library, the allocator's first
    blocks) happen outside the capture."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out
