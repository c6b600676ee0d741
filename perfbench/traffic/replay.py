"""Closed-loop replay: one caller calls the compiled program back to back,
cycling through the pool of device-resident feature matrices in an order
drawn from the seed; each call is timed until its logits are synchronized
on the device.

Entry: ``gnn.compile_model`` over ``DynasparseEngine(literal=True)``, then
``CompiledModel.__call__`` (a CUDA-graph replay on the card).
"""
from __future__ import annotations

import random
import time

from repro_torch.core import DynasparseEngine
from repro_torch.models import gnn

from perfbench import program
from perfbench.tracing import span
from perfbench.window import Window, sync


class Driver:
    unit = "infer"

    def __init__(self, cfg: dict, mix: dict, inputs, device, seed: int):
        self.device = device
        self.pool = inputs.pool
        self.order = list(range(len(self.pool)))
        random.Random(int(seed)).shuffle(self.order)
        engine = DynasparseEngine(literal=True, device=device)
        _, self.cm = gnn.compile_model(cfg["model"], engine,
                                       program.adjacency(inputs),
                                       self.pool[0], inputs.params)
        if self.cm is None:
            raise RuntimeError(f"compile_model declined {cfg['name']}")
        for h in self.pool:         # the capture, then every pool member
            self.cm(h)
        sync(device)

    def _calls(self, seconds: float, sampler=None, tracing=False) -> Window:
        lat, host = [], []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i, t2 = 0, t_start
        while t2 < deadline:
            k = self.order[i % len(self.order)]
            t0 = time.perf_counter()
            with span("model_entry.call", tracing):
                z = self.cm(self.pool[k])
            t1 = time.perf_counter()
            with span("sync", tracing):
                sync(self.device)
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            host.append(t1 - t0)
            if sampler is not None:
                sampler.offer(k, z)
            i += 1
        return Window(t_start=t_start, t_end=t2, attempted=i, failed=0,
                      latencies=lat, counters={"call_host_s": host})

    def window(self, seconds: float, sampler) -> Window:
        return self._calls(seconds, sampler)

    def profile(self, seconds: float) -> int:
        """Calls for ``seconds`` under the benchmark's spans; the number
        completed."""
        return self._calls(seconds, tracing=True).completed

    def close(self) -> None:
        self.cm = None
