"""Open-loop served traffic: requests arrive at the mix's fixed ``rate``,
whatever the server does, each asking for the logits of one feature matrix
drawn from the pool.

The arrivals are Poisson in shape but the same in every run: the gaps are
one fixed draw of exponential gaps (``gap_seed``), which the run's seed
only puts in another order, with the pool members drawn per request.  A
request is timed from when it was due, so a stall of the generator or of
the server counts against every request it delays, until a CUDA event
recorded after its answer arrived has completed.  The events are awaited
in order on one waiting thread (a batch's answers complete together), so
the event loop keeps admitting arrivals meanwhile.

Entry: ``ServingEngine.infer`` over ``DynasparseEngine(literal=True)`` and
a ``SharedPlanCache`` of ``cache_bytes``, with ``max_batch`` and
``pad_to_max_batch`` from the mix.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import random
import time

import torch
from repro_torch.core import DynasparseEngine
from repro_torch.serving import ServingConfig, ServingEngine, SharedPlanCache

from perfbench import program
from perfbench.tracing import span
from perfbench.window import Window, sync

GRAPH = "graph"


def arrivals(rate: float, seconds: float, gap_seed: int,
             seed: int) -> list[float]:
    """Offsets (s) of the arrivals in ``seconds`` at ``rate``: a fixed draw
    of exponential gaps from ``gap_seed``, ordered by ``seed``."""
    draw = random.Random(int(gap_seed))
    gaps = [draw.expovariate(rate) for _ in range(round(rate * seconds))]
    random.Random(int(seed)).shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        t += g
        out.append(t)
    return out


class Driver:
    unit = "request"

    def __init__(self, cfg: dict, mix: dict, inputs, device, seed: int):
        self.device = device
        self.pool = inputs.pool
        self.mix = mix
        self.seed = int(seed)
        cache = SharedPlanCache(device=device, max_bytes=mix["cache_bytes"])
        self.srv = ServingEngine(
            cfg["model"], inputs.params,
            engine=DynasparseEngine(literal=True, cache=cache, device=device),
            config=ServingConfig(max_batch=mix["max_batch"],
                                 pad_to_max_batch=mix["pad_to_max_batch"]))
        self.srv.register_graph(GRAPH, program.adjacency(inputs))
        self.waits = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="perfbench-wait")
        self.runs = 0
        self.srv.serve([(GRAPH, self.pool[0])])     # plan, compile, capture
        self._traffic(mix["warm_s"])
        sync(device)

    async def _ready(self) -> None:
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record()
        await asyncio.get_running_loop().run_in_executor(self.waits,
                                                         ev.synchronize)

    async def _request(self, k: int, due: float, out: dict, sampler,
                       tracing: bool) -> None:
        try:
            with span("serving.infer", tracing):
                z = await self.srv.infer(GRAPH, self.pool[k])
            with span("sync", tracing):
                await self._ready()
        except Exception:           # a failed request: counted, never timed
            out["failed"] += 1
            return
        t = time.perf_counter()
        out["done"].append(t)
        out["latencies"].append(t - due)
        if sampler is not None:
            sampler.offer(k, z)

    def _traffic(self, seconds: float, sampler=None,
                 tracing: bool = False) -> Window:
        st = self.srv.stats
        n0, b0 = len(st.requests), st.batches
        self.runs += 1
        offsets = arrivals(self.mix["rate"], seconds, self.mix["gap_seed"],
                           self.seed * 1009 + self.runs)
        pick = random.Random(self.seed * 1013 + self.runs)
        out = {"failed": 0, "latencies": [], "done": [], "late": []}

        async def generate():
            tasks = []
            start = time.perf_counter()
            for off in offsets:
                due = start + off
                wait = due - time.perf_counter()
                if wait > 0:
                    await asyncio.sleep(wait)
                out["late"].append(time.perf_counter() - due)
                tasks.append(asyncio.ensure_future(self._request(
                    pick.randrange(len(self.pool)), due, out, sampler,
                    tracing)))
            await asyncio.gather(*tasks)
            return start

        start = asyncio.run(generate())
        close = start + seconds
        reqs = st.requests[n0:]
        return Window(
            t_start=start, t_end=close, attempted=len(offsets),
            failed=out["failed"], latencies=out["latencies"],
            counters={"queue_s": [r.t_queue for r in reqs],
                      "batch_size": len(reqs) / max(1, st.batches - b0),
                      "late_s": out["late"],
                      "done_in_window": sum(1 for t in out["done"]
                                            if t <= close)})

    def window(self, seconds: float, sampler) -> Window:
        return self._traffic(seconds, sampler)

    def profile(self, seconds: float) -> int:
        """Traffic for ``seconds`` under the benchmark's spans; the number
        of requests completed."""
        return self._traffic(seconds, tracing=True).completed

    def close(self) -> None:
        self.srv.close()
        self.waits.shutdown(wait=True)
        self.srv = None
