"""Rehearsals of the benchmark's cells on the host: the kernels' plain
versions at a tiny scale, and served traffic at a rate the host keeps up
with."""
import dataclasses

import pytest

from perfbench import harness

SCALE = 0.01
CPU_RATE = 40.0          # requests/s a served rehearsal offers on the host


@pytest.fixture
def rehearse(monkeypatch):
    """``rehearse(workload, seed, trace, seconds, rate)``: one run of the
    cell on the CPU at ``SCALE``, a served mix's arrivals at ``rate``."""
    load = harness.load_cell
    rate = [CPU_RATE]

    def slow(name, bench=None):
        cell = load(name, bench)
        if "rate" in cell.mix:
            cell = dataclasses.replace(cell, mix={**cell.mix,
                                                  "rate": rate[0],
                                                  "warm_s": 0.2})
        return cell

    monkeypatch.setattr(harness, "load_cell", slow)

    def run(workload, seed=2**32 + 5, trace=False, seconds=0.5,
            rate_=CPU_RATE):
        rate[0] = rate_
        return harness.run(workload, seed, seconds, trace, device="cpu",
                           scale=SCALE)
    return run
