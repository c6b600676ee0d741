"""The harness as data: ``BENCHMARK.json`` against the benchmark contract,
every file it names, and each cell's run rehearsed on the host with the
kernels' plain versions, down to the result line's keys."""
import json
import re
import subprocess
import sys

import pytest
import torch

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in \
        text and "\t" not in text


def test_benchmark_json_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/configs/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_a_cell_names_exists(cell):
    c = harness.load_cell(cell)
    assert (harness.PERF / "traffic" / f"{c.mix['driver']}.py").exists()
    assert c.limits and all(v > 0 for v in c.limits.values())
    for traced in (False, True):
        specs = harness.metrics_for(BENCH, cell, traced)
        assert specs, (cell, traced)
        for m in specs:
            assert (harness.PERF / "metrics"
                    / f"{m['name'].split('.')[0]}.py").exists()
    e2e = [m["name"] for m in harness.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearsal_prints_the_result_line(rehearse, cell, trace):
    r = rehearse(cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert [k for k in r if k != "breakdown"] == keys
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["count"] == 1
    assert set(r["checks"]) == {"logits_err"}
    want = {m["name"]: m["unit"]
            for m in harness.metrics_for(BENCH, cell, trace)}
    got = {k: v["unit"] for k, v in r["metrics"].items()}
    assert got.items() <= want.items()
    if not trace:
        assert got == want                # nothing here needs the device
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        # host-side readers read; device-side ones find nothing on the CPU
        assert not any("roofline" in k or "idle" in k for k in got)
        assert any(k.startswith("mfu.") for k in got)
    json.dumps(r, allow_nan=False)


def test_run_refuses_without_enough_cards(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the refusal is not reached")
    p = subprocess.run(
        [sys.executable, str(harness.PERF / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr
