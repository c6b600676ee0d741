"""The port's example scripts (``examples_torch/``) against the
reference's (``examples/``), on the CPU: the reference scripts run
unchanged in subprocesses (one module-scoped fixture) and their standard
output is compared with what the port's ``main(argv)`` prints.

- ``quickstart.py``: every line, the per-kernel table (STQ, DTQ, SpDMM,
  SpMM, makespan), the hardware time and the FLOP counts, ``==``:
  planning is exact in the port.
- ``gnn_inference.py --datasets CO``: every line for all four models
  (hardware time and the dense / executed FLOP ratio), ``==``.
- ``moe_sparse_dispatch.py``: every line, the analyzer's decision and the
  block-sparse product equal to the dense one within the script's stated
  tolerance (``ATOL``).
- ``serve_lm.py`` and ``train_lm.py`` run the port's launchers on the
  CPU (``--device cpu``); the training demo resumes at step 12.
"""
import importlib.util
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
REFERENCE_RUNS = {"quickstart": [], "gnn_inference": ["--datasets", "CO"],
                  "moe_sparse_dispatch": []}


def example(name: str):
    """The port's example script ``name`` as a module."""
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_output():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")

    def run(item):
        name, args = item
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return name, proc.stdout.splitlines()

    with ThreadPoolExecutor(len(REFERENCE_RUNS)) as pool:
        return dict(pool.map(run, REFERENCE_RUNS.items()))


def port_lines(capsys, name, args):
    example(name).main([*args, *CPU])
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_tables(reference_output, capsys):
    got = port_lines(capsys, "quickstart", [])
    want = reference_output["quickstart"]
    assert any(line.startswith("l1-agg") for line in want)
    assert got == want


def test_gnn_inference_prints_the_reference_table(reference_output, capsys):
    got = port_lines(capsys, "gnn_inference", ["--datasets", "CO"])
    want = reference_output["gnn_inference"]
    assert len(want) == 5
    assert got == want


def test_moe_sparse_dispatch_matches_the_reference(reference_output,
                                                   capsys):
    got = port_lines(capsys, "moe_sparse_dispatch", [])
    assert got == reference_output["moe_sparse_dispatch"]
    assert got[-1] == "sparse == dense: True"


def test_serve_lm_runs_each_arch(capfd, monkeypatch):
    # the launchers run as subprocesses beside the other test workers:
    # one thread each keeps them from oversubscribing the CPU
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    example("serve_lm").main(CPU)
    out = capfd.readouterr().out
    for arch in ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-780m"):
        assert f"== {arch} ==" in out


def test_train_lm_resumes_mid_run(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    lines = example("train_lm").main([*CPU, "--ckpt-dir", str(tmp_path)])
    assert "[train] resumed from step 12" in lines
    steps = [line for line in lines if line.startswith("[train] step")]
    assert len(steps) == 18
    assert steps[-1].startswith("[train] step   17")


def test_examples_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    for name in ("quickstart", "gnn_inference", "moe_sparse_dispatch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            example(name).main([])
