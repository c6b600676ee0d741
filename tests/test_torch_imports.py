"""The port stands alone: no file of ``src/repro_torch``, ``chip_smoke.py``,
``scripts/`` or ``examples_torch/`` imports JAX or the JAX package, and
the entry points run on the card unless the caller names the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.core import DynasparseEngine, calibrate
from repro_torch.core.perfmodel import runtime_fallback
from repro_torch.data.graphs import load_graph
from repro_torch.launch import serve, steps, train
from repro_torch.launch.mesh import (make_data_mesh,
                                     make_mesh_for_devices)
from repro_torch.models import gnn
from repro_torch.models.registry import build_model
from repro_torch.serving import SharedPlanCache

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return (files + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py"))
            + sorted((ROOT / "examples_torch").glob("*.py")))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(FORBIDDEN))
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.parametrize("module", ["repro_torch.core.halo",
                                    "repro_torch.core.shard_exec",
                                    "repro_torch.launch.mesh"])
def test_mesh_modules_import_no_jax_and_no_reference_package(module):
    """The modules of the mesh path are among the files checked above, and
    importing one in a fresh interpreter loads no JAX module and nothing
    of the JAX package."""
    _fresh_import_loads_no_jax(module)


@pytest.mark.parametrize("module", ["repro_torch.models.lm",
                                    "repro_torch.models.mixers",
                                    "repro_torch.models.registry",
                                    "repro_torch.launch.serve"])
def test_lm_modules_import_no_jax_and_no_reference_package(module):
    """The LM serving path's modules, checked as the mesh modules are."""
    _fresh_import_loads_no_jax(module)


def test_training_modules_import_no_jax_and_no_reference_package():
    """The LM training path's modules, checked as the mesh modules are,
    all imported in one fresh interpreter."""
    _fresh_import_loads_no_jax(
        "repro_torch.launch.train", "repro_torch.launch.steps",
        "repro_torch.optim.adamw", "repro_torch.optim.compression",
        "repro_torch.checkpoint.manager", "repro_torch.data.lm")


def test_distribution_modules_import_no_jax_and_no_reference_package():
    """The LM distribution layer's modules, checked as the mesh modules
    are, all imported in one fresh interpreter."""
    _fresh_import_loads_no_jax(
        "repro_torch.distributed.sharding", "repro_torch.distributed.pipeline",
        "repro_torch.distributed.elastic", "repro_torch.launch.mesh")


def test_example_scripts_import_no_jax_and_no_reference_package():
    """Each script of ``examples_torch/``, loaded in a fresh interpreter
    (its ``main`` not run), loads no JAX module and nothing of the JAX
    package."""
    import os
    import subprocess
    import sys

    scripts = sorted((ROOT / "examples_torch").glob("*.py"))
    assert len(scripts) == 5
    code = ("import importlib.util, sys\n"
            "for i, path in enumerate(sys.argv[1:]):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, *map(str, scripts)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr


def _fresh_import_loads_no_jax(*modules):
    import os
    import subprocess
    import sys

    for module in modules:
        path = ROOT / "src" / (module.replace(".", "/") + ".py")
        assert path in _port_files()
        assert not set(_imported_roots(path)) & set(FORBIDDEN)
    module = ", ".join(modules)
    code = (f"import sys, {module}; "
            f"bad = sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    adj_rows = np.zeros(1, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        DynasparseEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_graph("CO", scale=0.02)
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.init_params("GCN", 4, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.params_from_jax({"W1": np.ones((2, 2), np.float32)}, "cuda")
    eng = DynasparseEngine(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.run_inference("GCN", eng, None, adj_rows, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        SharedPlanCache()
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.calibrate(runtime_fallback("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.run_serving("GCN", eng, None, [], {})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_data_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_for_devices(1)
    bundle = build_model(reduce_config(ARCHS["qwen2.5-3b"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2.5-3b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.init_state(bundle)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen2.5-3b"])
