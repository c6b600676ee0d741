"""The port stands alone: no file of ``src/repro_torch``, ``chip_smoke.py``
or ``scripts/`` imports JAX or the JAX package, and the entry points run
on the card unless the caller names the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import DynasparseEngine, calibrate
from repro_torch.core.perfmodel import runtime_fallback
from repro_torch.data.graphs import load_graph
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models import gnn
from repro_torch.serving import SharedPlanCache

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return (files + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py")))


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
    import os
    import subprocess
    import sys

    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path in _port_files()
    assert not set(_imported_roots(path)) & set(FORBIDDEN)
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
