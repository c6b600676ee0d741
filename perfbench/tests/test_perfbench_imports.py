"""Nothing of the benchmark imports JAX or the JAX package (top-level
module names compared whole: the port's ``repro_torch`` begins with
``repro``), the reference and the yardstick import nothing of the program,
and a rehearsed run leaves neither loaded."""
import ast
import subprocess
import sys

import pytest

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: what a later change to the program cannot move
STANDALONE = ["reference", "counts", "graphs", "check", "tracing", "window",
              "harness"]


def _roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py_files():
    return sorted(harness.PERF.rglob("*.py"))


def test_no_file_imports_jax_or_the_jax_package():
    files = _py_files()
    assert len(files) > 20
    bad = {str(f.relative_to(harness.ROOT)): sorted(set(_roots(f))
                                                    & FORBIDDEN)
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.parametrize("module", STANDALONE)
def test_yardstick_imports_nothing_of_the_program(module):
    roots = set(_roots(harness.PERF / f"{module}.py"))
    assert "repro_torch" not in roots and not roots & FORBIDDEN


def _modules_after(code: str) -> set:
    tops = "sorted({m.split('.')[0] for m in sys.modules})"
    p = subprocess.run([sys.executable, "-c",
                        f"{code}\nimport sys; print({tops})"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{harness.ROOT}:{harness.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-2000:]
    return set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import perfbench.reference, perfbench.check, "
                          "perfbench.counts, perfbench.graphs")
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_rehearsed_run_loads_no_jax_and_not_the_jax_package():
    mods = _modules_after(
        "from perfbench import harness\n"
        "r = harness.run('gcn-fl.replay', 3, 0.2, False, device='cpu', "
        "scale=0.01)\n"
        "assert r['correct'], r\n"
        "assert harness.forbidden_loaded() == []")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN
