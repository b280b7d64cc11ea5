"""What the benchmark's modules import: never JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), never the program's own bench or smoke scripts, and in the
references nothing of the program at all."""

import ast
import sys

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "satellite_computervision_tpu"}
PROGRAM = "satellite_computervision_tpu_torch"
MODULES = sorted(p for p in (REPO / "perfbench").rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(REPO)))
def test_module_imports(path):
    names = imported(path)
    tops = {n.split(".")[0] for n in names}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert not tops & {"bench", "chip_smoke", "convergence_runs"}
    assert not {f"{PROGRAM}.bench", f"{PROGRAM}.chip_smoke"} & names
    if "reference" in path.relative_to(REPO / "perfbench").parts:
        assert PROGRAM not in tops


def test_run_checks_loaded_modules_by_whole_top_level_name(monkeypatch):
    from perfbench import manifest

    run = manifest.load_module(REPO / "perfbench" / "run.py", "perfbench_run")
    monkeypatch.setitem(sys.modules, PROGRAM + ".models", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert run.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in run.forbidden_modules()
