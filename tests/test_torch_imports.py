"""The port's ops/ modules import one another in one direction, read with
ast (nothing is imported): each module imports only the modules before it
in ORDER, at module level; no module imports a sibling from inside a
function."""

import ast
import pathlib

import pytest

OPS = pathlib.Path(__file__).resolve().parent.parent / "rayz_tpu_torch" / "ops"

#: The ops modules from the bottom up: the RNG and the kernel build, the
#: tables (and every layout decision), the per-ray plain twin of
#: csrc/common.cuh, the dense integrator's parts, the three kernel engines
#: (the queue megakernel, the wavefront, the persistent-path recorder), the
#: bounce-indexed recorder, the engine dispatch, and the near-tie explainer
#: on top.
ORDER = ("rng", "_build", "tables", "common", "intersect", "shade",
         "integrator", "megakernel", "wavefront", "pathrec", "diffkernel",
         "engine", "sweep")


def _sibling_imports(tree: ast.Module):
    """(module named, whether the import sits inside a function) of every
    relative import of an ops sibling in ``tree``."""
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    inner = {id(n) for f in funcs for n in ast.walk(f)}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.level != 1:
            continue
        names = ([node.module.split(".")[0]] if node.module
                 else [a.name for a in node.names])
        for name in names:
            yield name, id(node) in inner


def test_order_names_every_module():
    assert sorted(ORDER) == sorted(p.stem for p in OPS.glob("*.py")
                                   if p.stem != "__init__")


@pytest.mark.parametrize("module", ORDER)
def test_imports_point_down(module):
    tree = ast.parse((OPS / f"{module}.py").read_text())
    below = ORDER[:ORDER.index(module)]
    for name, in_function in _sibling_imports(tree):
        assert not in_function, f"{module} imports {name} in a function"
        assert name in below, f"{module} imports {name}, not below it"


def test_a_planted_upward_import_fails():
    tree = ast.parse("from .megakernel import _queue\n"
                     "def f():\n    from . import rng\n")
    assert list(_sibling_imports(tree)) == [("megakernel", False),
                                            ("rng", True)]
