"""The import guard: nothing that runs on the card loads JAX or the JAX
package, and the reference loads nothing of the program.

Names are compared by their top-level part, whole: ``rayz_tpu_torch`` is
not ``rayz_tpu``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "rayz_tpu")
PROGRAM = "rayz_tpu_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    """The modules of ``sys.modules`` (or of ``modules``) whose top-level
    name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top(m) in FORBIDDEN)


def reference_imports(directory: Path = REFERENCE_DIR) -> List[str]:
    """Top-level names of every module the reference's sources import
    (relative imports, its own, left out)."""
    found = set()
    for path in sorted(directory.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                found.update(top(a.name) for a in node.names)
            elif isinstance(node, ast.ImportFrom) and not node.level:
                found.add(top(node.module))
    return sorted(found)


def check_start() -> None:
    """Raise if JAX or the JAX package is loaded, or if the reference
    imports JAX, the JAX package or the program."""
    bad = loaded_forbidden()
    ref = [m for m in reference_imports() if m in FORBIDDEN + (PROGRAM,)]
    if bad or ref:
        raise SystemExit(f"import guard: loaded {bad}; the reference "
                         f"imports {ref}")


def check_loaded() -> None:
    """Raise, naming them, if JAX or the JAX package is loaded."""
    bad = loaded_forbidden()
    if bad:
        raise SystemExit(f"import guard: the process holds {bad}")
