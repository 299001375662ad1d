"""The program's own kernel names: every ``__global__`` function of its
``csrc/`` sources, read from the files (the package is not imported)."""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)")


@functools.lru_cache(maxsize=1)
def own() -> frozenset:
    spec = importlib.util.find_spec("rayz_tpu_torch")
    csrc = Path(spec.origin).parent / "csrc"
    names = set()
    for path in csrc.glob("*.cu"):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def is_own(op_name: str) -> bool:
    """Whether a device operation's name is one of the program's kernels."""
    return any(re.search(rf"\b{k}\b", op_name) for k in own())
