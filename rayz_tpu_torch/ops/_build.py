"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles the kernel sources of ``csrc/`` (``megakernel.cu``,
``record_pp.cu``, ``gather.cu``, ``replay_pp.cu``, ``wavefront.cu``,
``record.cu``) into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), under ``build/kernels/<hash>/`` at the repository root: one
``nvcc -c`` per source, all started together, then one link. The hash
covers the sources, the headers and the flags, so an edit rebuilds and an
unchanged tree reuses the library. A missing ``nvcc`` or a failed build
raises: there is no fallback.

Flags: ``sm_90a`` (Hopper); no fast-math, so square roots and divisions are
IEEE and the poisoned padding columns keep rejecting themselves through
NaN compares; ``-fmad=false``, so the kernels round as the plain torch
versions do (no contracted multiply-adds); ``-Xptxas -v``, whose register
and spill report is kept beside the library (``ptxas.log``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

__all__ = ["load", "check", "build_dir", "BuildInfo"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("megakernel.cu", "record_pp.cu", "gather.cu", "replay_pp.cu",
            "wavefront.cu", "record.cu")
_HEADERS = ("common.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
_LIB = "librayz_kernels.so"


class BuildInfo(NamedTuple):
    """What :func:`load` did: the library path, whether it compiled (False
    = reused), the seconds it took and the ptxas report."""

    path: Path
    compiled: bool
    seconds: float
    log: str


def build_dir() -> Path:
    """``build/kernels`` beside the package (the repository root)."""
    return _CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are built from source at first use and need the CUDA "
        "toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.rayz_rng_bits.argtypes = [u, p, p, p, p, i, p, p]
    lib.rayz_rng_bits.restype = i
    lib.rayz_megakernel_queue.argtypes = [p, p, i, p, i, i, i, i, i, f, i,
                                          i, u, i, i, p, p, p, i, p, p, p, p,
                                          p, p, i, i, i, p, i, p, p]
    lib.rayz_megakernel_queue.restype = i
    lib.rayz_fold.argtypes = [p, i, ctypes.c_longlong, p, p]
    lib.rayz_fold.restype = i
    lib.rayz_record_pp.argtypes = [p, p, i, p, i, p, i, p, p, p, p, p, p, p,
                                   p, p, i, i, i, i, f, i, i, u, p, p]
    lib.rayz_record_pp.restype = i
    lib.rayz_gather_fwd.argtypes = [p, i, i, p, i, i, p, p]
    lib.rayz_gather_fwd.restype = i
    ll = ctypes.c_longlong
    lib.rayz_gather_bwd.argtypes = [p, ll, ll, p, i, i, i, i, ll, p, p, p,
                                    p]
    lib.rayz_gather_bwd.restype = i
    lib.rayz_gather_bwd_work.argtypes = [i, i]
    lib.rayz_gather_bwd_work.restype = ll
    lib.rayz_replay_fwd.argtypes = [p, p, p, p, i, i, p, p, p, i, i, i, i, f,
                                    p]
    lib.rayz_replay_fwd.restype = i
    lib.rayz_replay_bwd.argtypes = [p, p, p, p, p, p, i, i, p, p, i, i, i, i,
                                    f, p]
    lib.rayz_replay_bwd.restype = i
    lib.rayz_wavefront.argtypes = [p, p, i, p, i, i, p, p, i, p, p, p, p, i,
                                   i, i, i, p, p, p, p, p, p, p, i, i, i, i,
                                   i, i, f, i, i, u, i, p, p, p]
    lib.rayz_wavefront.restype = i
    lib.rayz_record.argtypes = [p, i, p, i, p, p, p, p, p, p, i, i, i, p, p,
                                i, i, f, i, p, p, p, p]
    lib.rayz_record.restype = i
    lib.rayz_error_string.argtypes = [i]
    lib.rayz_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=1)
def load():
    """Compile (if needed) and load the kernel library; returns
    ``(ctypes.CDLL, BuildInfo)``. Cached for the life of the process."""
    out_dir = build_dir() / _digest()
    lib_path = out_dir / _LIB
    log_path = out_dir / "ptxas.log"
    t0 = time.perf_counter()
    compiled = False
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in _SOURCES]
        jobs = [[nvcc, *FLAGS, "-I", str(_CSRC), "-c", "-o", str(o),
                 str(_CSRC / s)] for s, o in zip(_SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in jobs]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = out_dir / f"{_LIB}.{tag}.tmp"
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        for cmd, proc, log in zip(jobs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}):\n"
                f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
        log_path.write_text("".join(logs))
        os.replace(tmp, lib_path)
        for o in objs:
            o.unlink()
        compiled = True
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    log = log_path.read_text() if log_path.exists() else ""
    return lib, BuildInfo(lib_path, compiled, time.perf_counter() - t0, log)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.rayz_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
