"""The port does all the JAX package does: a completeness check.

Reads both packages' sources with ``ast`` and ``re`` only (``rayz_tpu`` is
not imported, so no JAX compile runs) and holds:

(a) every ``pallas_call`` site of ``rayz_tpu/`` is a site of a row of
    :data:`KERNELS`; each row's JAX kernel is defined on its line, its
    CUDA kernels are defined ``__global__`` in its ``csrc`` file, and
    ``chip_smoke.py``'s ``kernels`` line has an entry from that file that
    replaces it;
(b) every name of a JAX module's ``__all__`` is in the port module's;
(c) every public ``def`` and class of ``rayz_tpu/<path>`` has its
    counterpart in ``rayz_tpu_torch/<path>``, and so does every parameter
    of it (a class's fields and public methods likewise);
(d) every argument of ``rayz_tpu/cli.py``, and every choice it offers, is
    in ``rayz_tpu_torch/cli.py``.

Each deliberate difference stands in :data:`DIFFERENCES` with its reason.
An unknown difference fails, and so does a stale entry: one that no
difference consults, because the port now has the name or JAX does not.
"""

import ast
import functools
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "rayz_tpu", "rayz_tpu_torch"

# The TPU kernels and their ports, as in PERF.md's table of kernels: the
# row, the JAX file, the kernel's defs (line, name), the pallas_call sites
# that launch it, the port's CUDA source and its kernels there
# ("kernel<Sweep>": the template's segment sweep, a struct of that file).
KERNELS = (
    ("1", "ops/megakernel.py", ((459, "_kernel"),), (1221, 1325),
     "megakernel.cu", ("megakernel_queue<ResidentSweep>", "fold_kernel")),
    ("2", "ops/megakernel.py", ((767, "_culled_loop"),), (),
     "megakernel.cu", ("megakernel_queue<CulledSweep>",)),
    ("3", "ops/megakernel.py", ((883, "_stream_loop"),), (1418,),
     "megakernel.cu", ("megakernel_queue<StreamSweep>",)),
    ("4", "ops/wavefront.py", ((127, "_wf_kernel"),), (827,),
     "wavefront.cu", ("wavefront_kernel",)),
    ("5", "ops/pathrec.py", ((186, "_record_pp_kernel"),), (639,),
     "record_pp.cu", ("record_pp_kernel",)),
    ("6", "ops/pathrec.py", ((1095, "_gather_fwd_kernel"),), (1174, 1251),
     "gather.cu", ("gather_fwd_kernel",)),
    ("7", "ops/pathrec.py", ((1120, "_gather_bwd_kernel"),), (1203, 1282),
     "gather.cu", ("gather_bwd_kernel", "gather_bwd_count_kernel",
                   "gather_bwd_scan_kernel", "gather_bwd_rank_kernel",
                   "gather_bwd_piece_kernel", "gather_bwd_tiles_kernel",
                   "gather_bwd_pieces_sum_kernel")),
    ("8", "ops/pathrec.py", ((1512, "_fused_fwd_kernel"),), (1649,),
     "replay_pp.cu", ("replay_fwd_kernel",)),
    ("9", "ops/pathrec.py", ((1565, "_fused_bwd_kernel"),), (1705,),
     "replay_pp.cu", ("replay_bwd_kernel",)),
    ("10", "ops/diffkernel.py",
     ((130, "_record_kernel"), (285, "_streamed_class")), (584,),
     "record.cu", ("record_queue", "record_kernel")),
)

_TPU = "TPU plumbing (ROADMAP: Do not port)"
_TILING = "TPU tiling; the kernels take any ray count (ROADMAP: Do not port)"
_TABLES = ("the table builders are their own module, ops/tables.py, shared "
           "by every kernel")
_GM = ("the gm table form only saves TPU SMEM bytes "
       "(ROADMAP: Do not port)")
_DRAWS = ("the draws are given, keyed by (seed, pixel, sample, bounce, "
          "draw) (utils/sampling.py)")

# Every deliberate difference: key -> (what the port has instead, or None,
# and why). Keys, with paths relative to the packages:
#   "name N"            N is renamed wherever it appears (defs, __all__,
#                       CLI choices);
#   "def P:N"           the def or class N of P (or member "C.m") is at
#                       "P2:N2" in the port, or has no counterpart;
#   "param P:F(p)"      parameter p of F; "param P:*(p)" for every def of
#                       P, "param *(p)" for every def.
DIFFERENCES = {
    "name render_pallas": (
        "render_megakernel", "the engine is a hand-written CUDA kernel, "
        "not a Pallas call"),
    "name render_pallas_sharded": (
        "render_megakernel_sharded", "the engine is a hand-written CUDA "
        "kernel, not a Pallas call"),
    "name pallas": (
        "megakernel", "--engine names the CUDA megakernel"),
    "def ops/megakernel.py:fits_smem": (
        "ops/tables.py:fits_shared", "the H100 rule: one block's shared "
        "memory, not the TPU's SMEM"),
    "def ops/megakernel.py:fits_stream": ("ops/tables.py:fits_stream",
                                          _TABLES),
    "def ops/megakernel.py:scene_tables": ("ops/tables.py:scene_tables",
                                           _TABLES),
    "def ops/megakernel.py:tri_tables": ("ops/tables.py:tri_tables",
                                         _TABLES),
    "def ops/megakernel.py:supports_scene": (
        "ops/tables.py:supports_scene", _TABLES),
    "def ops/megakernel.py:use_patch_order": (
        "ops/tables.py:use_patch_order", _TABLES),
    "def ops/megakernel.py:scene_tables_gm": (None, _GM),
    "def ops/megakernel.py:tri_tables_gm": (None, _GM),
    "def ops/megakernel.py:use_global_materials": (None, _GM),
    "def ops/megakernel.py:is_prng_key": (
        None, "the port takes int seeds, never PRNG keys"),
    "def ops/diffkernel.py:fits_smem_record": (
        None, "sized for the TPU's SMEM; the H100 record rules "
        "(ops/tables.py: fits_shared, fits_record_stream) replace it"),
    "def ops/diffkernel.py:default_interpret": (None, _TPU),
    "param *(key)": (
        "seed", "every draw is keyed by an int seed (ops/rng.py), not a "
        "jax.random key"),
    "param *(interpret)": (None, _TPU),
    "param *(tile_sublanes)": (None, _TILING),
    "param *(unroll)": (None, _TILING),
    "param ops/megakernel.py:render_pallas(tree)": (
        None, "the tree and chain merges give bit-identical results; one "
        "is kept (ROADMAP: Do not port)"),
    "param ops/megakernel.py:fits_stream(stream_chunk)": (
        "stream", "named as render_megakernel's chunk keyword"),
    "param ops/pathrec.py:render_diff_pp_flat(compact_capacity)": (
        None, "the compaction needs no capacity on the card (ROADMAP: Do "
        "not port)"),
    "param ops/pathrec.py:record_pp(px)": (
        "pix", "flat pixel ids, -1 for no pixel, in place of coordinates"),
    "param ops/pathrec.py:record_pp(py)": (
        "pix", "flat pixel ids, -1 for no pixel, in place of coordinates"),
    "param ops/pathrec.py:record_pp(n_local)": (
        "pix", "the slot count is pix's length"),
    "param ops/pathrec.py:replay_pp(remat)": (
        None, "each step always runs under torch.utils.checkpoint"),
    "param ops/integrator.py:trace_rays(key)": (
        "rand", "the bounces' scatter draws are given"),
    "param ops/shade.py:scatter(key)": ("draws", _DRAWS),
    "param ops/shade.py:scatter(time)": (
        None, "only the caller uses the time: it keeps it"),
    "param ops/engine.py:render_fast(**pallas_kw)": (
        "**engine_kw", "passed to whichever engine is chosen"),
    "param parallel/mesh.py:make_mesh(devices)": (
        "device_type", "one device for each rank of the process group"),
    "param diff/checkpoint.py:restore_checkpoint(template)": (
        "map_location", "torch.load restores the structure as saved"),
    "param utils/profiling.py:trace(create_perfetto_trace)": (
        None, "torch.profiler writes a Chrome trace"),
    "param utils/sampling.py:*(key)": (None, _DRAWS),
    "param utils/sampling.py:*(shape)": (None, "the draws' shape"),
    "param utils/sampling.py:*(dtype)": (None, "the draws' dtype"),
}


class Table:
    """Lookups in a table of differences. An entry is marked when a real
    difference consults it; one never consulted is stale."""

    def __init__(self, entries=None):
        self.entries = DIFFERENCES if entries is None else entries
        self.used = set()

    def lookup(self, *keys):
        """The entry (instead, why) of the first of ``keys`` in the table,
        or None."""
        for key in keys:
            if key in self.entries:
                self.used.add(key)
                return self.entries[key]
        return None

    def stale(self) -> list:
        return [f"{key!r}: stale entry of DIFFERENCES: no difference "
                "consults it (the port has it, or JAX does not)"
                for key in self.entries if key not in self.used]


def _read(*parts) -> str:
    with open(os.path.join(ROOT, *parts)) as f:
        return f.read()


def _files(pkg: str, ext: str) -> list:
    top = os.path.join(ROOT, pkg)
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, names in os.walk(top) for f in names
                  if f.endswith(ext))


@functools.lru_cache(maxsize=None)
def _trees(pkg: str) -> dict:
    """``{path in pkg: ast}`` of every module of a package."""
    return {rel: ast.parse(_read(pkg, rel)) for rel in _files(pkg, ".py")}


@functools.lru_cache(maxsize=None)
def _csrc() -> dict:
    return {rel: _read(PORT, "csrc", rel) for rel in _files(
        os.path.join(PORT, "csrc"), ".cu")}


@functools.lru_cache(maxsize=None)
def _smoke():
    return ast.parse(_read("chip_smoke.py"))


_EMPTY = ast.Module([], [])


# ---- (a) the kernels ----

def pallas_sites(jax: dict) -> set:
    """(path, line) of every reference to ``pallas_call``."""
    return {(rel, node.lineno) for rel, tree in jax.items()
            for node in ast.walk(tree)
            if (isinstance(node, ast.Attribute) and node.attr == "pallas_call")
            or (isinstance(node, ast.Name) and node.id == "pallas_call")}


def smoke_entries(tree) -> set:
    """(CUDA source, replaces) of every entry of ``chip_smoke.py``'s
    ``kernels`` line: each is a call of ``entry(name, source, replaces,
    ...)``, alone or in a generator over literal rows."""
    pattern = re.compile(rf"^{JAX}/\S+\.py:\d+$")
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "kernels"
                for k in node.keys):
            kernels = node.values[[k.value for k in node.keys].index(
                "kernels")]
            break
    else:
        return set()
    out = set()
    for elt in kernels.elts:
        calls = [n for n in ast.walk(elt) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", None) == "entry"]
        if not calls or not isinstance(calls[0].args[1], ast.Constant):
            continue
        source = calls[0].args[1].value
        out |= {(source, n.value) for n in ast.walk(elt)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and pattern.match(n.value)}
    return out


def site_problems(jax: dict, rows=KERNELS) -> list:
    want = {(rel, line) for _, rel, _, sites, _, _ in rows for line in sites}
    found = pallas_sites(jax)
    return ([f"{JAX}/{rel}:{line}: a pallas_call site that no row of "
             "KERNELS ports" for rel, line in sorted(found - want)]
            + [f"{JAX}/{rel}:{line}: the pallas_call site of KERNELS is "
               "gone" for rel, line in sorted(want - found)])


def row_problems(row, jax: dict, csrc: dict, smoke) -> list:
    label, rel, defs, _, source, kernels = row
    out = []
    for line, name in defs:
        if not any(isinstance(n, ast.FunctionDef) and n.name == name
                   and n.lineno == line
                   for n in ast.walk(jax.get(rel, _EMPTY))):
            out.append(f"row {label}: {JAX}/{rel}:{line} is not def {name}")
        if (source, f"{JAX}/{rel}:{line}") not in smoke_entries(smoke):
            out.append(f"row {label}: chip_smoke.py's kernels line has no "
                       f"entry from {source} that replaces "
                       f"{JAX}/{rel}:{line}")
    text = csrc.get(source, "")
    for kernel in kernels:
        name, _, sweep = kernel.rstrip(">").partition("<")
        if not re.search(r"__global__\s+void\s+(__launch_bounds__\([^)]*\)"
                         rf"\s*)?{name}\s*\(", text):
            out.append(f"row {label}: {PORT}/csrc/{source} defines no "
                       f"__global__ {name}")
        if sweep and not re.search(rf"\bstruct\s+{sweep}\b", text):
            out.append(f"row {label}: {PORT}/csrc/{source} defines no "
                       f"sweep {sweep}")
    return out


# ---- (b) and (c): names, defs and parameters ----

def _all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _members(node) -> dict:
    """Public defs and classes of a module, or public methods, ``__init__``
    and annotated fields of a class."""
    out = {}
    for n in node.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            if not n.name.startswith("_") or n.name == "__init__":
                out[n.name] = n
        elif (isinstance(node, ast.ClassDef) and isinstance(n, ast.AnnAssign)
              and isinstance(n.target, ast.Name)
              and not n.target.id.startswith("_")):
            out[n.target.id] = n
    return out


def _params(fn) -> list:
    a = fn.args
    return ([p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
            + (["*" + a.vararg.arg] if a.vararg else [])
            + (["**" + a.kwarg.arg] if a.kwarg else []))


def _target(entry, rel: str):
    """The port's ``(path, name)`` that an entry names: "P:N", or N in
    ``rel``."""
    path, _, name = entry[0].rpartition(":")
    return path or rel, name


def export_problems(rel: str, jax: dict, port: dict, table: Table) -> list:
    names = _all(jax[rel])
    if names is None:
        return []
    if rel not in port or _all(port[rel]) is None:
        return [f"{PORT}/{rel} has no __all__"]
    out = []
    for name in names:
        if name in _all(port[rel]):
            continue
        entry = table.lookup(f"def {rel}:{name}", f"name {name}")
        if entry is None:
            out.append(f"{JAX}/{rel}: __all__ name {name} is not in "
                       f"{PORT}/{rel}'s, and DIFFERENCES has no entry for it")
        elif entry[0] is not None:
            prel, pname = _target(entry, rel)
            if pname not in (_all(port.get(prel, _EMPTY)) or ()):
                out.append(f"{JAX}/{rel}: __all__ name {name}: {pname} is "
                           f"not in {PORT}/{prel}'s __all__")
    return out


def _param_problems(rel, qual, jfn, prel, pqual, pfn, table) -> list:
    have, out = _params(pfn), []
    for p in _params(jfn):
        if p in have:
            continue
        entry = table.lookup(f"param {rel}:{qual}({p})",
                             f"param {rel}:*({p})", f"param *({p})")
        if entry is None:
            out.append(f"{JAX}/{rel}:{qual}({p}): {PORT}/{prel}:{pqual} has "
                       f"no parameter {p}, and DIFFERENCES has no entry "
                       "for it")
        elif entry[0] is not None and entry[0] not in have:
            out.append(f"{JAX}/{rel}:{qual}({p}): {PORT}/{prel}:{pqual} has "
                       f"no parameter {entry[0]}, DIFFERENCES' counterpart")
    return out


def def_problems(rel: str, jax: dict, port: dict, table: Table) -> list:
    if rel not in port:
        return [f"{JAX}/{rel}: no module {PORT}/{rel}"]
    out = []
    for name, node in _members(jax[rel]).items():
        if name in _members(port[rel]):
            prel, pname = rel, name
        else:
            entry = table.lookup(f"def {rel}:{name}", f"name {name}")
            if entry is None:
                out.append(f"{JAX}/{rel}:{name}: {PORT}/{rel} has no {name},"
                           " and DIFFERENCES has no entry for it")
            if entry is None or entry[0] is None:
                continue
            prel, pname = _target(entry, rel)
        pnode = _members(port.get(prel, _EMPTY)).get(pname)
        if type(pnode) is not type(node):
            out.append(f"{JAX}/{rel}:{name}: its counterpart "
                       f"{PORT}/{prel}:{pname} is missing or not a "
                       f"{type(node).__name__}")
        elif isinstance(node, ast.ClassDef):
            pmembers = _members(pnode)
            for m, mnode in _members(node).items():
                if m not in pmembers:
                    if table.lookup(f"def {rel}:{name}.{m}") is None:
                        out.append(f"{JAX}/{rel}:{name}.{m}: "
                                   f"{PORT}/{prel}:{pname} has no {m}, and "
                                   "DIFFERENCES has no entry for it")
                elif isinstance(mnode, ast.FunctionDef):
                    out += _param_problems(rel, f"{name}.{m}", mnode, prel,
                                           f"{pname}.{m}", pmembers[m],
                                           table)
        else:
            out += _param_problems(rel, name, node, prel, pname, pnode,
                                   table)
    return out


# ---- (d) the CLI ----

def _constant(name: str, trees: dict):
    """The value of a module-level ``name = ...`` in any of ``trees``: a
    literal, or a dict's keys."""
    for tree in trees.values():
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == name for t in node.targets):
                if isinstance(node.value, ast.Dict):
                    return [k.value for k in node.value.keys]
                return ast.literal_eval(node.value)
    raise KeyError(name)


def _choices(node, trees: dict):
    """An ``add_argument``'s choices: a literal, a module constant, or
    ``sorted(module.CONSTANT)``."""
    if isinstance(node, ast.Name):
        return list(_constant(node.id, trees))
    if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "sorted":
        return sorted(_constant(node.args[0].attr, trees))
    return list(ast.literal_eval(node))


def cli_args(trees: dict) -> dict:
    """``{argument: choices or None}`` of every ``add_argument`` in the
    package's cli.py."""
    out = {}
    for node in ast.walk(trees["cli.py"]):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            choices = [kw.value for kw in node.keywords
                       if kw.arg == "choices"]
            out[node.args[0].value] = (_choices(choices[0], trees)
                                       if choices else None)
    return out


def cli_problems(jax: dict, port: dict, table: Table) -> list:
    theirs, ours, out = cli_args(jax), cli_args(port), []
    for arg, choices in theirs.items():
        if arg not in ours:
            out.append(f"{JAX}/cli.py {arg}: not an argument of "
                       f"{PORT}/cli.py")
            continue
        for c in choices or ():
            if c in (ours[arg] or ()):
                continue
            entry = table.lookup(f"name {c}")
            if entry is None or entry[0] not in (ours[arg] or ()):
                out.append(f"{JAX}/cli.py {arg}={c}: not a choice of "
                           f"{PORT}/cli.py's {arg}")
    return out


def all_problems(jax, port, csrc, smoke, table: Table) -> list:
    out = site_problems(jax)
    for row in KERNELS:
        out += row_problems(row, jax, csrc, smoke)
    for rel in jax:
        out += export_problems(rel, jax, port, table)
        out += def_problems(rel, jax, port, table)
    return out + cli_problems(jax, port, table)


# ---- the checks on the two packages ----

JAX_MODULES = _files(JAX, ".py")


def test_pallas_call_sites():
    """The 12 sites of KERNELS, and no other."""
    assert sum(len(row[3]) for row in KERNELS) == 12
    assert len(pallas_sites(_trees(JAX))) == 12
    assert site_problems(_trees(JAX)) == []


@pytest.mark.parametrize("row", KERNELS, ids=[row[0] for row in KERNELS])
def test_kernel_row(row):
    assert row_problems(row, _trees(JAX), _csrc(), _smoke()) == []


@pytest.mark.parametrize("rel", [rel for rel in JAX_MODULES
                                 if _all(_trees(JAX)[rel]) is not None])
def test_exports(rel):
    assert export_problems(rel, _trees(JAX), _trees(PORT), Table()) == []


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_defs(rel):
    assert def_problems(rel, _trees(JAX), _trees(PORT), Table()) == []


def test_cli():
    theirs = cli_args(_trees(JAX))
    assert "pallas" in theirs["--engine"] and "--progress" in theirs
    assert cli_problems(_trees(JAX), _trees(PORT), Table()) == []


def test_no_stale_entries():
    table = Table()
    assert all_problems(_trees(JAX), _trees(PORT), _csrc(), _smoke(),
                        table) == []
    assert table.stale() == []


def test_every_entry_has_a_reason():
    kinds = ("name ", "def ", "param ")
    for key, (instead, why) in DIFFERENCES.items():
        assert key.startswith(kinds), key
        assert instead is None or isinstance(instead, str), key
        assert isinstance(why, str) and why.strip(), key


def test_ops_exports_import():
    from rayz_tpu_torch.ops import (default_iters, default_k1,
                                    supports_diff, supports_wavefront)
    from rayz_tpu_torch.ops import diffkernel, pathrec, wavefront
    assert default_iters is pathrec.default_iters
    assert default_k1 is pathrec.default_k1
    assert supports_diff is diffkernel.supports_diff
    assert supports_wavefront is wavefront.supports_wavefront


# ---- each check fails on a planted difference, naming it ----

def _parse(sources: dict) -> dict:
    return {rel: ast.parse(text) for rel, text in sources.items()}


_CLI = ("import argparse\np = argparse.ArgumentParser()\n"
        "p.add_argument('--spp', type=int)\n"
        "p.add_argument('--engine', choices=('auto', {}))\n")


@pytest.mark.parametrize("case", [
    "extra_site", "missing_export", "dropped_keyword", "dropped_def",
    "dropped_field", "dropped_flag", "dropped_choice", "missing_symbol",
    "missing_smoke_entry"])
def test_planted_difference_fails(case):
    jax, port = _trees(JAX), _trees(PORT)
    if case == "extra_site":
        jax = {**jax, "ops/extra.py": ast.parse(
            "from jax.experimental import pallas as pl\n\n"
            "def f(k, x):\n    return pl.pallas_call(k)(x)\n")}
        problems, item = site_problems(jax), "rayz_tpu/ops/extra.py:4"
    elif case == "missing_export":
        jax = _parse({"m.py": "__all__ = ['a', 'b']"})
        port = _parse({"m.py": "__all__ = ['a']"})
        problems, item = export_problems("m.py", jax, port, Table({})), "b"
    elif case in ("dropped_keyword", "dropped_def"):
        jax = _parse({"m.py": "def f(x, *, y=1):\n    pass\n"
                              "def g():\n    pass\n"})
        port = _parse({"m.py": "def f(x, *, y=1):\n    pass\n"
                       if case == "dropped_def" else
                       "def f(x):\n    pass\ndef g():\n    pass\n"})
        problems = def_problems("m.py", jax, port, Table({}))
        item = "m.py:g" if case == "dropped_def" else "m.py:f(y)"
    elif case == "dropped_field":
        jax = _parse({"m.py": "class C:\n    a: int\n    b: int\n"})
        port = _parse({"m.py": "class C:\n    a: int\n"})
        problems = def_problems("m.py", jax, port, Table({}))
        item = "m.py:C.b"
    elif case in ("dropped_flag", "dropped_choice"):
        jax = _parse({"cli.py": _CLI.format("'fast'")})
        text = (_CLI.format("'fast'").replace("--spp", "--samples")
                if case == "dropped_flag" else _CLI.format("'slow'"))
        problems = cli_problems(jax, _parse({"cli.py": text}), Table({}))
        item = "--spp" if case == "dropped_flag" else "--engine=fast"
    else:
        row = KERNELS[3]
        csrc, smoke = _csrc(), _smoke()
        if case == "missing_symbol":
            csrc = {**csrc, row[4]: csrc[row[4]].replace(
                "wavefront_kernel(", "wavefront_kernel_v2(")}
            item = "wavefront_kernel"
        else:
            smoke = ast.parse(_read("chip_smoke.py").replace(
                "rayz_tpu/ops/wavefront.py:127", "rayz_tpu/ops/wavefront.py:1"))
            item = "rayz_tpu/ops/wavefront.py:127"
        problems = row_problems(row, jax, csrc, smoke)
    assert problems and all(item in p for p in problems), problems


@pytest.mark.parametrize("case", ["port_accepts", "jax_lacks"])
def test_stale_entry_fails(case):
    jax = _parse({"m.py": "__all__ = ['f']\ndef f(x, y):\n    pass\n"})
    port = _parse({"m.py": "__all__ = ['f']\ndef f(x, y):\n    pass\n"})
    key = ("param m.py:f(y)" if case == "port_accepts"
           else "def m.py:gone")
    table = Table({key: (None, "planted")})
    assert export_problems("m.py", jax, port, table) == []
    assert def_problems("m.py", jax, port, table) == []
    stale = table.stale()
    assert len(stale) == 1 and key in stale[0], stale
