"""The kernels layer holds kernels (CPU, no build).

- Every C entry point that `kernels._build.SIGNATURES` types is defined
  `extern "C"` in a source of `csrc/`, so `KernelLibrary` finds each one
  when it loads the library (a stale key fails there, and only on the
  card); a defined entry that `SIGNATURES` does not type is called from
  another source (K7's middle stage, which K1e's launcher runs).
- No module of `pffdtd_tpu_torch/kernels/` imports the engine's runner,
  the x-slab engine, the scene or its set-up, the materials, the bench,
  the examples, the probes or the CLI: those sit above the kernels.  The
  kernels still import `engine.data` (the specs they take: `GridSpec`,
  `SlabSpec`, `TileLists`) and `engine.energy` (the energy scene and the
  plain energy functions), which import the kernels in turn: a cycle,
  broken by deferred imports, until those move below both layers.
"""

import ast
import re

from pffdtd_tpu_torch.kernels import _build

PKG = _build.PKG
ABOVE = ("engine.torch_engine", "parallel", "scene", "scene_setup",
         "materials", "bench", "examples", "probes", "cli")


def _entries():
    """{source name: the extern "C" functions it defines}."""
    defined = re.compile(r'extern "C"\s+\w+\s+(\w+)\s*\([^)]*\)\s*\{')
    return {p.name: set(defined.findall(p.read_text()))
            for p in sorted(_build.CSRC.glob("*.cu"))}


def test_every_typed_entry_is_defined_and_every_other_is_called():
    entries = _entries()
    every = set().union(*entries.values())
    assert set(_build.SIGNATURES) <= every, set(_build.SIGNATURES) - every
    for src, names in entries.items():
        for name in names - set(_build.SIGNATURES):
            callers = [p.name for p in _build.CSRC.glob("*.cu")
                       if p.name != src
                       and re.search(rf"\b{name}\s*\(", p.read_text())]
            assert callers, f"{name} ({src}): neither typed nor called"


def _imports(path):
    """The modules `path` imports, anywhere in it, by their full names
    (each name of a `from X import a` also as X.a; the package imports
    absolutely)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert not node.level, f"{path.name}: a relative import"
            out += [node.module] + [f"{node.module}.{a.name}"
                                    for a in node.names]
    return out


def test_kernels_import_nothing_above_them():
    mods = sorted((PKG / "kernels").glob("*.py"))
    assert {"stencil.py", "boundary.py", "tb.py", "energy.py"} <= {
        p.name for p in mods}
    above = tuple(f"pffdtd_tpu_torch.{m}" for m in ABOVE)
    for path in mods:
        bad = [m for m in _imports(path)
               if any(m == a or m.startswith(a + ".") for a in above)]
        assert not bad, f"{path.name} imports {bad}"
