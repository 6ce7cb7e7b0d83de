"""What the benchmark may import: nothing under ``cardbench/`` imports
``jax``, ``jaxlib``, ``flax``, the JAX package ``repro``, ``chip_smoke``,
``tools`` or ``benchmarks`` (top-level names compared whole:
``repro_torch`` begins with ``repro``), and the reference and the frozen
yardstick import nothing of ``repro_torch``."""
import ast

import pytest

import cells

PKG = cells.ROOT / "cardbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "tools",
             "benchmarks"}
FILES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def top_names(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def cardbench_modules(path) -> set:
    """The ``cardbench`` modules ``path`` imports (dotted)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("cardbench"):
            out |= {f"{node.module}.{a.name}" for a in node.names}
            out.add(node.module)
        elif isinstance(node, ast.Import):
            out |= {a.name for a in node.names
                    if a.name.startswith("cardbench")}
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_import(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "frozen"])
def test_reference_and_yardstick_stand_alone(sub):
    """Neither imports the port, directly or through another module of
    the benchmark."""
    for path in sorted((PKG / sub).glob("*.py")):
        assert "repro_torch" not in top_names(path), path
        for mod in cardbench_modules(path):
            parts = mod.split(".")
            assert parts[1] in ("reference", "frozen") or mod == "cardbench", \
                (path, mod)


def test_the_matcher_compares_whole_names():
    assert "repro" not in {"repro_torch".split(".")[0]}
    assert top_names(PKG / "entries" / "fl_loop.py") >= {"cardbench"}


def test_a_run_refuses_what_the_window_must_not_hold(monkeypatch):
    import sys
    import types

    from cardbench import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "repro"]
