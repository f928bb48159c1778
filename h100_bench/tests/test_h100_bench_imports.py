"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: the program's name begins with the JAX package's)."""

import ast

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "matryoshka_mm_tpu"}
BENCH = ROOT / "h100_bench"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _top_level_imports(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "matryoshka_mm_torch" not in _top_level_imports(f), f
        assert "matryoshka_mm_torch" not in f.read_text(), f


def test_the_run_refuses_when_jax_was_loaded(monkeypatch):
    import sys
    import types

    from h100_bench import run

    assert run.forbidden_modules() == [] or "jax" not in sys.modules
    monkeypatch.setitem(sys.modules, "matryoshka_mm_tpu.models",
                        types.ModuleType("matryoshka_mm_tpu.models"))
    assert run.forbidden_modules() == ["matryoshka_mm_tpu"]
    # the port's own name begins with the JAX package's and is not refused
    monkeypatch.delitem(sys.modules, "matryoshka_mm_tpu.models")
    monkeypatch.setitem(sys.modules, "matryoshka_mm_torch_x",
                        types.ModuleType("matryoshka_mm_torch_x"))
    assert "matryoshka_mm_torch_x" not in run.forbidden_modules()
