"""Nothing the benchmark runs imports JAX or the JAX package (``repro``),
compared by whole top-level module names (``repro_torch`` is the
program), nor reads the JAX package's ``benchmarks/``; the references
import nothing of the program."""
from __future__ import annotations

import ast
import importlib.util
from pathlib import Path

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _run_module():
    path = spec.PKG / "run.py"
    loader = importlib.util.spec_from_file_location("perfbench_run", path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def test_forbidden_modules_compares_whole_top_level_names():
    run = _run_module()
    names = ["repro_torch", "repro_torch.models.lm", "reprox", "jaxtyping",
             "repro", "repro.models", "jax", "jax.numpy", "jaxlib.xla",
             "flax.linen", "numpy"]
    assert run.forbidden_modules(names) == sorted(
        ["repro", "repro.models", "jax", "jax.numpy", "jaxlib.xla",
         "flax.linen"])


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def _sources():
    return [p for p in spec.PKG.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        tops = {m.split(".", 1)[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)


def test_references_import_nothing_of_the_program():
    for p in (spec.PKG / "reference").glob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(p)}
        assert tops <= {"__future__", "torch", "perfbench"}, (p, tops)


def test_nothing_reads_the_jax_packages_benchmarks():
    for p in _sources():
        if "tests" in p.relative_to(spec.PKG).parts:
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and '"benchmarks"' not in text, p
