"""Nothing under ``portbench/`` imports JAX, the JAX package ``repro`` or
the old ``benchmarks/`` folder, compared by whole top-level names (the
port ``repro_torch`` begins with ``repro``), and the plain references
import nothing of the port."""
import ast
import os
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_no_reference_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(top_level_imports(path))


def test_whole_word_compare():
    """``repro_torch`` is allowed, ``repro`` is not."""
    assert "repro_torch".split(".", 1)[0] not in FORBIDDEN
    assert "repro.models".split(".", 1)[0] in FORBIDDEN


def test_the_check_at_exit_reads_whole_names():
    from portbench import bench
    import sys
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = os
        assert "repro_torch_fake" not in bench.forbidden_modules()
        sys.modules["jaxlib.fake"] = os
        assert bench.forbidden_modules() == ["jaxlib"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
