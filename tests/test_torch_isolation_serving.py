"""The port's serving platform (``serving``), its cluster tier
(``cluster``) and its examples (``examples/torch_*.py``) import neither
JAX nor the JAX package (``jax``, ``jaxlib``, ``flax``, ``repro``)."""
import pytest

from torch_testlib import (ROOT, assert_imports_no_jax_and_no_reference,
                           imported_modules, path_id, port_files)

EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", port_files("serving", "cluster"),
                         ids=path_id)
def test_port_imports_no_jax_and_no_reference(path):
    assert_imports_no_jax_and_no_reference(path)


@pytest.mark.parametrize("path", EXAMPLES, ids=path_id)
def test_port_examples_import_no_jax_and_no_reference(path):
    assert_imports_no_jax_and_no_reference(path)
    assert any(m.startswith("repro_torch") for m in imported_modules(path))


def test_every_example_has_its_port():
    assert [p.name for p in EXAMPLES] == [
        "torch_quickstart.py", "torch_router_serving.py",
        "torch_serve_trace.py", "torch_train_smollm.py"]
    for p in EXAMPLES:
        assert (ROOT / "examples" / p.name[len("torch_"):]).exists()
