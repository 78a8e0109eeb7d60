"""The port's serving platform (``serving``) imports neither JAX nor the
JAX package (``jax``, ``jaxlib``, ``flax``, ``repro``)."""
import pytest

from torch_testlib import (assert_imports_no_jax_and_no_reference, path_id,
                           port_files)


@pytest.mark.parametrize("path", port_files("serving"), ids=path_id)
def test_port_imports_no_jax_and_no_reference(path):
    assert_imports_no_jax_and_no_reference(path)
