"""The port's kernel and model modules (``kernels``, ``models``, the MoE
FFN of ``models/moe.py`` among them) import neither JAX nor the JAX
package (``jax``, ``jaxlib``, ``flax``, ``repro``)."""
import pytest

from torch_testlib import (PORT, assert_imports_no_jax_and_no_reference,
                           imported_modules, path_id, port_files)


@pytest.mark.parametrize("path", port_files("kernels", "models"), ids=path_id)
def test_port_imports_no_jax_and_no_reference(path):
    assert_imports_no_jax_and_no_reference(path)


def test_every_model_module_is_checked():
    """Each LM family's module is among the files checked above; the MoE
    FFN builds on torch and the port's own ``quant`` and ``layers``."""
    checked = set(port_files("kernels", "models"))
    for name in ("transformer", "layers", "moe", "ssm", "griffin",
                 "vision", "api"):
        assert PORT / "models" / f"{name}.py" in checked
    mods = set(imported_modules(PORT / "models" / "moe.py"))
    assert {"torch", "repro_torch"} <= {m.split(".")[0] for m in mods}
