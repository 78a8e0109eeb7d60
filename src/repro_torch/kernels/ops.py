"""Kernel registry of the port, modelled on ``repro.kernels.ops``.

Dispatch goes by the tensor's device and nothing else: a CPU tensor takes
the kernel's plain PyTorch version, a CUDA tensor takes the hand-written
kernel (or the wrapper raises).  There is no mode that sends CUDA tensors
to the plain versions; a comparison calls the spec's ``plain`` directly.

The registry keeps each kernel's launch count (:meth:`dispatch_snapshot`,
:meth:`reset_counts`) and reports where the kernel library was built
(:meth:`describe`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from repro_torch.kernels import cuda_lib
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import weight_transform as _wt


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: its CUDA source, the TPU kernel it replaces
    (``file:line``), its launch counter and its plain PyTorch version."""
    name: str
    source: str
    replaces: str
    counter: cuda_lib.LaunchCounter
    plain: Callable

    @property
    def launches(self) -> int:
        return self.counter.value


def _spec(name: str, module, *, replaces: str = "", counter=None,
          plain=None) -> KernelSpec:
    return KernelSpec(name, module.SOURCE, replaces or module.REPLACES,
                      counter or module.launches, plain or module.plain)


class KernelRegistry:
    def __init__(self):
        self._kernels: Dict[str, KernelSpec] = {}

    def register(self, spec: KernelSpec):
        self._kernels[spec.name] = spec

    def names(self):
        return sorted(self._kernels)

    def spec(self, name: str) -> KernelSpec:
        return self._kernels[name]

    def dispatch_snapshot(self) -> Dict[str, int]:
        """Kernel launches so far in this process, by kernel."""
        return {n: s.launches for n, s in sorted(self._kernels.items())}

    def reset_counts(self):
        for s in self._kernels.values():
            s.counter.reset()

    def build(self) -> cuda_lib.KernelLibrary:
        """Build (or load) the kernel library now."""
        return cuda_lib.library()

    def describe(self) -> Dict[str, Any]:
        return {"library": cuda_lib.status(),
                "kernels": {n: {"source": s.source,
                                "replaces": s.replaces,
                                "launches": s.launches}
                            for n, s in sorted(self._kernels.items())}}


registry = KernelRegistry()
registry.register(_spec("flash_attention", _flash))
registry.register(_spec("decode_attention", _decode))
registry.register(_spec("decode_attention_paged", _decode,
                        replaces=_decode.REPLACES_PAGED,
                        counter=_decode.paged_launches,
                        plain=_decode.plain_paged))
registry.register(_spec("weight_transform", _wt))
registry.register(_spec("quant_matmul", _qm))

flash_attention = _flash.flash_attention
decode_attention = _decode.decode_attention
decode_attention_paged = _decode.decode_attention_paged
weight_transform = _wt.weight_transform
quant_matmul = _qm.quant_matmul
