"""Kernel registry of the port, modelled on ``repro.kernels.ops``.

Dispatch goes by the tensor's device and nothing else: a CPU tensor takes
the kernel's plain PyTorch version, a CUDA tensor takes the hand-written
kernel (or the wrapper raises).  There is no mode that sends CUDA tensors
to the plain versions; a comparison calls the spec's ``plain`` directly.
Where autograd records and an input wants a gradient, a kernel with a
backward goes through its autograd function, and a forward kernel without
one raises on CUDA tensors (its output would carry no gradient).

The registry keeps each kernel's launch count (:meth:`dispatch_snapshot`,
:meth:`reset_counts`) and reports where the kernel library was built
(:meth:`describe`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import weight_transform as _wt


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: its CUDA source, what it replaces in the
    reference (``file:line`` of a TPU kernel; for ``rmsnorm``, of the jnp
    function XLA compiles; for the backward kernels, of the jnp function
    whose gradient ``jax.grad`` derives), its launch counter and its
    plain PyTorch version."""
    name: str
    source: str
    replaces: str
    counter: cuda_lib.LaunchCounter
    plain: Callable

    @property
    def launches(self) -> int:
        return self.counter.value


def _spec(name: str, module, *, source: str = "", replaces: str = "",
          counter=None, plain=None) -> KernelSpec:
    return KernelSpec(name, source or module.SOURCE,
                      replaces or module.REPLACES,
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
registry.register(_spec("ssd_scan", _ssd))
registry.register(_spec("rglru_scan", _rglru))
registry.register(_spec("rmsnorm", _rms))
registry.register(_spec("flash_attention_bwd", _flash_bwd))
registry.register(_spec("rmsnorm_bwd", _rms, counter=_rms.bwd_launches,
                        plain=_rms.plain_bwd))
registry.register(_spec("ssd_scan_bwd", _ssd, source=_ssd.BWD_SOURCE,
                        replaces=_ssd.BWD_REPLACES,
                        counter=_ssd.bwd_launches, plain=_ssd.plain_bwd))
registry.register(_spec("rglru_scan_bwd", _rglru,
                        replaces=_rglru.BWD_REPLACES,
                        counter=_rglru.bwd_launches, plain=_rglru.plain_bwd))


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _wants_grad(*tensors) -> bool:
    """Autograd records and one of ``tensors`` wants a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _forward_only(name: str, fn: Callable) -> Callable:
    """The entry of a forward kernel with no backward: a call on a CUDA
    tensor that wants a gradient raises, where the kernel's output would
    carry none (a gradient lost without a word); every other call is the
    kernel's, unchanged."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        ts = [t for t in (*args, *kwargs.values())
              if isinstance(t, torch.Tensor)]
        if _wants_grad(*ts) and any(_on_card(t) for t in ts):
            raise RuntimeError(
                f"{name}: the kernel has no backward, and an input wants a "
                f"gradient; call it under torch.no_grad() or on detached "
                f"tensors")
        return fn(*args, **kwargs)
    return entry


# the model's entries: a gradient where autograd asks for one (backward
# kernels), else the forward kernels as serving has always called them
flash_attention = _flash.attention
decode_attention = _forward_only("decode_attention", _decode.decode_attention)
decode_attention_paged = _forward_only("decode_attention_paged",
                                       _decode.decode_attention_paged)
weight_transform = _forward_only("weight_transform", _wt.weight_transform)
quant_matmul = _forward_only("quant_matmul", _qm.quant_matmul)
rmsnorm = _rms.norm


# chunk lengths the reference's TPU profile pads S to (its
# ``configs/shapes.py`` ``ssd_bc`` and ``rglru_bc``)
SSD_BC = 128
RGLRU_BC = 256


def ssd_scan(x, dt, A, B, C, *, bc: Optional[int] = None,
             h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """Shapes as in ``ref.ssd``.  Returns y (b, nh, S, dp) [, h_S].

    S is padded up to a multiple of the chunk length with dt = 0 steps
    (decay exp(0 A) = 1 and a zero input leave the state as it was); the
    padded outputs are sliced off.  dt, A, B and C go to the kernel as
    contiguous float32.  Where a gradient is wanted the padded call goes
    through ``SSDScan`` (the padded steps' gradients are sliced off with
    them); the state is then not returned."""
    S = x.shape[2]
    bc = min(bc if bc is not None else SSD_BC, S)
    pad = (-S) % bc if bc > 0 else 0
    x = x.contiguous()
    dt, A, B, C = (t.float().contiguous() for t in (dt, A, B, C))
    h0 = None if h0 is None else h0.float().contiguous()
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    if _wants_grad(x, dt, A, B, C, h0):
        if return_state:
            raise ValueError("ssd_scan: the final state takes no gradient; "
                             "ask for it under torch.no_grad()")
        out = _ssd.SSDScan.apply(x, dt, A, B, C, h0)
    else:
        out = _ssd.ssd_scan(x, dt, A, B, C, h0=h0,
                            return_state=return_state)
    if not pad:
        return out
    if return_state:
        return out[0][:, :, :S], out[1]
    return out[:, :, :S]


def ssd_step(h, x_t, dt_t, A, B_t, C_t):
    """Single-token SSD recurrence for decode (elementwise torch ops).
    h (b,nh,dp,N); x_t (b,nh,dp); dt_t (b,nh); A (nh,); B_t/C_t (b,N).
    Returns (h_new, y_t (b,nh,dp))."""
    hf = h.float()
    decay = torch.exp(dt_t.float() * A.float()[None])
    upd = torch.einsum("bh,bhp,bn->bhpn", dt_t.float(), x_t.float(),
                       B_t.float())
    h_new = hf * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, C_t.float())
    return h_new.to(h.dtype), y.to(x_t.dtype)


def rglru_scan(a, b, *, bc: Optional[int] = None,
               h0: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """a, b: (B, S, W) -> h at every step (B, S, W) [, h_S (B, W) f32].

    S is padded with trailing zero steps up to a multiple of the chunk
    length (earlier steps are unaffected); the kernel takes the true S for
    the final state, since a zero step resets h to 0.  Where a gradient is
    wanted the padded call goes through ``RGLRUScan``."""
    S = a.shape[1]
    bc = min(bc if bc is not None else RGLRU_BC, S)
    pad = (-S) % bc if bc > 0 else 0
    a, b = a.contiguous(), b.contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    if _wants_grad(a, b, h0):
        if return_state:
            raise ValueError("rglru_scan: the final state takes no "
                             "gradient; ask for it under torch.no_grad()")
        out = _rglru.RGLRUScan.apply(a, b, h0)
    else:
        out = _rglru.rglru_scan(a, b, h0=h0, return_state=return_state,
                                n_valid=S)
    if not pad:
        return out
    if return_state:
        return out[0][:, :S], out[1]
    return out[:, :S]


def rglru_step(h, a_t, b_t):
    """h, a_t, b_t: (B, W) -> h_new."""
    return (a_t.float() * h.float() + b_t.float()).to(h.dtype)
