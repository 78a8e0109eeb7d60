"""The paper's own evaluation families — ResNet, VGG, ViT — as
streaming-unit models of the port (``repro.models.vision``), with the
protocol of :class:`repro_torch.models.transformer.LM`: ``unit_names``,
``init_unit`` / ``abstract_unit``, ``assemble``, ``unit_apply`` and
``forward``, on an explicit ``device``.

Units follow the reference's decomposition: ``stem`` / ``stage1..4`` /
``head`` (ResNet), ``stage1..5`` / ``head`` (VGG), ``patch`` /
``block_00..`` / ``head`` (ViT).  Leaves keep the reference's shapes and
layouts, so the port reads the bytes the JAX package deployed: conv
kernels are HWIO and activations NHWC, permuted to PyTorch's NCHW /
OIHW only around each ``F.conv2d`` and ``F.max_pool2d``.  ResNet's and
VGG's per-block leaves sit in lists (``blocks/0/conv1``,
``convs/2``), flattened in index order as ``jax.tree_util`` does.

Inference only: the paper's workload is one ``1x3x224x224`` image.  No
Pallas kernel runs here in the reference (its convs, products and ViT
attention are XLA ops), so the port computes them with PyTorch's ops;
the cold start's ``weight_transform`` is the one kernel on this path.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.api import ArchConfig
from repro_torch.models.transformer import unit_seed

PyTree = Any

RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                 "resnet152": (3, 8, 36, 3)}
VGG_STAGES = {"vgg11": (1, 1, 2, 2, 2), "vgg13": (2, 2, 2, 2, 2),
              "vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}
VGG_CH = (64, 128, 256, 512, 512)
# (layers, width, heads, MLP width, patch)
VIT = {"vit_b_16": (12, 768, 12, 3072, 16),
       "vit_b_32": (12, 768, 12, 3072, 32),
       "vit_l_16": (24, 1024, 16, 4096, 16)}


# ---------------------------------------------------------------------------
# leaf construction: initialized (PISeL) or shape-only (MiniLoader)
# ---------------------------------------------------------------------------

class _Leaves:
    """Makes a unit's f32 leaves on ``device``: drawn from ``gen`` with
    the reference's init rules, or left uninitialized when ``gen`` is
    None (the meta device's structure)."""

    def __init__(self, device, gen: Optional[torch.Generator] = None):
        self.device = device
        self.gen = gen

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def dense(self, shape, fan_in: Optional[int] = None) -> torch.Tensor:
        t = self._empty(shape)
        if self.gen is not None:
            layers.dense_init_(t, self.gen, fan_in=fan_in)
        return t

    def embed(self, shape) -> torch.Tensor:
        t = self._empty(shape)
        if self.gen is not None:
            layers.embed_init_(t, self.gen)
        return t

    def fill(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)

    def conv(self, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
        return self.dense((kh, kw, cin, cout), fan_in=kh * kw * cin)

    def bn(self, c: int) -> Dict[str, torch.Tensor]:
        return {"scale": self.fill((c,), 1.0), "bias": self.fill((c,), 0.0),
                "mean": self.fill((c,), 0.0), "var": self.fill((c,), 1.0)}

    def fc(self, cin: int, cout: int) -> Dict[str, torch.Tensor]:
        return {"w": self.dense((cin, cout), fan_in=cin),
                "b": self.fill((cout,), 0.0)}

    def ln(self, d: int) -> Dict[str, torch.Tensor]:
        return {"scale": self.fill((d,), 1.0), "bias": self.fill((d,), 0.0)}


# ---------------------------------------------------------------------------
# primitive layers (NHWC activations, HWIO kernels)
# ---------------------------------------------------------------------------

def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: ``total`` split with the
    odd pixel at the end (PyTorch's ``padding=`` is symmetric)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, s: int,
              value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor as ``SAME`` pads its NHWC view."""
    top, bottom = same_pads(x.shape[2], kh, s)
    left, right = same_pads(x.shape[3], kw, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x (B, H, W, Cin) * kernel (kh, kw, Cin, Cout) -> (B, H', W', Cout),
    ``padding`` "SAME" or "VALID" as XLA pads them."""
    kh, kw = kernel.shape[:2]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        xc = _pad_same(xc, kh, kw, stride)
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def bn_apply(p: PyTree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over the last axis, as the reference writes
    it (not ``F.batch_norm``, which orders the ops differently)."""
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * (inv * p["scale"]) + p["bias"]


def fc_apply(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def maxpool(x: torch.Tensor, window: int = 3, stride: int = 2
            ) -> torch.Tensor:
    """``SAME`` max pool of an NHWC tensor; padding reads as -inf."""
    xc = _pad_same(x.permute(0, 3, 1, 2), window, window, stride,
                   value=-math.inf)
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# unit builders: (name, make(leaves) -> tree, apply(p, x) -> x)
# ---------------------------------------------------------------------------

Unit = Tuple[str, Callable[[_Leaves], PyTree], Callable]


def _bottleneck(mk: _Leaves, cin: int, cmid: int, stride: int) -> PyTree:
    p = {"conv1": mk.conv(1, 1, cin, cmid), "bn1": mk.bn(cmid),
         "conv2": mk.conv(3, 3, cmid, cmid), "bn2": mk.bn(cmid),
         "conv3": mk.conv(1, 1, cmid, cmid * 4), "bn3": mk.bn(cmid * 4)}
    if stride != 1 or cin != cmid * 4:
        p["down"] = {"conv": mk.conv(1, 1, cin, cmid * 4),
                     "bn": mk.bn(cmid * 4)}
    return p


def _bottleneck_apply(p: PyTree, x: torch.Tensor, stride: int
                      ) -> torch.Tensor:
    y = F.relu(bn_apply(p["bn1"], conv2d(x, p["conv1"])))
    y = F.relu(bn_apply(p["bn2"], conv2d(y, p["conv2"], stride)))
    y = bn_apply(p["bn3"], conv2d(y, p["conv3"]))
    if "down" in p:
        x = bn_apply(p["down"]["bn"], conv2d(x, p["down"]["conv"], stride))
    return F.relu(x + y)


def _resnet_units(cfg: ArchConfig) -> List[Unit]:
    def stem_apply(p, x):
        return maxpool(F.relu(bn_apply(p["bn"], conv2d(x, p["conv"], 2))))

    units: List[Unit] = [("stem", lambda mk: {"conv": mk.conv(7, 7, 3, 64),
                                              "bn": mk.bn(64)}, stem_apply)]
    cin = 64
    for si, nb in enumerate(RESNET_BLOCKS[cfg.vision_variant]):
        cmid, stride = 64 * 2 ** si, (1 if si == 0 else 2)

        def make(mk, nb=nb, cin=cin, cmid=cmid, stride=stride):
            return {"blocks": [_bottleneck(mk, cin if b == 0 else cmid * 4,
                                           cmid, stride if b == 0 else 1)
                               for b in range(nb)]}

        def apply(p, x, stride=stride):
            for b, bp in enumerate(p["blocks"]):
                x = _bottleneck_apply(bp, x, stride if b == 0 else 1)
            return x

        units.append((f"stage{si + 1}", make, apply))
        cin = cmid * 4

    units.append(("head", lambda mk, cin=cin: {"fc": mk.fc(cin,
                                                           cfg.vocab_size)},
                  lambda p, x: fc_apply(p["fc"], x.mean(dim=(1, 2)))))
    return units


def _vgg_units(cfg: ArchConfig) -> List[Unit]:
    units: List[Unit] = []
    cin = 3
    for si, (nc, ch) in enumerate(zip(VGG_STAGES[cfg.vision_variant],
                                      VGG_CH)):
        def make(mk, nc=nc, ch=ch, cin=cin):
            return {"convs": [mk.conv(3, 3, cin if c == 0 else ch, ch)
                              for c in range(nc)]}

        def apply(p, x):
            for k in p["convs"]:
                x = F.relu(conv2d(x, k))
            return maxpool(x, 2, 2)

        units.append((f"stage{si + 1}", make, apply))
        cin = ch

    spatial = max(cfg.img_res // 32, 1)                 # 5 maxpools of 2

    def head_make(mk):
        return {"fc1": mk.fc(512 * spatial * spatial, 4096),
                "fc2": mk.fc(4096, 4096),
                "fc3": mk.fc(4096, cfg.vocab_size)}

    def head_apply(p, x):
        x = x.reshape(x.shape[0], -1)       # NHWC order: fc1 rows (h, w, c)
        x = F.relu(fc_apply(p["fc1"], x))
        x = F.relu(fc_apply(p["fc2"], x))
        return fc_apply(p["fc3"], x)

    units.append(("head", head_make, head_apply))
    return units


def _vit_units(cfg: ArchConfig) -> List[Unit]:
    n_layers, d, h, ff, patch = VIT[cfg.vision_variant]
    n_patch = (cfg.img_res // patch) ** 2

    def patch_apply(p, x):
        x = conv2d(x, p["proj"], stride=patch, padding="VALID")
        return x.reshape(x.shape[0], -1, d) + p["pos"][None]

    def blk_make(mk):
        dh = d // h
        return {"ln1": mk.ln(d),
                "wq": mk.dense((d, h, dh)), "wk": mk.dense((d, h, dh)),
                "wv": mk.dense((d, h, dh)), "wo": mk.dense((h, dh, d)),
                "ln2": mk.ln(d), "fc1": mk.fc(d, ff), "fc2": mk.fc(ff, d)}

    def blk_apply(p, x):
        y = layers.layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        q = torch.einsum("bsd,dhk->bshk", y, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", y, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", y, p["wv"])
        s = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(q.shape[-1])
        o = torch.einsum("bhst,bthk->bshk", torch.softmax(s, dim=-1), v)
        x = x + torch.einsum("bshk,hkd->bsd", o, p["wo"])
        y = layers.layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"])
        return x + fc_apply(p["fc2"], layers.gelu(fc_apply(p["fc1"], y)))

    def head_apply(p, x):
        x = layers.layernorm(x, p["ln"]["scale"], p["ln"]["bias"])
        return fc_apply(p["fc"], x.mean(dim=1))

    return ([("patch", lambda mk: {"proj": mk.conv(patch, patch, 3, d),
                                   "pos": mk.embed((n_patch, d))},
              patch_apply)]
            + [(f"block_{j:02d}", blk_make, blk_apply)
               for j in range(n_layers)]
            + [("head", lambda mk: {"ln": mk.ln(d),
                                    "fc": mk.fc(d, cfg.vocab_size)},
                head_apply)])


# ---------------------------------------------------------------------------
# the model (streaming protocol)
# ---------------------------------------------------------------------------

class VisionModel:
    """One vision architecture = config + functions over a param tree
    ``{unit: unit tree}``, on ``device``."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        v = cfg.vision_variant
        if v in RESNET_BLOCKS:
            units = _resnet_units(cfg)
        elif v in VGG_STAGES:
            units = _vgg_units(cfg)
        elif v in VIT:
            units = _vit_units(cfg)
        else:
            raise ValueError(f"unknown vision variant {v!r}")
        self.cfg = cfg
        self.device = device
        self._units = units
        self._by_name = {n: (make, apply) for n, make, apply in units}
        self._abstract_units: Dict[str, PyTree] = {}

    def unit_names(self) -> List[str]:
        return [n for n, _, _ in self._units]

    def init_unit(self, name: str, gen: torch.Generator) -> PyTree:
        """PISeL-faithful construction: full numerical initialization, on
        the generator's device."""
        return self._by_name[name][0](_Leaves(gen.device, gen))

    def abstract_unit(self, name: str) -> PyTree:
        """MiniLoader construction: the unit's leaves on the meta device
        (shapes and dtypes, no storage).  Cached: static per model."""
        if name not in self._abstract_units:
            self._abstract_units[name] = self._by_name[name][0](
                _Leaves("meta"))
        return self._abstract_units[name]

    def assemble(self, units: Dict[str, PyTree], *,
                 consume: bool = False) -> PyTree:
        """The units' trees as they are (nothing is stacked, so
        ``consume`` has nothing to spend)."""
        return dict(units)

    def init(self, seed: int = 0) -> PyTree:
        """Freshly initialized params on the model's device, one generator
        per unit seeded from ``seed`` (as :func:`deploy_model` seeds
        them)."""
        units = {}
        for i, name in enumerate(self.unit_names()):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(unit_seed(seed, i))
            units[name] = self.init_unit(name, gen)
        return units

    def abstract(self) -> PyTree:
        return {n: self.abstract_unit(n) for n in self.unit_names()}

    @torch.no_grad()
    def unit_apply(self, name: str, uparams: PyTree,
                   state: Dict[str, Any]) -> Dict[str, Any]:
        """Layer-wise cold-start execution (the pipeline's E_i).

        state: {"batch": {"image": (B, 3, H, W)}} before the first unit;
        {"x": NHWC or (B, S, d) activations} after; after the last unit
        state["logits"] holds (B, classes)."""
        apply = self._by_name[name][1]
        out = dict(state)
        if name == self._units[0][0]:
            out["x"] = apply(uparams,
                             state["batch"]["image"].permute(0, 2, 3, 1))
        else:
            out["x"] = apply(uparams, state["x"])
        if name == self._units[-1][0]:
            out["logits"] = out["x"]
        return out

    @torch.no_grad()
    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward.  Returns (logits (B, classes), aux_loss 0)."""
        state: Dict[str, Any] = {"batch": batch}
        for name in self.unit_names():
            state = self.unit_apply(name, params[name], state)
        return (state["logits"],
                torch.zeros((), dtype=torch.float32,
                            device=state["logits"].device))

    def input_specs(self, kind: str, seq: int, batch: int
                    ) -> Dict[str, torch.Tensor]:
        """The inputs of a forward, as meta tensors."""
        r = self.cfg.img_res
        return {"image": torch.empty((batch, 3, r, r), dtype=torch.float32,
                                     device="meta")}


_models: Dict[Tuple[ArchConfig, str], VisionModel] = {}


def build(cfg: ArchConfig, device: DeviceLike = None) -> VisionModel:
    """Build (cached) the model for a config on ``device`` (default: the
    GPU; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    key = (cfg, str(dev))
    if key not in _models:
        _models[key] = VisionModel(cfg, dev)
    return _models[key]
