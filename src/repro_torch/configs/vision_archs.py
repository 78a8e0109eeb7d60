"""The paper's own evaluation families (Sec. IV-B): ResNet-50/101/152,
VGG-11/13/16/19, ViT-B-16 / B-32 / L-16 — the configs of
``repro.configs.vision_archs``.  Full configs take the published 224x224
input and 1000 ImageNet classes; smoke variants keep each family's
topology at 32x32 input and 10 classes (tests).
"""
from __future__ import annotations

from repro_torch.models.api import ArchConfig, Family, register

PAPER_MODELS = [
    "resnet50", "resnet101", "resnet152",
    "vgg11", "vgg13", "vgg16", "vgg19",
    "vit_b_16", "vit_b_32", "vit_l_16",
]


def _mk(variant: str) -> ArchConfig:
    return ArchConfig(name=variant, family=Family.VISION,
                      vocab_size=1000, vision_variant=variant, img_res=224)


def _mk_smoke(variant: str) -> ArchConfig:
    return ArchConfig(name=f"{variant}-smoke", family=Family.VISION,
                      vocab_size=10, vision_variant=variant, img_res=32)


for _v in PAPER_MODELS:
    register(_v, lambda v=_v: _mk(v), lambda v=_v: _mk_smoke(v))
