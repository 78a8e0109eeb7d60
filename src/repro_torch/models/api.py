"""Architecture config and registry of the port (``repro.models.api``
with torch dtypes).

Parameters are nested dicts of tensors in the reference's layouts, in two
views:

  * **stacked view** — every per-layer leaf is stacked along a leading
    ``(n_units, ...)`` axis (``blocks/s0``); the steady-state forward loops
    over it.
  * **streaming view** — the cold-start pipeline constructs, retrieves and
    applies weights one unit at a time (``unit_names`` / ``init_unit`` /
    ``abstract_unit``); ``assemble`` stacks the units back into the stacked
    view once the model is live.

``get_config(name, smoke=...)`` names the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Tuple

import torch


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    AUDIO = "audio"      # encoder-only transformer backbone, stub frontend
    VLM = "vlm"          # decoder backbone, stub vision frontend
    VISION = "vision"    # paper's own eval family (ResNet/VGG/ViT)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture hyper-parameters.

    One instance per assigned architecture (``configs/lm_archs.py``)
    plus reduced variants for CPU smoke tests.
    """

    name: str
    family: Family

    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # attention flavour
    causal: bool = True               # False for encoder-only (hubert)
    sliding_window: int = 0           # 0 -> full attention
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"             # "rmsnorm" | "layernorm"
    act: str = "silu"                 # "silu" (SwiGLU) | "gelu" (plain MLP)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0                # 0 -> dense FFN
    top_k: int = 0
    moe_d_ff: int = 0                 # expert hidden dim (d_ff used if 0)
    dense_residual: bool = False      # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # SSM (mamba-2 SSD)
    ssm_state: int = 0                # N, state dim per head
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # hybrid (griffin / recurrentgemma): block pattern unit, e.g.
    # ("rglru", "rglru", "attn") repeated; remainder truncates the unit.
    block_pattern: Tuple[str, ...] = ()
    rglru_width: int = 0              # RG-LRU recurrence width (d_model if 0)
    local_attn_window: int = 0

    # modality frontend stubs
    frontend_dim: int = 0             # audio frame / vision patch embed dim

    # vision (paper's own eval family: ResNet / VGG / ViT)
    vision_variant: str = ""          # e.g. "resnet50", "vgg16", "vit_b_16"
    img_res: int = 224

    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    # --- derived -----------------------------------------------------------
    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def q_rep(self) -> int:
        """GQA repetition factor (query heads per KV head)."""
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attention_free(self) -> bool:
        return self.family == Family.SSM

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (500k) is feasible: the per-token
        state is O(window) or O(1), not O(seq)."""
        if self.family in (Family.SSM, Family.HYBRID):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                    # token embedding
        if not self.tie_embeddings and not self.is_encoder:
            total += d * v                               # lm head
        if self.is_encoder:
            total += d * v                               # classifier head
        per_layer = self._per_layer_params()
        total += sum(per_layer)
        total += d                                       # final norm
        return total

    def _per_layer_params(self) -> List[int]:
        d = self.d_model
        dh = self.dh
        out: List[int] = []
        for kind in self.layer_kinds():
            p = 2 * d                                    # two norms
            if kind == "attn":
                p += d * self.n_heads * dh               # wq
                p += 2 * d * self.n_kv_heads * dh        # wk, wv
                p += self.n_heads * dh * d               # wo
                p += self._ffn_params()
            elif kind == "moe":
                p += d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                     + self.n_heads * dh * d
                f = self.moe_d_ff or self.d_ff
                p += d * self.n_experts                  # router
                p += self.n_experts * 3 * d * f          # experts (SwiGLU)
                if self.dense_residual:
                    p += 3 * d * self.d_ff
            elif kind == "ssd":
                p += self._ssd_params()
            elif kind == "rglru":
                w = self.rglru_width or d
                p += 2 * d * w + w * d                   # gates + out
                p += 2 * w                               # lambda, gate bias
                p += self.conv_width * w                 # temporal conv
                p += self._ffn_params()
            elif kind == "local_attn":
                p += d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                     + self.n_heads * dh * d
                p += self._ffn_params()
            out.append(p)
        return out

    def _ffn_params(self) -> int:
        if self.act in ("silu", "geglu"):
            return 3 * self.d_model * self.d_ff          # gated: 3 matrices
        return 2 * self.d_model * self.d_ff              # plain MLP

    def _ssd_params(self) -> int:
        d = self.d_model
        d_inner = self.ssm_expand * d
        nh = self.ssm_heads or (d_inner // max(self.ssm_head_dim, 1))
        n = self.ssm_state
        # ngroups = 1: B and C are shared across heads (mamba-2 default)
        p = d * (2 * d_inner + 2 * n + nh)               # in_proj (z,x,B,C,dt)
        p += self.conv_width * (d_inner + 2 * n)         # conv over x,B,C
        p += nh + nh                                     # A_log, D
        p += d_inner                                     # pre-out norm
        p += d_inner * d                                 # out_proj
        return p

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind, length ``n_layers``."""
        if self.family == Family.SSM:
            return ["ssd"] * self.n_layers
        if self.family == Family.HYBRID:
            pat = self.block_pattern or ("rglru", "rglru", "attn")
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        if self.family == Family.MOE:
            return ["moe"] * self.n_layers
        return ["attn"] * self.n_layers

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != Family.MOE:
            return self.param_count()
        d = self.d_model
        f = self.moe_d_ff or self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * f
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# model registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str, full: Callable[[], ArchConfig],
             smoke: Callable[[], ArchConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def get_config(name: str, *, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    reg = _SMOKE_REGISTRY if smoke else _REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]()


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
