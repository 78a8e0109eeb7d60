"""The 10 assigned architectures — exact published configs + reduced
smoke variants (same family, tiny dims) for CPU tests.

Sources are noted per config ([arXiv / hf] per the assignment).  Smoke
variants keep every structural feature (GQA ratio shape, SWA, MoE top-k,
dense residual, hybrid pattern incl. a tail remainder, tied embeddings)
so the smoke tests exercise the same code paths as the full configs.
"""
from __future__ import annotations

from repro_torch.models.api import ArchConfig, Family, register


# ---------------------------------------------------------------------------
# dense llama-family
# ---------------------------------------------------------------------------

def yi_9b() -> ArchConfig:
    # [arXiv:2403.04652] llama-arch GQA
    return ArchConfig(
        name="yi-9b", family=Family.DENSE, n_layers=48, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64000,
        rope_theta=5_000_000.0)


def yi_9b_smoke() -> ArchConfig:
    return ArchConfig(
        name="yi-9b-smoke", family=Family.DENSE, n_layers=3, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=160, vocab_size=512,
        rope_theta=5_000_000.0)


def codeqwen15_7b() -> ArchConfig:
    # [hf:Qwen/CodeQwen1.5-7B] qwen1.5-arch (MHA: kv == heads)
    return ArchConfig(
        name="codeqwen1.5-7b", family=Family.DENSE, n_layers=32,
        d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
        vocab_size=92416, rope_theta=1_000_000.0)


def codeqwen15_7b_smoke() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b-smoke", family=Family.DENSE, n_layers=3,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=192, vocab_size=512,
        rope_theta=1_000_000.0)


def h2o_danube3_4b() -> ArchConfig:
    # [arXiv:2401.16818] llama+mistral mix, sliding-window attention
    return ArchConfig(
        name="h2o-danube-3-4b", family=Family.DENSE, n_layers=24,
        d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
        vocab_size=32000, sliding_window=4096, rope_theta=10_000.0)


def h2o_danube3_4b_smoke() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b-smoke", family=Family.DENSE, n_layers=3,
        d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab_size=512,
        sliding_window=16)


def smollm_360m() -> ArchConfig:
    # [hf:HuggingFaceTB/SmolLM-360M] llama-arch small; 15 heads (dh=64)
    return ArchConfig(
        name="smollm-360m", family=Family.DENSE, n_layers=32, d_model=960,
        n_heads=15, n_kv_heads=5, d_ff=2560, vocab_size=49152)


def smollm_360m_smoke() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m-smoke", family=Family.DENSE, n_layers=3,
        d_model=60, n_heads=3, n_kv_heads=1, d_ff=160, vocab_size=512,
        head_dim=20)


# ---------------------------------------------------------------------------
# audio encoder
# ---------------------------------------------------------------------------

def hubert_xlarge() -> ArchConfig:
    # [arXiv:2106.07447] encoder-only; conv frontend stubbed (512-dim frames)
    return ArchConfig(
        name="hubert-xlarge", family=Family.AUDIO, n_layers=48,
        d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504,
        causal=False, norm="layernorm", act="gelu", frontend_dim=512)


def hubert_xlarge_smoke() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge-smoke", family=Family.AUDIO, n_layers=3,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
        causal=False, norm="layernorm", act="gelu", frontend_dim=24)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def mixtral_8x7b() -> ArchConfig:
    # [arXiv:2401.04088] 8 experts top-2, SWA
    return ArchConfig(
        name="mixtral-8x7b", family=Family.MOE, n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
        sliding_window=4096, n_experts=8, top_k=2, rope_theta=1_000_000.0)


def mixtral_8x7b_smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-smoke", family=Family.MOE, n_layers=3,
        d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab_size=512,
        sliding_window=16, n_experts=4, top_k=2, capacity_factor=2.0)


def arctic_480b() -> ArchConfig:
    # [hf:Snowflake/snowflake-arctic-base] 128 experts top-2 + dense residual
    return ArchConfig(
        name="arctic-480b", family=Family.MOE, n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
        n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True)


def arctic_480b_smoke() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b-smoke", family=Family.MOE, n_layers=3,
        d_model=64, n_heads=8, n_kv_heads=2, d_ff=96, vocab_size=512,
        n_experts=8, top_k=2, moe_d_ff=96, dense_residual=True,
        capacity_factor=4.0)


# ---------------------------------------------------------------------------
# VLM
# ---------------------------------------------------------------------------

def internvl2_76b() -> ArchConfig:
    # [arXiv:2404.16821] InternViT frontend (stub: 3200-dim patch embeds)
    # + llama-3-70B-style backbone
    return ArchConfig(
        name="internvl2-76b", family=Family.VLM, n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=128256,
        rope_theta=500_000.0, frontend_dim=3200)


def internvl2_76b_smoke() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b-smoke", family=Family.VLM, n_layers=3,
        d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab_size=512,
        frontend_dim=48)


# ---------------------------------------------------------------------------
# hybrid (Griffin)
# ---------------------------------------------------------------------------

def recurrentgemma_2b() -> ArchConfig:
    # [arXiv:2402.19427] RG-LRU + local attention, 1 attn : 2 recurrent
    return ArchConfig(
        name="recurrentgemma-2b", family=Family.HYBRID, n_layers=26,
        d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
        vocab_size=256000, act="geglu", tie_embeddings=True,
        block_pattern=("rglru", "rglru", "attn"), rglru_width=2560,
        local_attn_window=2048, logit_softcap=30.0)


def recurrentgemma_2b_smoke() -> ArchConfig:
    # 5 layers = 1 full pattern unit + 2-layer tail (exercises tail path)
    return ArchConfig(
        name="recurrentgemma-2b-smoke", family=Family.HYBRID, n_layers=5,
        d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=512,
        act="geglu", tie_embeddings=True,
        block_pattern=("rglru", "rglru", "attn"), rglru_width=64,
        local_attn_window=16, logit_softcap=30.0)


# ---------------------------------------------------------------------------
# SSM (Mamba-2)
# ---------------------------------------------------------------------------

def mamba2_780m() -> ArchConfig:
    # [arXiv:2405.21060] SSD; d_inner=3072, headdim=64 -> 48 ssm heads
    return ArchConfig(
        name="mamba2-780m", family=Family.SSM, n_layers=48, d_model=1536,
        vocab_size=50280, tie_embeddings=True, ssm_state=128,
        ssm_head_dim=64, ssm_expand=2, ssm_chunk=256, conv_width=4)


def mamba2_780m_smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m-smoke", family=Family.SSM, n_layers=3,
        d_model=64, vocab_size=512, tie_embeddings=True, ssm_state=16,
        ssm_head_dim=16, ssm_expand=2, ssm_chunk=16, conv_width=4)


ASSIGNED = {
    "yi-9b": (yi_9b, yi_9b_smoke),
    "codeqwen1.5-7b": (codeqwen15_7b, codeqwen15_7b_smoke),
    "h2o-danube-3-4b": (h2o_danube3_4b, h2o_danube3_4b_smoke),
    "smollm-360m": (smollm_360m, smollm_360m_smoke),
    "hubert-xlarge": (hubert_xlarge, hubert_xlarge_smoke),
    "mixtral-8x7b": (mixtral_8x7b, mixtral_8x7b_smoke),
    "arctic-480b": (arctic_480b, arctic_480b_smoke),
    "internvl2-76b": (internvl2_76b, internvl2_76b_smoke),
    "recurrentgemma-2b": (recurrentgemma_2b, recurrentgemma_2b_smoke),
    "mamba2-780m": (mamba2_780m, mamba2_780m_smoke),
}

for _name, (_full, _smoke) in ASSIGNED.items():
    register(_name, _full, _smoke)
