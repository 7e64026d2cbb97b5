"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave, MoE every
other layer.  [arXiv:2403.19887]

Super-block = 8 layers: attention at position 3, Mamba elsewhere (1:7 ratio),
MoE on odd positions (every second layer) — the published Jamba block layout.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=("mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba", "mamba"),
    moe_positions=(1, 3, 5, 7),
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    rope="none",                # Jamba's attention uses no positional encoding
    activation="swiglu",
    norm="rmsnorm",
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, moe_d_ff=512, vocab_size=512,
        pattern=("mamba", "attn"), moe_positions=(1,), n_experts=4, top_k=2)
