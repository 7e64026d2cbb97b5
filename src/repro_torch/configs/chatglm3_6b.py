"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d, GQA.  [arXiv:2406.12793]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    pattern=("attn",),
    rope="glm2d",
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="chatglm3-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
