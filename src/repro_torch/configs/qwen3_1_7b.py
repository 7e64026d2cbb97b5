"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    pattern=("attn",),
    rope="standard",
    rope_theta=1000000.0,
    qk_norm=True,
    activation="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-1.7b-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
