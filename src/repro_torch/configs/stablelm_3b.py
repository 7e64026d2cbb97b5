"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    pattern=("attn",),
    rope="standard",
    activation="swiglu",
    norm="layernorm",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512)
