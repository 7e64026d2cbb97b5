"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias.  [arXiv:2407.10671]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    pattern=("attn",),
    rope="standard",
    rope_theta=1000000.0,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,          # qwen2-0.5b ties lm_head to the embedding
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-0.5b-smoke", num_layers=2, d_model=224, n_heads=14,
        n_kv_heads=2, head_dim=16, d_ff=512, vocab_size=512)
