"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The EnCodec conv codec + codebook-interleaving frontend is a STUB per the
brief: input_specs() supplies precomputed frame embeddings (B, S, d_model);
the decoder predicts the next EnCodec token (vocab 2048).
Adaptation note: learned positional embeddings replaced by RoPE (DESIGN.md).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=("attn",),
    rope="standard",
    activation="gelu",
    norm="layernorm",
    input_mode="embeds",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512)
