"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191]

The ViT vision encoder + projector is a STUB per the brief: input_specs()
supplies precomputed patch embeddings (B, P, d_model), prepended to the text
tokens.  M-RoPE drives 3 position streams (temporal/height/width).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=("attn",),
    rope="mrope",
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    input_mode="tokens+patches",
    num_patches=1024,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512, num_patches=16)
