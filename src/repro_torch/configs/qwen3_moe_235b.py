"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                    # per-expert intermediate size
    vocab_size=151936,
    pattern=("attn",),
    moe_positions=(0,),           # every layer is MoE
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    rope="standard",
    rope_theta=1000000.0,
    qk_norm=True,
    activation="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=256, moe_d_ff=256, vocab_size=512,
        n_experts=4, top_k=2)
