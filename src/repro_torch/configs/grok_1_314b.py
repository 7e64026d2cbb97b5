"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    source="hf:xai-org/grok-1",
    num_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=("attn",),
    moe_positions=(0,),          # every layer is MoE
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    rope="standard",
    logit_softcap=30.0,          # grok attention logit soft cap
    activation="geglu",
    norm="rmsnorm",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="grok-1-smoke", num_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, moe_d_ff=512, vocab_size=512,
        n_experts=4, top_k=2)
