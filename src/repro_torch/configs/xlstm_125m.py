"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks.  [arXiv:2405.04517]

Adaptation note (DESIGN.md §5): the 12 layers alternate [mLSTM, sLSTM] in a
period-2 super-block so depth scans stay homogeneous; the paper's xLSTM[a:b]
ratios are a configuration of the same two block types.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                       # xLSTM blocks subsume the FFN
    vocab_size=50304,
    pattern=("mlstm", "slstm"),
    rope="none",
    xlstm_proj_factor=2.0,
    norm="layernorm",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", num_layers=2, d_model=256, n_heads=4)
