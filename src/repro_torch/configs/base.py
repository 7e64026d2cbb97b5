"""Architecture configuration schema (a copy of `repro/configs/base.py`:
the port imports nothing of the JAX package, so its pure-data configs are
copied whole; `tests/test_torch_configs.py` holds the copies equal).

One ``ArchConfig`` instance fully determines a model: block pattern, attention
geometry, MoE/SSM settings, and modality frontend stubs.  Every assigned
architecture ships as ``configs/<id>.py`` exposing ``CONFIG`` (the
exact published geometry, source cited) and ``smoke_config()`` (a reduced
variant: <= 2 super-blocks, d_model <= 512, <= 4 experts) for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "mamba", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    source: str                       # citation from the assignment table

    # geometry
    num_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 3072
    vocab_size: int = 50304

    # block pattern: one *super-block* is scanned `num_layers // len(pattern)`
    # times.  Heterogeneous archs (jamba, xlstm) use patterns longer than 1.
    pattern: tuple[BlockKind, ...] = ("attn",)
    # which positions inside a super-block use MoE instead of a dense MLP
    moe_positions: tuple[int, ...] = ()

    # attention options
    rope: str = "standard"            # standard | glm2d | mrope | none
    rope_theta: float = 10000.0
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2
    sliding_window: int = 0           # 0 -> full causal; >0 -> window size
    logit_softcap: float = 0.0        # grok-style attention logit soft cap

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # 0 -> d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # dispatch groups over the token dim (1 = paper-faithful global
    # capacity; = data-shards for shard-local dispatch, see moe.py)
    moe_groups: int = 1

    # SSM (mamba) — jamba defaults
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2

    # xLSTM
    xlstm_proj_factor: float = 2.0

    # MLP
    activation: str = "swiglu"        # swiglu | gelu | geglu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5

    # decode: co-shard q/cache on kv-heads-or-head_dim (§Perf HC4); False
    # reproduces the pre-fix lowering for the before/after comparison
    decode_coshard: bool = True

    # modality frontend stubs (audio / vlm): embeddings arrive precomputed
    input_mode: str = "tokens"        # tokens | embeds | tokens+patches
    num_patches: int = 0              # vlm: patch embeds prepended to text
    tie_embeddings: bool = False

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(f"{self.name}: num_layers {self.num_layers} not a "
                             f"multiple of pattern length {len(self.pattern)}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def num_super_blocks(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def has_attention(self) -> bool:
        return "attn" in self.pattern

    @property
    def is_recurrent_only(self) -> bool:
        return not self.has_attention

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d                  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d             # lm head
        per_pattern = 0
        for i, kind in enumerate(self.pattern):
            if kind == "attn":
                per_pattern += d * (self.n_heads * hd)            # q
                per_pattern += 2 * d * (self.n_kv_heads * hd)     # k, v
                per_pattern += (self.n_heads * hd) * d            # o
                if self.qkv_bias:
                    per_pattern += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif kind == "mamba":
                di = self.ssm_expand * d
                per_pattern += d * 2 * di                         # in_proj
                per_pattern += di * self.ssm_conv_dim             # conv
                per_pattern += di * (2 * self.ssm_state_dim + 1)  # x_proj (B,C,dt)
                per_pattern += di + di * self.ssm_state_dim       # dt_proj-ish, A
                per_pattern += di * d                             # out_proj
            elif kind in ("mlstm", "slstm"):
                dp = int(self.xlstm_proj_factor * d)
                per_pattern += d * 3 * dp + dp * d                # qkv-ish + out
                per_pattern += 2 * dp                             # gates
            # mlp / moe
            if i in self.moe_positions and self.n_experts:
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                per_pattern += self.n_experts * mult * d * self.resolved_moe_d_ff
                per_pattern += d * self.n_experts                 # router
            elif kind != "mamba" or True:   # every block has an MLP unless MoE
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                per_pattern += mult * d * self.d_ff if self.d_ff else 0
            per_pattern += 2 * d                                  # 2 norms
        total += per_pattern * self.num_super_blocks
        total += d                                                # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        expert_p = mult * d * self.resolved_moe_d_ff
        n_moe_layers = len(self.moe_positions) * self.num_super_blocks
        dead = (self.n_experts - self.top_k) * expert_p * n_moe_layers
        return self.param_count() - dead
