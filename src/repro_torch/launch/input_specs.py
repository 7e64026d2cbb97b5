"""Shape stand-ins for every (architecture x input-shape) combination
(counterpart of `repro/launch/input_specs.py`): each input is a
``torch.empty(shape, dtype=..., device="meta")`` where the JAX package
builds a ``jax.ShapeDtypeStruct``, so the dry run (`launch.dryrun`) runs
the real program on them without allocating.

The four assigned input shapes:

  train_4k     seq_len=4,096    global_batch=256   (training)
  prefill_32k  seq_len=32,768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32,768   global_batch=128   (inference-decode)
  long_500k    seq_len=524,288  global_batch=1     (long-context-decode)

Decode shapes run ``serve_step`` -- ONE new token against a KV cache (or
SSM / xLSTM recurrent state) of ``seq_len``.  ``long_500k`` requires
sub-quadratic attention: attention architectures switch to the
sliding-window variant (window 4,096, backed by the rotating-buffer
cache), so no architecture skips long_500k; SSM / hybrid architectures run
natively on O(1) state.

Modality stubs: audio architectures receive precomputed frame embeddings
``(B, S, d_model)``; VLM architectures receive ``num_patches`` patch
embeddings prepended to ``seq - num_patches`` text tokens, plus the
3-stream M-RoPE position tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import dtype_of

META = torch.device("meta")


def spec(shape, dtype: torch.dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

LONG_CONTEXT_WINDOW = 4_096


def adapt_config(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Per-shape config adaptation: long_500k forces the sub-quadratic
    sliding-window attention variant on full-attention architectures
    (SSM / xLSTM layers are already O(1)-state and unchanged)."""
    if (shape.name == "long_500k" and cfg.has_attention
            and cfg.sliding_window == 0):
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _mrope_positions(cfg: ArchConfig, batch: int, seq: int) -> torch.Tensor:
    ns = max(rope_mod.num_streams(cfg), 1)
    return spec((ns, batch, seq), torch.int32)


def _fwd_batch_specs(cfg: ArchConfig, batch: int, seq: int,
                     *, with_labels: bool) -> dict:
    """Forward-pass inputs for one replica (no worker axis)."""
    cdt = dtype_of(cfg.compute_dtype)
    out: dict = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = spec((batch, seq), torch.int32)
        text_len = seq
    elif cfg.input_mode == "embeds":
        out["frame_embeds"] = spec((batch, seq, cfg.d_model), cdt)
        text_len = seq
    elif cfg.input_mode == "tokens+patches":
        p = min(cfg.num_patches, seq // 2)
        text_len = seq - p
        out["tokens"] = spec((batch, text_len), torch.int32)
        out["patch_embeds"] = spec((batch, p, cfg.d_model), cdt)
        out["positions"] = _mrope_positions(cfg, batch, seq)
    else:
        raise ValueError(cfg.input_mode)
    if with_labels:
        out["labels"] = spec((batch, text_len), torch.int32)
    return out


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec,
                      num_workers: int) -> dict:
    """Per-worker training batch: every leaf gains a leading worker axis;
    the global batch splits evenly across workers."""
    if shape.global_batch % num_workers:
        raise ValueError(f"global_batch {shape.global_batch} not divisible "
                         f"by {num_workers} workers")
    per = shape.global_batch // num_workers
    one = _fwd_batch_specs(cfg, per, shape.seq_len, with_labels=True)
    return {k: spec((num_workers,) + tuple(v.shape), v.dtype)
            for k, v in one.items()}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    return _fwd_batch_specs(cfg, shape.global_batch, shape.seq_len,
                            with_labels=False)


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """One-token decode inputs (the KV / SSM state's stand-ins come from
    ``init_decode_state(device="meta")``, in `launch.dryrun`)."""
    cdt = dtype_of(cfg.compute_dtype)
    b = shape.global_batch
    if cfg.input_mode == "embeds":
        tok = {"frame_embeds": spec((b, 1, cfg.d_model), cdt)}
    else:
        tok = {"tokens": spec((b, 1), torch.int32)}
    return {"batch": tok, "cur": spec((), torch.int32)}


def input_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                num_workers: int = 1) -> dict:
    """Unified entry point, dispatching on the shape's kind."""
    cfg = adapt_config(cfg, shape)
    if shape.kind == "train":
        return train_input_specs(cfg, shape, num_workers)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
