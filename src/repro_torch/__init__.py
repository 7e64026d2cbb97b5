"""PyTorch + CUDA port of the `repro` package, for one NVIDIA H100.

The layout mirrors `src/repro/` (``configs/``, ``core/``, ``optim/``,
``data/``, ``models/``, ``kernels/``, ``train/``, ``launch/``, ``serve/``)
so each module's counterpart is found by name.  The package imports
``torch`` and never ``jax``; nothing here imports the JAX package either
(its pure-data modules are copied, not shared).

Ported so far:

* the serving path -- ``serve.engine.ServeEngine`` over the paged KV cache
  and the attention transformer it runs;
* offline generation -- ``serve.serve_step.generate`` over the rotating
  dense decode cache for every architecture of the registry (attention,
  mamba, mLSTM / sLSTM, dense MLP or MoE; token, frame-embedding and
  patch inputs), sampling with `jax.random`'s bits, and chunked attention
  (``impl="chunked" | "auto"``);
* the production trainer -- ``launch.train`` -> ``launch.harness`` ->
  ``core.protocol``: the two-level network, readiness-policy plans, the
  gated inner optimizers, every registered mixing strategy (dense /
  two_stage / ppermute and the compression ladder: bf16, int8, int8_ef,
  int4_ef, topk_ef, powersgd), the chunked overlap of mixing events, full
  protocol checkpoints in the JAX on-disk format (the mixing state
  included), and u_k handed to ``ServeEngine``; it trains the attention
  transformers and xLSTM (mLSTM and sLSTM blocks);
* the simulator and the timeline executors -- ``simulate`` (the paper's
  Algorithm 1 in matrix form) and ``run_timeline`` (readiness-policy plans
  on a slot clock, event-sparse or every slot), with packing
  (``core.packing``), the paper's baselines and the outer optimizer;
* five sources of hand-written Hopper kernels: ``csrc/flash_fwd.cu``
  (flash-attention forward), ``csrc/flash_bwd.cu`` (its backward),
  ``csrc/flash_decode.cu`` (paged flash-decode), ``csrc/hier_mix.cu`` (the
  fused gated-SGD + averaging update, dense and grouped, per leaf, packed
  or chunked) and ``csrc/slstm_scan.cu`` (the sLSTM recurrence forward,
  its backward and the backward's dR / db reduction).

Device rule: entry points that create tensors (``init_model``,
``init_paged_state``, ``init_decode_state``, ``ServeEngine``,
``state_from_network``, ``run_training``, ``load_u_k``, ``simulate``,
``run_timeline``, ``interop.params_from_numpy``) run on ``cuda`` unless
the caller passes ``device="cpu"``, and raise when no GPU is present.
Functions that take tensors run where those tensors live (``generate``
runs where the params are).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


# the simulator's entry points (imported last: their modules use
# `resolve_device`)
from repro_torch.core.simulator import SimConfig, simulate  # noqa: E402
from repro_torch.core.timeline import run_timeline  # noqa: E402

__all__ = ["SimConfig", "resolve_device", "run_timeline", "simulate"]
