"""PyTorch + CUDA port of the `repro` package, for one NVIDIA H100.

The layout mirrors `src/repro/` (``configs/``, ``core/``, ``optim/``,
``data/``, ``models/``, ``kernels/``, ``train/``, ``launch/``, ``serve/``)
so each module's counterpart is found by name.  The package imports
``torch`` and never ``jax``; nothing here imports the JAX package either
(its pure-data modules are copied, not shared).

Ported so far:

* the serving path -- ``serve.engine.ServeEngine`` over the paged KV cache
  and the attention transformer it runs;
* the production trainer -- ``launch.train`` -> ``launch.harness`` ->
  ``core.protocol``: the two-level network, readiness-policy plans, the
  gated inner optimizers, dense / two_stage / ppermute mixing, full
  protocol checkpoints in the JAX on-disk format, and u_k handed to
  ``ServeEngine``;
* three hand-written Hopper kernels: ``csrc/flash_fwd.cu`` (flash-attention
  forward), ``csrc/flash_bwd.cu`` (its backward) and
  ``csrc/flash_decode.cu`` (paged flash-decode).

Device rule: entry points that create tensors (``init_model``,
``init_paged_state``, ``ServeEngine``, ``state_from_network``,
``run_training``, ``load_u_k``, ``interop.params_from_numpy``) run on
``cuda`` unless the caller passes ``device="cpu"``, and raise when no GPU is
present.  Functions that take tensors run where those tensors live.
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
