"""The one traffic generator: it reads a mix file of
``portbench/traffic/<name>.json`` and makes each worker's token stream
from the seed, on the host, in one draw.

A stream is Zipf-distributed over the vocabulary (token rank r with
probability proportional to r^-zipf, ranks mapped to ids by a seeded
permutation), as word frequencies are in text.  The program's own batcher
(`repro_torch.data.pipeline.LMBatcher`) cuts sequences from it, the
window's own feed; `Recorder` keeps the first batches it hands out, so
the reference is given the same rows.
"""
from __future__ import annotations

import numpy as np
import torch


def token_stream(workers: int, per_worker: int, vocab: int, seed: int,
                 zipf: float) -> np.ndarray:
    """(W, per_worker) int32 token ids drawn from the seed."""
    rng = np.random.default_rng([seed, 0x70726f67])
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -zipf
    ids = rng.permutation(vocab).astype(np.int32)
    draws = rng.choice(vocab, size=(workers, per_worker), p=p / p.sum())
    return ids[draws]


def recorder(batcher_cls, keep: int):
    """A subclass of the program's batcher that records the first
    ``keep`` batches it samples (CPU tensors)."""

    class Recorder(batcher_cls):
        kept: list

        def sample(self, rng):
            out = super().sample(rng)
            if "kept" not in self.__dict__:
                self.kept = []
            if len(self.kept) < keep:
                self.kept.append({k: v.clone() for k, v in out.items()})
            return out

    return Recorder


def distinct_rows(batch: dict) -> bool:
    """Whether every (worker, sequence) row of a batch differs."""
    rows = batch["tokens"].reshape(-1, batch["tokens"].shape[-1])
    return torch.unique(rows, dim=0).shape[0] == rows.shape[0]
