"""Synthetic LM token stream and per-worker batches (counterpart of the
token part of `repro/data/pipeline.py`).

The numpy draws are the JAX package's, call for call, so the same seed and
Generator give the same tokens and the same batch sequence; `LMBatcher`
returns torch tensors (int32, on the CPU) where the JAX version returns jax
arrays.  The classification data of the simulator is not ported yet
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_token_stream(num_workers: int, tokens_per_worker: int, *,
                      vocab_size: int, seed: int = 0) -> np.ndarray:
    """(W, tokens_per_worker) int32 bigram-structured synthetic tokens."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition: each token has 8 likely successors
    succ = rng.integers(0, vocab_size, size=(vocab_size, 8))
    out = np.zeros((num_workers, tokens_per_worker), np.int32)
    state = rng.integers(0, vocab_size, size=num_workers)
    for t in range(tokens_per_worker):
        jump = rng.random(num_workers) < 0.1
        nxt = succ[state, rng.integers(0, 8, size=num_workers)]
        state = np.where(jump, rng.integers(0, vocab_size, size=num_workers), nxt)
        out[:, t] = state
    return out


@dataclasses.dataclass
class LMBatcher:
    """Per-worker LM batches: inputs (W, B, S) and next-token labels.

    The DATA CURSOR of a run is the numpy Generator that drives `sample`;
    `rng_state` / `rng_from_state` serialize it, and `skip` fast-forwards
    it without building batches (idle slots still consume their draw).
    """
    stream: np.ndarray           # (W, T)
    seq_len: int
    batch_size: int              # per worker

    def sample(self, rng: np.random.Generator) -> dict:
        w, t = self.stream.shape
        starts = rng.integers(0, t - self.seq_len - 1,
                              size=(w, self.batch_size))
        idx = starts[..., None] + np.arange(self.seq_len + 1)
        seqs = np.take_along_axis(self.stream[:, None, :],
                                  idx.reshape(w, -1)[:, None, :], axis=2)
        seqs = seqs.reshape(w, self.batch_size, self.seq_len + 1)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(seqs[..., :-1])),
                "labels": torch.from_numpy(np.ascontiguousarray(seqs[..., 1:]))}

    def skip(self, rng: np.random.Generator, n: int) -> None:
        """Advance the data cursor exactly as ``n`` calls of `sample`."""
        w, t = self.stream.shape
        for _ in range(n):
            rng.integers(0, t - self.seq_len - 1, size=(w, self.batch_size))


def rng_state(rng: np.random.Generator) -> dict:
    """JSON-able snapshot of a Generator's position (the data cursor a
    full-protocol checkpoint records)."""
    return rng.bit_generator.state


def rng_from_state(state: dict) -> np.random.Generator:
    """Rebuild a Generator at the exact position `rng_state` captured."""
    bit_gen = getattr(np.random, state["bit_generator"])()
    bit_gen.state = state
    return np.random.Generator(bit_gen)
