"""Data pipelines (counterpart of `repro/data/pipeline.py`).

Two synthetic sources, both deterministic given a seed:

* ``ClassificationData`` -- mixture-of-Gaussians classification,
  IID-partitioned across workers as the paper assumes; the simulator's
  paper-figure task.
* the LM token stream (`make_token_stream`, `LMBatcher`) -- a Markov bigram
  stream sharded per worker, for the transformer trainer.

The numpy draws are the JAX package's, call for call, so the same seed and
Generator give the same data and the same batch sequence; the port returns
torch tensors (on the CPU) where the JAX version returns jax arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ------------------------------------------------------- classification data
@dataclasses.dataclass
class ClassificationData:
    worker_x: torch.Tensor     # (W, per_worker, dim) float32
    worker_y: torch.Tensor     # (W, per_worker) int32
    test_x: torch.Tensor
    test_y: torch.Tensor
    num_classes: int

    @property
    def full(self) -> dict:
        return {"x": self.worker_x.reshape(-1, self.worker_x.shape[-1]),
                "y": self.worker_y.reshape(-1)}

    @property
    def test(self) -> dict:
        return {"x": self.test_x, "y": self.test_y}

    def worker_data(self) -> dict:
        return {"x": self.worker_x, "y": self.worker_y}


def make_classification(num_workers: int, per_worker: int, *, dim: int = 32,
                        num_classes: int = 10, test_size: int = 2000,
                        noise: float = 1.2, seed: int = 0,
                        shares: np.ndarray | None = None) -> ClassificationData:
    """Gaussian-mixture classification.  ``shares`` optionally gives each
    worker a different fraction of the data (the paper's 5/10/20/25/40%
    groups) -- sampling stays IID, only the per-worker sample count varies;
    worker weights should then be set proportional to dataset size."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(num_classes, dim)) * 2.0

    def draw(n):
        y = rng.integers(0, num_classes, size=n)
        x = means[y] + noise * rng.normal(size=(n, dim))
        return x.astype(np.float32), y.astype(np.int32)

    if shares is None:
        counts = np.full(num_workers, per_worker)
    else:
        shares = np.asarray(shares, np.float64)
        counts = np.maximum(8, (shares / shares.sum() * per_worker * num_workers)
                            .astype(int))
    maxc = int(counts.max())
    wx = np.zeros((num_workers, maxc, dim), np.float32)
    wy = np.zeros((num_workers, maxc), np.int32)
    for w in range(num_workers):
        x, y = draw(int(counts[w]))
        # pad by resampling (keeps shapes rectangular; IID so harmless)
        reps = int(np.ceil(maxc / len(y)))
        wx[w] = np.tile(x, (reps, 1))[:maxc]
        wy[w] = np.tile(y, reps)[:maxc]
    tx, ty = draw(test_size)
    return ClassificationData(*(torch.from_numpy(a) for a in (wx, wy, tx, ty)),
                              num_classes)


# ------------------------------------------------------------- token stream

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
