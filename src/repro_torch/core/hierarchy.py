"""Multi-level network description: workers, sub-networks, V/Z operators
(copy of `repro/core/hierarchy.py`, numpy only).

This module materialises the paper's matrix formulation (Section 5):

  V : N x N block-diagonal, block d has identical rows? NO -- columns:
      V_{i,j} = v^(i) when d(i) == d(j) else 0          (sub-network averaging)
  Z : Z_{i,j} = H_{d(i),d(j)} * v^(i)                   (hub + subnet averaging)
  T_k = Z        if k % (q*tau) == 0
        V        if k % tau == 0 and k % (q*tau) != 0
        I        otherwise

Worker update (Eq. 5):  X_{k+1} = (X_k - eta G_k) T_k, with the columns of X
being worker models.  a_i = w_i / w_tot; u_k = X_k a is the weighted average.

These dense matrices power the *simulator* and the property tests; the
production path realises V/Z through the mixing strategies (see protocol.py).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.topology import HubNetwork


@dataclasses.dataclass(frozen=True)
class MultiLevelNetwork:
    """Two-level network: D sub-networks (hub + workers) over a hub graph."""
    hub_net: HubNetwork
    workers_per_subnet: tuple[int, ...]       # N^(d) for each sub-network d
    worker_weights: np.ndarray                # w^(i), global worker order
    worker_rates: np.ndarray                  # p_i in (0, 1]
    subnet_of: np.ndarray                     # d(i) for each worker i

    # ---------------------------------------------------------------- builders
    @staticmethod
    def build(topology: str,
              workers_per_subnet: Sequence[int],
              *,
              worker_weights: Sequence[float] | None = None,
              worker_rates: Sequence[float] | None = None,
              seed: int = 0) -> "MultiLevelNetwork":
        counts = tuple(int(c) for c in workers_per_subnet)
        n = sum(counts)
        d = len(counts)
        w = (np.ones(n) if worker_weights is None
             else np.asarray(worker_weights, dtype=np.float64))
        p = (np.ones(n) if worker_rates is None
             else np.asarray(worker_rates, dtype=np.float64))
        if w.shape != (n,) or p.shape != (n,):
            raise ValueError("worker_weights / worker_rates must have one entry per worker")
        if not np.all((p > 0) & (p <= 1)):
            raise ValueError("worker rates must be in (0, 1]")
        if not np.all(w > 0):
            raise ValueError("worker weights must be positive")
        subnet_of = np.repeat(np.arange(d), counts)
        # hub weight b_d = subnet weight mass / total (Assumption 2 pairing)
        b = np.array([w[subnet_of == dd].sum() for dd in range(d)]) / w.sum()
        hub_net = HubNetwork.build(topology, d, b, seed=seed)
        return MultiLevelNetwork(hub_net, counts, w, p, subnet_of)

    # ------------------------------------------------------------- properties
    @property
    def num_workers(self) -> int:
        return int(self.worker_weights.shape[0])

    @property
    def num_subnets(self) -> int:
        return len(self.workers_per_subnet)

    @property
    def a(self) -> np.ndarray:
        """Global normalized worker weights a_i = w_i / w_tot (Eq. 8)."""
        return self.worker_weights / self.worker_weights.sum()

    @property
    def v(self) -> np.ndarray:
        """Within-subnet normalized weights v^(i)."""
        w = self.worker_weights
        denom = np.array([w[self.subnet_of == self.subnet_of[i]].sum()
                          for i in range(self.num_workers)])
        return w / denom

    @property
    def avg_rate(self) -> float:
        """P = sum_i a_i p_i (Theorem 1)."""
        return float(np.dot(self.a, self.worker_rates))

    # ---------------------------------------------------------------- matrices
    def v_matrix(self) -> np.ndarray:
        """N x N sub-network averaging operator (block diagonal)."""
        n = self.num_workers
        v = self.v
        same = self.subnet_of[:, None] == self.subnet_of[None, :]
        return np.where(same, v[:, None], 0.0)

    def z_matrix(self) -> np.ndarray:
        """N x N joint subnet + hub averaging operator: Z_ij = H_{d(i),d(j)} v_i."""
        h = self.hub_net.h
        v = self.v
        return h[self.subnet_of[:, None], self.subnet_of[None, :]] * v[:, None]

    def t_matrix(self, k: int, tau: int, q: int) -> np.ndarray:
        """T_k per Eq. (6). `k` is 1-based as in the paper; averaging fires
        *after* the k-th gradient application, i.e. on k % tau == 0."""
        if k % (q * tau) == 0:
            return self.z_matrix()
        if k % tau == 0:
            return self.v_matrix()
        return np.eye(self.num_workers)

    @property
    def zeta(self) -> float:
        return self.hub_net.zeta


@dataclasses.dataclass(frozen=True)
class MLLSchedule:
    """The (tau, q) schedule. Phase of global step k (1-based, paper indexing):
       - "hub"    every q*tau steps  (apply Z)
       - "subnet" every tau steps otherwise (apply V)
       - "local"  otherwise (apply I)
    """
    tau: int = 8
    q: int = 4

    def __post_init__(self):
        if self.tau < 1 or self.q < 1:
            raise ValueError("tau and q must be >= 1")

    def phase(self, k: int) -> str:
        if k % (self.q * self.tau) == 0:
            return "hub"
        if k % self.tau == 0:
            return "subnet"
        return "local"

    @property
    def hub_period(self) -> int:
        return self.tau * self.q

    def comm_steps_per_period(self) -> tuple[int, int]:
        """(#subnet-averaging steps, #hub-averaging steps) per hub period."""
        return self.q - 1, 1
