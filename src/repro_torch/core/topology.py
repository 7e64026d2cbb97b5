"""Hub-network topologies and generalized diffusion matrices (copy of
`repro/core/topology.py`, numpy only; the port keeps its own copy so that it
imports nothing of the JAX package).

The hub network G = (C, E) is an undirected, connected graph over the D hubs.
The mixing matrix H must satisfy Assumption 2 of the paper:

  2a  H_{i,j} > 0 iff (i,j) in E (or i == j), else 0
  2b  H is column stochastic:  sum_i H_{i,j} = 1
  2c  weighted reversibility:  H_{i,j} b_j = H_{j,i} b_i
      (this is the form the paper's appendix actually uses, Eq. (32); the
      main-text statement "b_i H_{i,j} = b_j H_{j,i}" has the indices
      transposed — only the Eq. (32) form is consistent with H b = b.)

where b_d = (sum of worker weights in sub-network d) / w_tot.  Such an H is a
"Generalized Diffusion Matrix" (Rotaru & Naegeli 2004): it has a simple
eigenvalue 1 with right eigenvector b and left eigenvector 1_D, and all other
eigenvalues strictly inside the unit circle when G is connected.

zeta = max(|lambda_2|, |lambda_D|) is the paper's topology constant.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

_TOPOLOGIES = ("complete", "ring", "path", "star", "torus2d", "erdos")


def adjacency(topology: str, num_hubs: int, *, seed: int = 0,
              erdos_p: float = 0.5) -> np.ndarray:
    """Boolean adjacency matrix (no self loops) for a named topology."""
    d = num_hubs
    a = np.zeros((d, d), dtype=bool)
    if d == 1:
        return a
    if topology == "complete":
        a[:] = True
        np.fill_diagonal(a, False)
    elif topology == "ring":
        for i in range(d):
            a[i, (i + 1) % d] = a[(i + 1) % d, i] = True
    elif topology == "path":
        for i in range(d - 1):
            a[i, i + 1] = a[i + 1, i] = True
    elif topology == "star":
        a[0, 1:] = a[1:, 0] = True
    elif topology == "torus2d":
        side = int(round(np.sqrt(d)))
        if side * side != d:
            raise ValueError(f"torus2d needs a square hub count, got {d}")
        for r in range(side):
            for c in range(side):
                i = r * side + c
                for j in (r * side + (c + 1) % side, ((r + 1) % side) * side + c):
                    if i != j:
                        a[i, j] = a[j, i] = True
    elif topology == "erdos":
        rng = np.random.default_rng(seed)
        while True:
            a[:] = False
            for i in range(d):
                for j in range(i + 1, d):
                    if rng.random() < erdos_p:
                        a[i, j] = a[j, i] = True
            if is_connected(a):
                break
    else:
        raise ValueError(f"unknown topology {topology!r}; choose from {_TOPOLOGIES}")
    return a


def is_connected(adj: np.ndarray) -> bool:
    d = adj.shape[0]
    if d == 1:
        return True
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in np.nonzero(adj[i])[0]:
            if j not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == d


def diffusion_matrix(adj: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Build H satisfying Assumption 2 for hub weights b (b > 0, sum(b) = 1).

    Construction (generalized Metropolis–Hastings): pick a symmetric flow
    matrix S (S_{ij} = S_{ji} >= 0, zero off-graph) with column sums < b, then

      H_{i,j} = S_{i,j} / b_j          (i != j)
      H_{j,j} = 1 - sum_{i!=j} H_{i,j}

    Then H_{i,j} b_j = S_{ij} = S_{ji} = H_{j,i} b_i (2c/Eq. 32), columns sum
    to 1 (2b), entries are nonneg with positive diagonal, and H b = b since
    the effective symmetric S (diagonal included) has row sums exactly b.

    We choose S_{ij} = min(b_i, b_j) / (1 + max(deg_i, deg_j)) which guarantees
    sum_{i != j} S_{ij} < b_j for every j, keeping diagonals positive.
    """
    d = adj.shape[0]
    b = np.asarray(b, dtype=np.float64)
    if b.shape != (d,):
        raise ValueError("b must have one entry per hub")
    if not np.all(b > 0):
        raise ValueError("hub weights must be positive")
    b = b / b.sum()
    if d == 1:
        return np.ones((1, 1))
    deg = adj.sum(axis=1)
    s = np.zeros((d, d))
    for i in range(d):
        for j in range(i + 1, d):
            if adj[i, j]:
                s[i, j] = s[j, i] = min(b[i], b[j]) / (1.0 + max(deg[i], deg[j]))
    h = s / b[None, :]           # H_{i,j} = S_{ij} / b_j for i != j
    np.fill_diagonal(h, 0.0)
    h[np.diag_indices(d)] = 1.0 - h.sum(axis=0)
    return h


def zeta(h: np.ndarray) -> float:
    """max(|lambda_2|, |lambda_D|): second-largest eigenvalue magnitude of H."""
    eig = np.linalg.eigvals(h)
    mags = np.sort(np.abs(eig))[::-1]
    if len(mags) == 1:
        return 0.0
    return float(mags[1])


def gamma(z: float) -> float:
    """The paper's Gamma constant (Thm. 1, eq. 186 form)."""
    if z >= 1.0:
        return float("inf")
    return 1.0 / (1.0 - z ** 2) + 2.0 / (1.0 - z) + z / (1.0 - z) ** 2


@dataclasses.dataclass(frozen=True)
class HubNetwork:
    """Immutable description of the level-2 (hub) network."""
    topology: str
    num_hubs: int
    adj: np.ndarray
    h: np.ndarray          # D x D generalized diffusion matrix (col-stochastic)
    b: np.ndarray          # hub weights (right eigenvector of H)
    zeta: float

    @staticmethod
    def build(topology: str, num_hubs: int, hub_weights: Sequence[float] | None = None,
              *, seed: int = 0) -> "HubNetwork":
        adj = adjacency(topology, num_hubs, seed=seed)
        if num_hubs > 1 and not is_connected(adj):
            raise ValueError("hub graph must be connected")
        b = (np.ones(num_hubs) / num_hubs if hub_weights is None
             else np.asarray(hub_weights, dtype=np.float64))
        b = b / b.sum()
        h = diffusion_matrix(adj, b)
        return HubNetwork(topology, num_hubs, adj, h, b, zeta(h))

    def neighbors(self, d: int) -> np.ndarray:
        nbr = np.nonzero(self.adj[d])[0]
        return nbr
