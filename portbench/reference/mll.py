"""Plain reference of one MLL-SGD tick (the paper's Algorithm 1 in matrix
form), written from the paper and from the published definitions of the
random draws.  It imports nothing of the program under test.

  * the Bernoulli gate of Eq. (3): theta_i = [U_i < p_i] with U the
    float32 uniform that ``jax.random.uniform(fold_in(PRNGKey(seed), k),
    (W,))`` gives (Threefry-2x32, 20 rounds, Salmon et al. 2011);
  * the phase of tick k: hub every q * tau ticks, sub-network every tau,
    local otherwise (Eq. 6);
  * V_ij = v_i [d(i) = d(j)] and Z_ij = H_{d(i) d(j)} v_i, with H the
    generalized Metropolis diffusion matrix of the hub graph;
  * the gated SGD update x_i <- x_i - eta theta_i g_i in the parameters'
    own dtype (each product rounded as the configuration's dtype rounds).
"""
from __future__ import annotations

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds over uint32 counter words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform(seed: int, step: int, n: int) -> np.ndarray:
    """float32 in [0, 1): the key (0, seed) folded with ``step``, then one
    32-bit word per element (y0 ^ y1 of the counter (0, i)), its top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    key = threefry2x32((0, seed & 0xFFFFFFFF), np.zeros(1, np.uint32),
                       np.array([step & 0xFFFFFFFF], np.uint32))
    key = (int(key[0][0]), int(key[1][0]))
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = (y0 ^ y1) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def gate(seed: int, step: int, rates) -> np.ndarray:
    """theta of tick ``step`` (1-based): 1.0 where the worker steps."""
    r = np.asarray(rates, np.float32)
    return (uniform(seed, step, r.shape[0]) < r).astype(np.float32)


def phase(step: int, tau: int, q: int) -> str:
    if step % (q * tau) == 0:
        return "hub"
    return "subnet" if step % tau == 0 else "local"


def hub_matrix(topology: str, num_hubs: int,
               hub_weights: np.ndarray) -> np.ndarray:
    """H for a ring or complete hub graph: S_ij = min(b_i, b_j) /
    (1 + max(deg_i, deg_j)) on the edges, H_ij = S_ij / b_j off the
    diagonal, the diagonal filling each column to 1."""
    d = num_hubs
    adj = np.zeros((d, d), bool)
    if topology == "ring":
        for i in range(d):
            adj[i, (i + 1) % d] = adj[(i + 1) % d, i] = i != (i + 1) % d
    elif topology == "complete":
        adj[:] = True
        np.fill_diagonal(adj, False)
    else:
        raise ValueError(f"no reference hub graph for {topology!r}")
    b = np.asarray(hub_weights, np.float64)
    b = b / b.sum()
    deg = adj.sum(axis=1)
    h = np.zeros((d, d))
    for i in range(d):
        for j in range(d):
            if adj[i, j]:
                h[i, j] = min(b[i], b[j]) / (1.0 + max(deg[i], deg[j])) / b[j]
    h[np.diag_indices(d)] = 1.0 - h.sum(axis=0)
    return h


def operators(network: dict) -> dict:
    """{"V", "Z"}: (W, W) float64 mixing matrices, columns mixing into a
    worker (new x_j = sum_i T_ij x_i), for uniform worker weights."""
    d, n = network["subnets"], network["workers_per_subnet"]
    w = d * n
    sub = np.repeat(np.arange(d), n)
    v = np.full(w, 1.0 / n)
    same = sub[:, None] == sub[None, :]
    h = hub_matrix(network["topology"], d, np.full(d, 1.0 / d))
    return {"V": np.where(same, v[:, None], 0.0),
            "Z": h[sub[:, None], sub[None, :]] * v[:, None]}


@torch.no_grad()
def sgd_update(x: torch.Tensor, g: torch.Tensor, eta: float,
               theta: float) -> torch.Tensor:
    """x - eta theta g in x's dtype: g rounded to it, the product rounded,
    the difference rounded."""
    eta_x = torch.tensor(eta, dtype=x.dtype).item()
    step = (eta_x * theta) * g.to(x.dtype)
    return x - step


@torch.no_grad()
def mix(rows: list[torch.Tensor], t: np.ndarray) -> list[torch.Tensor]:
    """new x_j = sum_i T_ij x_i, summed in float32 and rounded once to the
    rows' dtype."""
    out = []
    for j in range(len(rows)):
        acc = None
        for i, x in enumerate(rows):
            if t[i, j] == 0.0:
                continue
            term = float(t[i, j]) * x.float()
            acc = term if acc is None else acc + term
        out.append(acc.to(rows[j].dtype))
    return out
