"""The port's sLSTM scan against the JAX package's, on the CPU: the plain
versions of K7 (`ref.slstm_scan_ref`, `ref.slstm_scan_fwd_res_ref`) and K8
(`ref.slstm_scan_bwd_ref`), and the `ops.slstm_scan` autograd Function,
against the Pallas kernels in interpret mode and `jax.grad`.

Inputs are made from a seed with numpy and handed to both packages.
Shapes follow `tests/test_kernels.py`: T not a chunk multiple, B not a
block multiple, T < chunk, hd 16 and 32, H = 1; then hd 512 and hd 200 at
small T, widths the CUDA kernels split unevenly across a cluster, so that
the plain versions the card holds them to are themselves held to JAX.

Tolerances (float32 on both sides; the two frameworks sum the hd-term
recurrent products, and the backward's dR / db sums, in other orders):
* forward h and the four chunk-boundary states: atol 1e-5, rtol 1e-5;
* backward dzx, dR, db: atol 2e-5, rtol 2e-4 (the JAX package's own
  kernel-vs-reference tolerance); bf16 zx: atol 2e-2, rtol 2e-2 (outputs
  rounded to bf16 in other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import slstm_scan as js
from repro_torch.kernels import ops, ref
from repro_torch.kernels import slstm_scan as ss

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# (b, t, h, hd, block_b, chunk)
CASES = [(2, 21, 2, 16, 8, 8),      # T not a chunk multiple
         (3, 17, 1, 32, 2, 32),     # B not a block multiple, T < chunk, H 1
         (8, 64, 4, 16, 4, 16),
         (5, 40, 2, 16, 3, 16),     # 2 padded rows in the last block
         (2, 6, 1, 512, 2, 4),      # hd 512, the kernels' widest
         (3, 7, 2, 200, 4, 4)]      # a ragged hd (no power-of-two split)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, h, hd, seed=0):
    """R scaled 0.3 up to hd 32 and as 1 / sqrt(hd) beyond, so h R has
    the same spread at every width (as the model's init scales it)."""
    rng = np.random.default_rng(seed + b * t + hd)
    zx = (0.5 * rng.standard_normal((b, t, h, 4 * hd))).astype(np.float32)
    r = (min(0.3, 1.7 / hd ** 0.5)
         * rng.standard_normal((h, hd, 4 * hd))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((h, 4 * hd))).astype(np.float32)
    dh = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    return zx, r, bias, dh


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,t,h,hd,bb,chunk", CASES)
def test_slstm_scan_ref_matches_jax_ref(b, t, h, hd, bb, chunk):
    zx, r, bias, _ = _inputs(b, t, h, hd)
    got = ref.slstm_scan_ref(*_t(zx, r, bias))
    want = jref.slstm_scan_ref(*_j(zx, r, bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("b,t,h,hd,bb,chunk", CASES)
def test_fwd_res_matches_jax_interpret(b, t, h, hd, bb, chunk):
    """h and the four chunk-entering states, padded-batch layout included,
    against the TPU kernel in interpret mode (through the port's wrapper,
    which runs the plain version on CPU tensors)."""
    zx, r, bias, _ = _inputs(b, t, h, hd)
    got_h, got_b = ops.slstm_scan_fwd_res(*_t(zx, r, bias), block_b=bb,
                                          chunk=chunk)
    want_h, want_b = js.slstm_scan_fwd_res(*_j(zx, r, bias), block_b=bb,
                                           chunk=chunk, interpret=True)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **FWD_TOL)
    for name, g, w in zip("hcnm", got_b, want_b):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **FWD_TOL)


@pytest.mark.parametrize("b,t,h,hd,bb,chunk", CASES)
def test_bwd_ref_matches_jax_interpret(b, t, h, hd, bb, chunk):
    """K8's plain version against the TPU backward in interpret mode, each
    from its own package's forward residuals."""
    zx, r, bias, dh = _inputs(b, t, h, hd)
    tz, tr, tb, tdh = _t(zx, r, bias, dh)
    _, tbounds = ref.slstm_scan_fwd_res_ref(tz, tr, tb, block_b=bb,
                                            chunk=chunk)
    got = ref.slstm_scan_bwd_ref(tz, tr, tb, tbounds, tdh, block_b=bb,
                                 chunk=chunk)
    jz, jr, jb, jdh = _j(zx, r, bias, dh)
    _, jbounds = js.slstm_scan_fwd_res(jz, jr, jb, block_b=bb, chunk=chunk,
                                       interpret=True)
    want = js.slstm_scan_bwd(jz, jr, jb, jbounds, jdh, block_b=bb,
                             chunk=chunk, interpret=True)
    for name, g, w in zip(("dzx", "dR", "db"), got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("b,t,h,hd,bb,chunk", CASES)
def test_bwd_ref_matches_autograd_of_ref(b, t, h, hd, bb, chunk):
    """The hand-derived VJP against torch autograd through the plain
    recurrence (ties of the max do not occur with these inputs)."""
    zx, r, bias, dh = _inputs(b, t, h, hd)
    tz, tr, tb, tdh = _t(zx, r, bias, dh)
    leaves = [x.clone().requires_grad_() for x in (tz, tr, tb)]
    out = ref.slstm_scan_ref(*leaves)
    want = torch.autograd.grad((out * tdh).sum(), leaves)
    _, bounds = ref.slstm_scan_fwd_res_ref(tz, tr, tb, block_b=bb,
                                           chunk=chunk)
    got = ref.slstm_scan_bwd_ref(tz, tr, tb, bounds, tdh, block_b=bb,
                                 chunk=chunk)
    for name, g, w in zip(("dzx", "dR", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("b,t,h,hd,bb,chunk,dtype", [
    (2, 21, 2, 16, 8, 8, np.float32),
    (3, 17, 1, 32, 2, 32, np.float32),
    (2, 24, 2, 16, 2, 8, "bfloat16"),
])
def test_autograd_function_matches_jax_grad(b, t, h, hd, bb, chunk, dtype):
    """dzx, dR and db of `ops.slstm_scan` (forward with residuals, backward
    from them) against `jax.grad` through the JAX package's custom VJP
    (Pallas forward and backward, interpret mode), for one loss."""
    zx, r, bias, w = _inputs(b, t, h, hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jz = jnp.asarray(zx).astype(jdt)

    def jloss(z_, r_, b_):
        out = jops.slstm_scan(z_, r_, b_, block_b=bb, chunk=chunk)
        return (out.astype(jnp.float32) * jnp.asarray(w)).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(jz, jnp.asarray(r),
                                               jnp.asarray(bias))
    leaves = [torch.tensor(zx).to(tdt).requires_grad_(),
              torch.tensor(r).requires_grad_(),
              torch.tensor(bias).requires_grad_()]
    ops.reset_launches()
    out = ops.slstm_scan(*leaves, block_b=bb, chunk=chunk)
    got = torch.autograd.grad((out.float() * torch.tensor(w)).sum(), leaves)
    assert ops.slstm_scan.launches == ops.slstm_scan_bwd.launches == 0
    tol = BF16_TOL if dtype == "bfloat16" else BWD_TOL
    for name, g, x, wv in zip(("dzx", "dR", "db"), got, leaves, want):
        assert g.dtype == x.dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wv, np.float32), err_msg=name,
                                   **tol)


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    """No gradient to record: the plain recurrence, no residuals; a CPU
    tensor never counts a launch; the residual half refuses a tensor that
    wants a gradient."""
    zx, r, bias, _ = _inputs(2, 9, 2, 8)
    tz, tr, tb = _t(zx, r, bias)
    ops.reset_launches()
    with torch.no_grad():
        out = ops.slstm_scan(tz, tr, tb, block_b=2, chunk=4)
    torch.testing.assert_close(out, ref.slstm_scan_ref(tz, tr, tb),
                               atol=0, rtol=0)
    assert ops.slstm_scan.launches == 0
    with pytest.raises(ValueError, match="records no gradient"):
        ops.slstm_scan_fwd_res(tz.requires_grad_(), tr, tb)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernel launchers take CUDA tensors only; the plain backward
    refuses residuals of another block_b / chunk, as the TPU wrapper does."""
    zx, r, bias, dh = _inputs(2, 9, 2, 8)
    tz, tr, tb, tdh = _t(zx, r, bias, dh)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ss.slstm_scan(tz, tr, tb)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ss.slstm_scan_bwd(tz, tr, tb, (tz,) * 4, tdh)
    _, bounds = ref.slstm_scan_fwd_res_ref(tz, tr, tb, block_b=2, chunk=4)
    with pytest.raises(ValueError, match="same block_b/chunk"):
        ref.slstm_scan_bwd_ref(tz, tr, tb, bounds, tdh, block_b=2, chunk=8)


@pytest.mark.parametrize("b,t,bb,chunk", [(2, 21, 8, 8), (3, 17, 2, 32),
                                          (5, 40, 3, 16), (1, 1, 8, 128)])
def test_geometry_is_the_tpu_padding(b, t, bb, chunk):
    """(block_b, chunk, Bp, T/chunk) as `_fwd_call` pads: the bounds'
    shape of the JAX kernel."""
    got = ref.slstm_geometry(b, t, bb, chunk)
    jz = jnp.zeros((b, t, 1, 8), jnp.float32)
    _, bounds = js.slstm_scan_fwd_res(jz, jnp.zeros((1, 2, 8)),
                                      jnp.zeros((1, 8)), block_b=bb,
                                      chunk=chunk, interpret=True)
    assert got[2:] == bounds[0].shape[:2]
    assert got[:2] == (min(bb, b), min(chunk, t))


@pytest.mark.parametrize("hd,rows,limit,want", [
    (384, 4, 16, 16),   # xlstm-125m: 24 units a block
    (384, 8, 16, 16),
    (384, 4, 8, 8),     # a card without clusters of 16
    (128, 4, 16, 16),   # 8 units a block
    (512, 8, 16, 16),
    (200, 8, 16, 16),   # 13 units a block, the last 5
    (20, 4, 16, 2),     # 4 blocks would own 5 units, below MIN_UNITS
    (16, 8, 16, 2),
    (1, 1, 16, 1),
])
def test_choose_cluster(hd, rows, limit, want):
    """The largest cluster with at least `MIN_UNITS` units a block, no
    empty block, a thread for every (row, unit) pair, and one the card
    schedules; offered only the size it chose, it takes that size."""
    got = ss.choose_cluster(hd, rows, lambda cs: cs <= limit)
    assert got == want
    u = -(-hd // got)
    assert rows * u <= ss.THREADS and (got - 1) * u < hd
    assert u >= ss.MIN_UNITS or got == 1
    assert ss.choose_cluster(hd, rows, lambda cs: cs == got) == got


def test_choose_cluster_raises_where_nothing_fits():
    """hd 512 at 8 rows needs 8 blocks or more (a thread a pair): a card
    that schedules only single blocks gets an error, not another kernel."""
    with pytest.raises(ValueError, match="no cluster"):
        ss.choose_cluster(512, 8, lambda cs: cs == 1)
