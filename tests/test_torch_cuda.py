"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here is marked ``cuda`` and skips (visibly) where
`torch.cuda.is_available()` is False, as on a CPU-only test machine.  The
file imports no JAX, so it also runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: both sides compute in float32 from the same inputs, so float32
outputs differ by summation order only (atol 1e-4); bf16 outputs may round
to neighbouring bf16 values (one bf16 ulp is 2^-7 relative; atol 2e-2 for
|o| <= 2).  lse is float32 on both sides (atol 1e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _paged(seed, lengths, hkv, group, hd, bs, nmax):
    """Random pools and a shuffled block table."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    nb = b * nmax + 3
    q = rng.standard_normal((b, hkv * group, hd), np.float32)
    kp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    vp = rng.standard_normal((nb, bs, hkv, hd), np.float32)
    tables = rng.permutation(nb)[:b * nmax].reshape(b, nmax).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips (visibly) where there is none.  The
    check runs here, at test time, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


GPU_FWD_CASES = [
    # (h, hkv, hd, window, softcap, dtype)
    (16, 8, 128, 0, 0.0, torch.bfloat16),
    (14, 2, 64, 64, 0.0, torch.float32),
    (4, 4, 64, 0, 30.0, torch.bfloat16),
]


def _gpu_tol(dtype):
    return dict(atol=2e-2, rtol=0) if dtype == torch.bfloat16 else \
        dict(atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,hd,window,softcap,dtype", GPU_FWD_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, h, hkv, hd, window,
                                            softcap, dtype):
    g = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn(2, 200, h, hd, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, 200, hkv, hd, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, 200, hkv, hd, generator=g, device=cuda_device).to(dtype)
    before = ops.flash_attention.launches
    o, lse = ops.flash_attention_fwd_res(q, k, v, window=window,
                                         softcap=softcap)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, window=window,
                                                   softcap=softcap)
    torch.testing.assert_close(o.float(), want_o.float(), **_gpu_tol(dtype))
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("group,hd,bs,window,softcap,dtype", [
    (2, 128, 8, 0, 0.0, torch.bfloat16), (7, 64, 32, 40, 0.0, torch.float32),
    (8, 64, 16, 0, 30.0, torch.bfloat16), (1, 128, 16, 0, 0.0, torch.float32)])
def test_cuda_flash_decode_matches_plain(cuda_device, group, hd, bs, window,
                                         softcap, dtype):
    args = _paged(3, [0, 1, 17, 300], 2, group, hd, bs, -(-301 // bs))
    q, kp, vp, tables, lens = [torch.from_numpy(a).to(cuda_device)
                               for a in args]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = ops.flash_decode.launches
    out = ops.flash_decode(q, kp, vp, tables, lens, window=window,
                           softcap=softcap)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want = ref.flash_decode_ref(q, kp, vp, tables, lens, window=window,
                                softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), **_gpu_tol(dtype))
    assert (out[0] == 0).all()
