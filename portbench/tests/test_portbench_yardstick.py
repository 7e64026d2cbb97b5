"""The yardstick's formulas at known shapes, and against the program's
bounds they were copied from."""
from __future__ import annotations

import pytest
import torch

from portbench import yardstick
from repro_torch.kernels import ops


def test_live_pairs_causal():
    assert yardstick.live_pairs(4, 4, 0, True) == 10
    assert yardstick.live_pairs(4, 4, 2, True) == 7
    assert yardstick.live_pairs(3, 5, 0, False) == 15


def test_attention_at_the_training_shape():
    q, k = (2, 2048, 16, 128), (2, 2048, 8, 128)
    flops, nbytes = yardstick.attention_fwd_work(q, k, "bfloat16", True, 0)
    pairs = 2048 * 2049 // 2
    assert flops == 4 * 128 * 16 * 2 * pairs
    assert nbytes == 2 * (2 * 2 * 2048 * 16 * 128 + 2 * 2 * 2048 * 8 * 128) \
        + 4 * 2 * 16 * 2048
    # 1.1e11 FLOP: compute-bound, 0.111 ms at 989 TFLOP/s
    assert yardstick.least_seconds(flops, nbytes, "bfloat16") == \
        pytest.approx(flops / 989e12)
    bf, _ = yardstick.attention_bwd_work(q, k, "bfloat16", True, 0)
    assert bf == 2.5 * flops


@pytest.mark.parametrize("shape", [((2, 64, 4, 16), (2, 64, 2, 16)),
                                   ((1, 100, 8, 80), (1, 100, 8, 80))])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_attention_equals_the_programs_bound(shape, causal, window):
    q = torch.empty(shape[0], dtype=torch.bfloat16, device="meta")
    k = torch.empty(shape[1], dtype=torch.bfloat16, device="meta")
    assert yardstick.attention_fwd_work(shape[0], shape[1], "bfloat16",
                                        causal, window) == \
        ops.attention_fwd_work(q, k, causal=causal, window=window)
    assert yardstick.attention_bwd_work(shape[0], shape[1], "bfloat16",
                                        causal, window) == \
        ops.attention_bwd_work(q, k, causal=causal, window=window)


def test_train_flops_and_mfu():
    # 6 N T + 12 width pairs: qwen3-1.7b (tied), 2 x 2048 tokens
    n, width = 1_720_574_976, 28 * 16 * 128
    f = yardstick.train_flops(n, 2048, 2, width)
    assert f == 6 * n * 4096 + 12 * width * (2048 * 2049 // 2) * 2
    mfu = importlib_reader("step.mfu")
    rec = {"window": {"seconds": 2.0, "slots": 10}, "flops_per_slot": f}
    assert mfu.read(rec) == pytest.approx(100 * 10 * f / (2.0 * 989e12))


def importlib_reader(name):
    from portbench import cells
    return cells.metric_reader(name)
