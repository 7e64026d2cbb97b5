"""On the card: the benchmark command end to end, and the control at the
cell's size.  Skips without a CUDA card (decided inside each test).

    python3 -m pytest -q portbench/tests -m cuda      # on the GPU machine
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import cells


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_the_card(trace):
    _need_card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3-1.7b.w4.train", "--seed", "2718281828", "--seconds", "3",
         "--trace", str(trace)], cwd=cells.ROOT, capture_output=True,
        text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"


def test_without_the_card_no_result(tmp_path):
    """A run that finds fewer cards than its cell asks for prints no
    result and exits non-zero."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3-1.7b.w4.train", "--seed", "1", "--seconds", "1"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr
