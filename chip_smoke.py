#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU: build, check, serve, train and
simulate.

    python3 chip_smoke.py            # from the repository root

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- requires CUDA; prints the card, its power limit, torch and CUDA
   versions; turns TF32 off for every float32 product.
2. build   -- nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a, one
   process per source, into ``build/repro_torch/``; ptxas' registers and
   spilled bytes per kernel.
3. kernels -- each hand-written kernel against its plain PyTorch version on
   the card, bf16 (K3 and K4 on the tensor cores, K6 on `mma.sync`) and
   float32 (on the CUDA cores), at the qwen3-1.7b (H 16 / Hkv 8 / hd 128),
   qwen2-0.5b (H 14 / Hkv 2 / hd 64), chatglm3-6b (H 32 / Hkv 2 / hd 128,
   GQA group 16) and stablelm-3b (H 32 / Hkv 32 / hd 80) geometries, with
   window and softcap cases; kernel time (mean, median, min-max), host
   time, plain time and SDPA's under each backend that runs (the fastest is
   the library yardstick) beside the card's bound; K6's device kernels per
   call (one) and its bits on two runs.
4. serve   -- `ServeEngine` on qwen3-1.7b at full width (28 layers, bf16,
   seeded random weights) serves 8 Poisson requests through 4 lanes with
   the kernels (``impl="flash"``); the launch counters show every prefill
   went through the flash-attention kernel, in bf16 on the tensor cores,
   and every decode tick through the paged flash-decode kernel, 28
   launches each.
5. parity  -- two served requests teacher-forced through ``impl="flash"``
   and ``impl="plain"`` on the same block tables: logits at every generated
   position agree within the bf16 tolerance.
5b. serve-group16 -- `ServeEngine` on chatglm3-6b at full width (28
   layers, bf16, seeded random weights, GQA group 16) serves 4 requests
   through 4 lanes with the kernels, 28 K6 launches a decode tick; one
   request teacher-forced through ``impl="flash"`` and ``impl="plain"``
   within phase 5's limits.
6. train-kernels -- the flash-attention backward (K4) against its plain
   version in bf16 and float32, at the training path's geometry, head_dim
   64, 80 and 128, with GQA groups up to 16, a window and a softcap, each
   output held to its own scale; two runs of K4 on the same inputs give the
   same bits; its delta kernel timed alone.
7. train   -- `launch.train.run_training` trains qwen3-1.7b at full width
   (28 layers, bf16, seeded random weights) as W = 4 workers (2 subnets x
   2 on a ring hub graph, rates 1.0/0.8/1.0/0.6), two_stage mixing, the
   deadline policy, tau = q = 2, 8 slots of 4 x 128 tokens per worker,
   through K3 forward and K4 backward; the launch counters show 28 K4
   launches per worker and slot, all bf16 on the tensor cores.  One more
   slot runs under the profiler (the hand-written kernels' device time).
8. train-parity -- one worker's gradients on one batch, ``impl="flash"``
   against ``impl="plain"``, at full width: per-leaf relative error.
9. uk-serve -- the trained u_k served in memory by `ServeEngine`.
10. resume -- at the smoke config (a full-width full-state checkpoint is
   ~30 GB on disk): killed at slot 4 and resumed = the uninterrupted run,
   bit for bit; `ServeEngine.from_checkpoint` serves that directory.
10b. train-ladder -- `run_training` trains qwen2-0.5b at full width (24
   layers, d_model 896, 14 / 2 heads of 64, tied, bf16, seeded random
   weights) as W = 4 (2 x 2 on a ring, rates 1.0/0.8/1.0/0.6, sgd eta
   0.05, tau 1, q 2: two_stage subnet rounds, a hub round every second
   slot), 4 slots of 4 x 128 tokens, through K3 and K4, once uncompressed
   (two_stage, the yardstick) and once per compressed rung (int8, int8_ef,
   int4_ef, bf16, topk_ef, powersgd): seconds per slot, each hub round's
   synchronised ms, peak memory, `wire_bytes` against the two_stage f32
   wire, u_k loss.  Per rung: (a) one hub round of the trained K
   projections (one JAX leaf over 24 super-blocks) and an all-ones norm
   (the top-k tie case), on the card against the CPU within
   `tolerance.LADDER_TOL`; (b) a consensus fleet stays within the rung's
   bound after one hub round; (c) a stateful rung's state is nonzero after
   its first hub round and goes through a checkpoint bit for bit; (d) a
   finite loss.
10c. train-overlap -- qwen3-1.7b with phase 7's settings for 4 slots,
   ``overlap="none"`` and ``"chunked"`` (4 chunks): the two u_k within one
   bf16 ulp of the mixing's operands, the chunked peak memory at most two
   chunk slabs above the unchunked, the event slots' seconds.
10d. train-mesh -- qwen2-0.5b at full width, W = 4 (2 x 2, ring), tau 2,
   q 2, 4 slots (slot 2 a subnet event, slot 4 a hub event) through K3 +
   K4, under two_stage, ppermute, bf16 and dense: one process on the card,
   then mesh (4, 1) -- four gloo ranks sharing the card, one worker each,
   started by `launch.mesh.spawn` -- whose fleet rows and u_k must be the
   one-process bits; seconds per local and event slot, each event's
   collectives as host staging and gloo transfer, each rank's peak memory,
   K3 / K4 launches summed over the ranks (gloo on one card, not NCCL).
11. xlstm-kernels -- the sLSTM scan forward K7 (h and the four
   chunk-entering states) and backward K8 (dzx, dR, db, from K7's states)
   against their plain versions, each output held to its own scale, at
   xlstm-125m's training shape (B 4, T 512, H 4, hd 384, float32), the
   smoke geometry (hd 128), ragged B and T, T < chunk, hd 16 and 32, H 1,
   bf16 zx, hd 384 at 8 rows, hd 512 (R partly resident), hd 20 and 200;
   K8 twice gives the same bits; each case logs its cluster (blocks, rows
   of R resident in shared memory, bytes); times beside the bound at the
   training shape.
12. train-xlstm -- `run_training` trains xlstm-125m at full width (12
   layers as 6 x (mLSTM, sLSTM), d_model 768, 4 heads of 384, bf16 with
   float32 gate leaves, seeded random weights) with phase 7's W = 4 MLL
   settings for 8 slots of 4 x 512 tokens per worker, through K7 and K8;
   the launch counters show 6 K7 launches per worker and slot (and per
   evaluation) and 6 K8 launches per worker and slot.  One more slot runs
   under the profiler; the mLSTM layers and the LM head are timed apart.
13. xlstm-parity -- one worker's gradients, ``impl="flash"`` against
   ``impl="plain"``, at full width and depth with params and compute in
   float32, held to ten times tighter limits than phase 8's; one float32
   sLSTM layer at full width, flash against plain, to 1e-4.
14. sim-kernels -- the fused update + mix kernel (``csrc/hier_mix.cu``):
   K1a (one leaf), K1b (packed, dense), K2 (packed, grouped) and K5
   (chunked) against their plain versions, bit for bit, at awkward shapes,
   bf16 leaves and the paper's W = 100, then at the packed qwen2-0.5b
   fleet of phase 15 (W = 4, 494 M float32 columns); times beside the
   bound, the plain version and the unfused torch pair.
15. sim -- qwen2-0.5b at full width (24 layers, float32 params, bf16
   compute, seeded random weights) as W = 4 workers through
   `timeline.run_timeline`: (a) deadline + two_stage (K2), (b) barrier +
   dense (K1b), (c) gossip (K1b, masked operators), (d) = (a) with
   chunked overlap (K5, the same u bit for bit), (e) = (a) with
   kernel="xla", (f) (b)'s plan through the full scan, packed (K1b every
   slot) and per leaf (K1a), the same u as (b) bit for bit; the launch
   counts asserted from each plan; slot times, an event split into pack /
   kernel / unpack, the device busy share of an event slot.
16. sim-paper -- the paper's logistic regression at W = 100 in 10
   sub-networks through `simulate` (K1b) and `run_timeline` with two_stage
   mixing (K2 at D = 10), kernel="pallas" against kernel="xla".
16b. generate -- `serve_step.generate` on qwen3-1.7b at full width (28
   layers, bf16, seeded random weights): 4 prompts of 512 tokens, 64 new,
   a rotating dense cache of max_len 8,192 (3.5 GiB), greedy with the
   batched prefill and sampled (temperature 0.8); prefill ms, ms per
   decode step, tokens/s, peak memory, a profiled decode step.  Its dense
   logits against `ServeEngine`'s K3 + K6 path at phase 5's limits; in
   float32 at full width, batched = loop prefill (greedy tokens) and the
   dense logits against a teacher-forced `forward_train`.
16c. generate-xlstm -- xlstm-125m at full width, 4 prompts of 128 tokens,
   32 new (the per-token loop prefill); float32 decode against
   `forward_train` over 128 positions.
16d. generate-jamba -- jamba-v0.1-52b at full width cut to 8 layers (7
   mamba, 1 attention, 4 MoE of 16 experts; 13.3 B params, 26.6 GB in
   bf16): 2 prompts of 64 tokens, 16 new, ms per step beside the floor
   of reading every weight; decode against `forward_train` in bf16 (mean
   and argmax) and in float32 at full width (53 GB); the state changed.
16e. chunked -- one qwen3-1.7b attention (B 1, T 8,192, 16 / 8 heads of
   128, bf16): `_sdpa_chunked`, the plain `_sdpa`, K3 and SDPA agree and
   are timed; K3's measurement joins the report as a new shape.
   The generation paths launch no kernel (their attention is the plain
   path, as the JAX package's); each phase asserts it.
17. report -- K3 at the serve, training, sim and T = 8,192 shapes, K6 at the serve
   path's busiest decode tick and at one 4,096-token lane (with the splits
   chosen), K4 at the training shape; one ``{"kernels": [...]}`` JSON line,
   the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Without a GPU, or away from the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import interop  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import baselines, packing, prng, protocol  # noqa: E402
from repro_torch.core import timeline as ttl  # noqa: E402
from repro_torch.core.hierarchy import MultiLevelNetwork  # noqa: E402
from repro_torch.core.mllsgd import MLLConfig, build_state  # noqa: E402
from repro_torch.core.simulator import (SimConfig, init_sim_carry,  # noqa: E402
                                        replicate, simulate, to_device,
                                        weighted_average)
from repro_torch.data.pipeline import (make_classification,  # noqa: E402
                                       make_token_stream)
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hier_mix as hm  # noqa: E402
from repro_torch.kernels import slstm_scan as ss  # noqa: E402
from repro_torch.kernels.profiling import graph_nodes  # noqa: E402
from repro_torch.kernels.tolerance import (BWD_TOL, LSE_TOL, TOL,  # noqa: E402
                                           align_columns, ladder_error)
from repro_torch.launch import harness as harness_mod  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.train import (TrainLoopConfig, fleet_digests,  # noqa: E402
                                      run_training, train_rank)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.serve import kv_cache as kvc  # noqa: E402
from repro_torch.serve import serve_step  # noqa: E402
from repro_torch.serve.engine import (PROMPT_PAD, EngineConfig,  # noqa: E402
                                      ServeEngine, poisson_arrivals)
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.train_step import loss_fn as train_loss_fn  # noqa: E402
from repro_torch.train.train_step import per_worker_grads  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel call
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# served logits, flash vs plain path, after 28 bf16 layers (phase 5): the
# two paths round attention to bf16 at other places, a noise of ~1% of the
# logits; a wrong kernel (head, position, mask) moves them by ~100%.  With
# 151936 random-weight logits the top two often lie closer than that noise,
# so argmax agreement is reported with a floor that only catches garbage.
MAX_REL, MEAN_REL, MIN_ARGMAX_AGREEMENT = 0.25, 0.05, 0.5
GEOMETRIES = {"qwen3-1.7b": (16, 8, 128), "qwen2-0.5b": (14, 2, 64),
              "chatglm3-6b": (32, 2, 128), "stablelm-3b": (32, 32, 80)}
MASKING = [(0, 0.0), (256, 0.0), (0, 30.0)]          # (window, softcap)
DECODE_LENGTHS = [0, 1, 17, 255, 1000, 2048, 4096, 4097]
# the yardstick of K3 / K4: SDPA under each backend it has
SDPA_BACKENDS = (("flash", SDPBackend.FLASH_ATTENTION),
                 ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                 ("cudnn", SDPBackend.CUDNN_ATTENTION),
                 ("math", SDPBackend.MATH))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
class Timer:
    """Device time of a call, each launch after a write of 128 MiB so it
    starts with a cold 50 MB L2, as the real caller finds it.  A spin of
    the device (``torch.cuda._sleep``) between the flush and the start
    event holds the stream while the host enqueues the call, so the time
    is the device's alone: without it, a call whose host side (Python,
    checks, allocations, several launches) outlasts the flush would add its
    host time to the device's.  The host's cost is `host_ms`."""

    SPIN_CYCLES = 10_000_000      # ~5 ms at the H100's 1.98 GHz boost clock

    def __init__(self, device: torch.device):
        self.flush = torch.empty(32 * 2**20, dtype=torch.float32,
                                 device=device)

    def stats(self, fn, reps: int = 10) -> dict:
        """-> {"mean", "median", "min", "max"} ms over ``reps`` launches."""
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in pairs]
        return {"mean": sum(ms) / reps, "median": float(np.median(ms)),
                "min": min(ms), "max": max(ms)}

    def ms(self, fn, reps: int = 10) -> float:
        return self.stats(fn, reps)["mean"]


def host_ms(fn, reps: int = 50) -> float:
    """Host time of one call: ``reps`` calls back to back on the host
    clock, before the device is waited for (what the call costs the host
    that enqueues it, which the timed ``ms`` includes where it exceeds the
    device's queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def sdpa_backends(timer: Timer, fn) -> dict:
    """``fn`` (one SDPA call, forward or backward) timed under each backend
    that `sdpa_kernel` accepts for its inputs -> {backend: stats}."""
    out = {}
    for name, backend in SDPA_BACKENDS:
        with sdpa_kernel(backend):
            try:
                fn()
                torch.cuda.synchronize()
            except (RuntimeError, ValueError):   # refuses these inputs
                continue
            out[name] = timer.stats(fn)
    return out


def _library(backends: dict) -> dict:
    """The fastest backend by mean as the yardstick."""
    if not backends:
        return {"library_ms": None, "library_backend": None,
                "library_backends": {}}
    best = min(backends, key=lambda k: backends[k]["mean"])
    return {"library_ms": backends[best]["mean"], "library_backend": best,
            "library_backends": backends}


def _bound(bytes_: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _close(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """Max abs error; raises when any element is outside atol + rtol*|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"max abs err {err.max().item():.3e} beyond "
                             f"{tol} at {int(bad.sum())} elements")
    return err.max().item()


TC_LAUNCHES: dict[str, dict] = {}   # path -> bf16 K3 / K4 launches


def check_tensor_cores(path: str) -> None:
    """Every K3 / K4 launch since the last reset was bf16, so ran on the
    tensor-core kernels (the wrappers' ``tc_launches``): no main path may
    reach the CUDA-core instantiations."""
    got = {}
    for fn in (ops.flash_attention, ops.flash_attention_bwd):
        if fn.tc_launches != fn.launches:
            raise AssertionError(
                f"{path}: {fn.launches - fn.tc_launches} of {fn.launches} "
                f"{fn.__name__} launches were not bf16 (tensor cores)")
        got[fn.__name__] = fn.tc_launches
    TC_LAUNCHES[path] = got


def ptxas_report(log_text: str) -> dict:
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} from
    ``ptxas -v`` output."""
    out, name = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"\d+((?:flash|group)\w*?kernel)I(f|13__nv_bfloat16)?"
                          r"((?:Li\d+E)+)E", mangled)  # kernel<[type, ]head_dim>
            if m:
                args = re.findall(r"Li(\d+)E", m.group(3))
                args += {"f": ["f32"], None: []}.get(m.group(2), ["bf16"])
                name = f"{m.group(1)}<{', '.join(args)}>"
            else:
                name = mangled[:60]
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out.setdefault(name, {})["spill_bytes"] = nums[1] + nums[2]
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(
                line.split("Used")[1].split("registers")[0])
    return out


# ---------------------------------------------------------- K3 measurement
def fwd_live_pairs(t: int, s: int, window: int) -> int:
    """(query, key) pairs that causal + window masking leaves live."""
    i = np.arange(t)
    hi = np.minimum(i, s - 1) + 1
    lo = np.maximum(0, i - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo).sum())


def measure_fwd(timer: Timer, q, k, v, window: int, softcap: float,
                causal: bool = True) -> dict:
    """K3 against its plain version on (q, k, v): error, device time with
    its spread, host time, bound, and SDPA under each backend that runs."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = ops.flash_attention_fwd_res(q, k, v, **kw)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    err = max(_close(o, want_o, TOL[q.dtype]),
              _close(lse, want_lse, LSE_TOL))
    b, t, h, hd = q.shape
    es = q.element_size()
    bytes_ = es * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    live = (fwd_live_pairs(t, k.shape[1], window) if causal
            else t * k.shape[1])
    bound_ms, bound_by = _bound(bytes_, 4 * hd * h * b * live, q.dtype)
    backends = {}
    if softcap == 0.0:     # SDPA has no softcap; GQA expanded outside the call
        group = h // k.shape[2]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(group, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(group, dim=2).transpose(1, 2)
        mask = None
        if window > 0:
            qp = torch.arange(t, device=q.device)[:, None]
            kp = torch.arange(k.shape[1], device=q.device)[None, :]
            mask = (qp - kp < window) & ((kp <= qp) if causal else True)
        backends = sdpa_backends(timer, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None))

    def call():
        return ops.flash_attention_fwd_res(q, k, v, **kw)
    run = timer.stats(call)
    return {"max_abs_err": err, "tolerance": TOL[q.dtype],
            "ms": run["mean"], "ms_spread": run, "host_ms": host_ms(call),
            "plain_ms": timer.ms(lambda: ref.flash_attention_fwd_ref(
                q, k, v, **kw)),
            "bound_ms": bound_ms, "bound_by": bound_by, **_library(backends)}


# ---------------------------------------------------------- K6 measurement
def measure_decode(timer: Timer, q, k_pool, v_pool, tables, lengths,
                   window: int, softcap: float) -> dict:
    """K6 against its plain version: error, exact zeros for dead lanes, the
    same bits on two runs, one device kernel per call, the splits chosen,
    times (device, host), bound and SDPA over the gathered dense view."""
    def call():
        return ops.flash_decode(q, k_pool, v_pool, tables, lengths,
                                window=window, softcap=softcap)
    out, again = call(), call()
    want = ref.flash_decode_ref(q, k_pool, v_pool, tables, lengths,
                                window=window, softcap=softcap)
    err = _close(out, want, TOL[q.dtype])
    if not torch.equal(out, again):
        raise AssertionError("K6 gave other bits on a second run")
    dead = lengths == 0
    if dead.any() and (out[dead] != 0).any():
        raise AssertionError("a lane of length 0 is not exactly zero")
    nodes = graph_nodes(call)
    if nodes != ["kernel"]:
        raise AssertionError(f"a K6 call enqueued {nodes} on the device, not "
                             f"one kernel")
    b, h, hd = q.shape
    hkv = k_pool.shape[2]
    lens = lengths.long().cpu()
    live = int((lens.clamp(max=window) if window > 0 else lens).sum())
    es = q.element_size()
    bytes_ = (es * (2 * live * hkv * hd + 2 * q.numel())
              + 4 * (tables.numel() + lengths.numel()))
    bound_ms, bound_by = _bound(bytes_, 4 * hd * h * live, q.dtype)
    library_ms = None
    if softcap == 0.0:     # SDPA over the gathered dense view
        group = h // hkv
        kd = kvc.gather_kv(k_pool, tables).repeat_interleave(group, 2)
        vd = kvc.gather_kv(v_pool, tables).repeat_interleave(group, 2)
        kpos = torch.arange(kd.shape[1], device=q.device)[None, :]
        lq = lengths.long()[:, None]
        mask = kpos < lq
        if window > 0:
            mask &= lq - 1 - kpos < window
        qt, kt, vt = q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
        mask = mask[:, None, None, :]
        library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
    run = timer.stats(call)
    return {"max_abs_err": err, "tolerance": TOL[q.dtype],
            "same_bits": True, "launches_per_call": len(nodes),
            "splits": fa.decode_splits(q, k_pool, tables),
            "ms": run["mean"], "ms_spread": run, "host_ms": host_ms(call),
            "plain_ms": timer.ms(lambda: ref.flash_decode_ref(
                q, k_pool, v_pool, tables, lengths, window=window,
                softcap=softcap)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def decode_case(gen: torch.Generator, h: int, hkv: int, hd: int,
                dtype: torch.dtype, bs: int = 16):
    """8 lanes of DECODE_LENGTHS over a pool with a shuffled block table;
    padded table entries point at block 0."""
    device = gen.device
    nmax = -(-max(DECODE_LENGTHS) // bs)
    need = [-(-n // bs) for n in DECODE_LENGTHS]
    nb = sum(need) + 16
    perm = torch.randperm(nb, generator=gen, device=device).int()
    tables = torch.zeros((len(need), nmax), dtype=torch.int32, device=device)
    used = 0
    for lane, n in enumerate(need):
        tables[lane, :n] = perm[used:used + n]
        used += n
    q = torch.randn(len(need), h, hd, generator=gen, device=device).to(dtype)
    kp = torch.randn(nb, bs, hkv, hd, generator=gen, device=device).to(dtype)
    vp = torch.randn(nb, bs, hkv, hd, generator=gen, device=device).to(dtype)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=device)
    return q, kp, vp, tables, lengths


def phase_kernels(timer: Timer, device: torch.device) -> None:
    gen = torch.Generator(device).manual_seed(0)
    for geom, (h, hkv, hd) in GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{geom} {str(dtype).replace('torch.', '')}"
            q = torch.randn(4, 1000, h, hd, generator=gen, device=device).to(dtype)
            k = torch.randn(4, 1000, hkv, hd, generator=gen, device=device).to(dtype)
            v = torch.randn(4, 1000, hkv, hd, generator=gen, device=device).to(dtype)
            dec = decode_case(gen, h, hkv, hd, dtype)
            for window, softcap in MASKING:
                case = f"{name} window={window} softcap={softcap}"
                r = measure_fwd(timer, q, k, v, window, softcap)
                log("kernels", f"K3 flash_attention B=4 T=S=1000 {case}: "
                    f"{json.dumps(r)}")
                r = measure_decode(timer, *dec, window, softcap)
                log("kernels", f"K6 flash_decode lanes={DECODE_LENGTHS} bs=16 "
                    f"{case}: {json.dumps(r)}")


# ---------------------------------------------------------------- serving
class Recorder:
    """Keeps the inputs the main path hands the kernels: the largest
    prefill call, and layer 0's decode calls (chosen after the run by the
    largest total context).  It wraps the launches, below the counting
    wrappers in `ops`, so the launch counts are untouched."""

    def __init__(self, layer0_pool: torch.Tensor):
        self.layer0 = layer0_pool.data_ptr()
        self.fwd = None
        self.decode = []
        self._fwd, self._decode = fa.flash_attention_fwd_res, fa.flash_decode_paged

    def __enter__(self):
        def fwd(q, k, v, **kw):
            if self.fwd is None or q.numel() > self.fwd[0].numel():
                self.fwd = (q, k, v, kw)
            return self._fwd(q, k, v, **kw)

        def decode(q, k_pool, v_pool, tables, lengths, **kw):
            if k_pool.data_ptr() == self.layer0:
                self.decode.append((q, k_pool, v_pool, tables, lengths, kw))
            return self._decode(q, k_pool, v_pool, tables, lengths, **kw)
        fa.flash_attention_fwd_res, fa.flash_decode_paged = fwd, decode
        return self

    def __exit__(self, *exc):
        fa.flash_attention_fwd_res, fa.flash_decode_paged = self._fwd, self._decode

    def busiest_decode(self):
        return max(self.decode, key=lambda c: int(c[4].sum()))


def phase_serve(cfg, device: torch.device, smi: str):
    gen = torch.Generator(device).manual_seed(0)
    t0 = time.perf_counter()
    params = model_mod.init_model(gen, cfg, device=device)
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {model_mod.count_params(params) / 1e9:.3f} B "
        f"params ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_dtype}) initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(64, 513)))
               .astype(np.int32) for _ in range(8)]
    max_new, max_len, bs = 32, 512 + 32, 16
    ecfg = EngineConfig(max_batch=4, block_size=bs, max_len=max_len,
                        num_blocks=len(prompts) * (-(-max_len // bs)),
                        impl="flash")
    # warm-up (cuBLAS handles, kernel libraries): not counted or timed
    ServeEngine(params, cfg, ecfg, device=device).run(
        poisson_arrivals(prompts[:2], max_new=2, seed=1))

    eng = ServeEngine(params, cfg, ecfg, device=device)
    reqs = poisson_arrivals(prompts, max_new=max_new, rate=0.5, seed=0)
    with Recorder(eng.state[0]["pos0"]["k_pool"]) as rec:
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launches()
        out = eng.run(reqs)
        launches = {"flash_attention": ops.flash_attention.launches,
                    "flash_decode": ops.flash_decode.launches}
    trace = eng.trace()
    n_prefill = sum(e["kind"] == "prefill" for e in trace["events"])
    n_decode = sum(b > 0 for b in trace["busy_slots"]) - n_prefill
    log("serve", f"{len(out['outputs'])} requests, {out['generated']} tokens, "
        f"{out['slots']} slots: {n_prefill} prefill batches, {n_decode} "
        f"decode ticks; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    if len(out["outputs"]) != len(prompts):
        raise AssertionError("not every request finished")
    for r in reqs:
        toks = out["outputs"][r.rid]
        if (len(toks) != len(r.prompt) + max_new
                or toks[:len(r.prompt)] != list(r.prompt)):
            raise AssertionError(f"request {r.rid}: wrong length or prefix")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {r.rid}: token out of the vocabulary")
    if eng.alloc.available != ecfg.num_blocks:
        raise AssertionError("blocks leaked")
    want = {"flash_attention": cfg.num_layers * n_prefill,
            "flash_decode": cfg.num_layers * n_decode}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launches {launches}, expected {want}")
    check_tensor_cores("serve")
    lat = np.array([r["latency_s"] for r in out["records"]])
    ttft = np.array([r["ttft_s"] for r in out["records"]])
    log("serve", f"{out['generated'] / out['wall_s']} tokens/s, TTFT p50 "
        f"{np.percentile(ttft, 50)} s, latency p50 {np.percentile(lat, 50)} s "
        f"p99 {np.percentile(lat, 99)} s, wall {out['wall_s']} s on {smi}")
    return params, reqs, out, launches, rec


# ---------------------------------------------------------------- profile
def phase_profile(cfg, params, device: torch.device, smi: str) -> None:
    """Where a decode tick's time goes: 4 full lanes at ~300-token contexts,
    host wall clock per tick without the profiler, then `torch.profiler`
    over as many further ticks for the device's busy time, operations and
    host syncs."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=300).astype(np.int32)
               for _ in range(4)]
    eng = ServeEngine(params, cfg, EngineConfig(
        max_batch=4, block_size=16, max_len=512, num_blocks=4 * 32,
        impl="flash"), device=device)
    eng.submit(poisson_arrivals(prompts, max_new=32, rate=1e3, seed=0))
    for _ in range(3):                       # prefill, then warm decode ticks
        eng.step()
    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    device_us: dict[str, float] = {}
    host_syncs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us[e.name] = device_us.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif e.name == "cudaStreamSynchronize":
            host_syncs += 1
    n_ops = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_ms = sum(device_us.values()) / 1e3 / n
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:4]
    if set(eng.trace()["busy_slots"][-2 * n:]) != {4}:
        raise AssertionError("profiled ticks were not all 4-lane decode ticks")
    log("profile", f"decode tick, 4 lanes at ~300 tokens: wall {wall_ms} ms "
        f"(no profiler); device busy {busy_ms} ms ({100 * busy_ms / wall_ms}% "
        f"of the wall), {n_ops / n} device operations and {host_syncs / n} "
        f"host syncs per tick; top device time per tick: "
        + "; ".join(f"{name[:60]} {us / 1e3 / n} ms" for name, us in top)
        + f" on {smi}")


# ---------------------------------------------------------------- parity
@torch.inference_mode()
def teacher_forced_logits(params, cfg, prompts, generated, impl: str,
                          device: torch.device, bs: int = 16) -> torch.Tensor:
    """Logits at every generated position of the given token sequences:
    one batched prefill, then paged decode steps fed the generated tokens.
    -> (lanes, n_generated, vocab) float32."""
    plens = np.array([len(p) for p in prompts], np.int32)
    n_new = len(generated[0])
    nmax = -(-(int(plens.max()) + n_new) // bs)
    state = model_mod.init_paged_state(cfg, len(prompts) * nmax, bs, device)
    tables = torch.arange(len(prompts) * nmax, dtype=torch.int32,
                          device=device).reshape(len(prompts), nmax)
    s = int(-(-plens.max() // PROMPT_PAD) * PROMPT_PAD)
    toks = np.zeros((len(prompts), s), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    plens_t = torch.from_numpy(plens).to(device)
    logits, kvs = model_mod.prefill_forward(
        params, {"tokens": torch.from_numpy(toks).to(device)}, cfg, impl=impl)
    for layer_state, layer_kv in zip(state, kvs):
        for name, pools in layer_state.items():
            kvc.write_prefill_kv(pools["k_pool"], pools["v_pool"],
                                 *layer_kv[name], tables, plens_t)
    rows = torch.arange(len(prompts), device=device)
    steps = [logits[rows, plens_t.long() - 1].float()]
    for j in range(n_new - 1):
        tok = torch.tensor([[g[j]] for g in generated], device=device)
        lengths = torch.from_numpy(plens + j + 1).to(device)
        logits, state = model_mod.paged_decode_step(
            params, state, {"tokens": tok}, tables, lengths, cfg, impl=impl)
        steps.append(logits[:, 0].float())
    return torch.stack(steps, dim=1)


def phase_parity(cfg, params, pick, out, device: torch.device, *,
                 phase: str = "parity") -> None:
    """The served requests ``pick`` teacher-forced through both paths."""
    prompts = [r.prompt for r in pick]
    generated = [out["outputs"][r.rid][len(r.prompt):] for r in pick]
    flash = teacher_forced_logits(params, cfg, prompts, generated, "flash",
                                  device)
    plain = teacher_forced_logits(params, cfg, prompts, generated, "plain",
                                  device)
    served = torch.tensor(generated, device=device)
    diff = (flash - plain).abs()
    agree_paths = (flash.argmax(-1) == plain.argmax(-1)).float().mean().item()
    agree_served = (flash.argmax(-1) == served).float().mean().item()
    scale_max, scale_mean = plain.abs().max().item(), plain.abs().mean().item()
    log(phase, f"{cfg.name}: requests {[r.rid for r in pick]} "
        f"(prompts {[len(p) for p in prompts]}), {served.shape[1]} positions "
        f"each: flash vs plain logits max abs {diff.max().item()} (tolerance "
        f"{MAX_REL} x max |logit| {scale_max}), mean abs {diff.mean().item()} "
        f"(tolerance {MEAN_REL} x mean |logit| {scale_mean}); argmax "
        f"agreement flash/plain {agree_paths}, flash/served {agree_served} "
        f"(floor {MIN_ARGMAX_AGREEMENT})")
    if (not torch.isfinite(flash).all()
            or diff.max().item() > MAX_REL * scale_max
            or diff.mean().item() > MEAN_REL * scale_mean):
        raise AssertionError("flash and plain logits disagree")
    if min(agree_paths, agree_served) < MIN_ARGMAX_AGREEMENT:
        raise AssertionError("argmax agreement below the floor")


def phase_serve_group16(device: torch.device, smi: str) -> dict:
    """chatglm3-6b (32 query heads over 2 kv heads: a GQA group of 16) at
    full width served through K3 and K6, then its longest request
    teacher-forced through both paths."""
    cfg = get_config("chatglm3-6b")
    t0 = time.perf_counter()
    params = model_mod.init_model(torch.Generator(device).manual_seed(4),
                                  cfg, device=device)
    torch.cuda.synchronize()
    log("serve-group16", f"{cfg.name}: {model_mod.count_params(params) / 1e9} "
        f"B params ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.param_dtype}) initialised in {time.perf_counter() - t0} s")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(64, 257)))
               .astype(np.int32) for _ in range(4)]
    max_new, bs = 16, 16
    max_len = 256 + max_new
    ecfg = EngineConfig(max_batch=4, block_size=bs, max_len=max_len,
                        num_blocks=len(prompts) * (-(-max_len // bs)),
                        impl="flash")
    eng = ServeEngine(params, cfg, ecfg, device=device)
    reqs = poisson_arrivals(prompts, max_new=max_new, rate=0.5, seed=0)
    ops.reset_launches()
    out = eng.run(reqs)
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_decode": ops.flash_decode.launches}
    trace = eng.trace()
    n_prefill = sum(e["kind"] == "prefill" for e in trace["events"])
    n_decode = sum(b > 0 for b in trace["busy_slots"]) - n_prefill
    log("serve-group16", f"{len(out['outputs'])} requests, {out['generated']}"
        f" tokens, {n_prefill} prefill batches, {n_decode} decode ticks in "
        f"{out['wall_s']} s; launches {launches} on {smi}")
    ok = len(out["outputs"]) == len(prompts) and all(
        len(out["outputs"][r.rid]) == len(r.prompt) + max_new
        and all(0 <= t < cfg.vocab_size for t in out["outputs"][r.rid])
        for r in reqs)
    want = {"flash_attention": cfg.num_layers * n_prefill,
            "flash_decode": cfg.num_layers * n_decode}
    if not ok or launches != want or min(launches.values()) == 0:
        raise AssertionError(f"serving {cfg.name}: outputs complete {ok}, "
                             f"launches {launches}, expected {want}")
    check_tensor_cores("serve-group16")
    longest = max(reqs, key=lambda r: len(r.prompt))
    phase_parity(cfg, params, [longest], out, device, phase="serve-group16")
    return launches


# ------------------------------------------------------ K4 measurement
# (b, t, s, h, hkv, hd, causal, window, softcap) for the K4 checks: the
# training path's geometry, head dims 64, 80 (stablelm-3b, padded to 128)
# and 128, GQA groups 2, 7 and 16 (chatglm3-6b), window, softcap,
# T % 64 != 0, T != S
BWD_CASES = [(4, 128, 128, 16, 8, 128, True, 0, 0.0),
             (2, 512, 512, 16, 8, 128, True, 0, 0.0),
             (2, 300, 300, 14, 2, 64, True, 100, 0.0),
             (2, 200, 200, 8, 4, 128, True, 0, 30.0),
             (2, 190, 260, 4, 2, 64, False, 0, 0.0),
             (2, 256, 256, 32, 2, 128, True, 0, 0.0),
             (2, 200, 200, 32, 32, 80, True, 0, 0.0)]


def _close_scaled(got: torch.Tensor, want: torch.Tensor, tol: dict
                  ) -> tuple[float, float]:
    """(max abs error, relative norm error) of one output held to its own
    scale; raises beyond `BWD_TOL` or when ``want`` is all zeros (a check
    that a kernel returning zeros would pass)."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    if not scale > 0 or not torch.isfinite(got).all():
        raise AssertionError(f"degenerate check: max|want| {scale}, got "
                             f"finite {bool(torch.isfinite(got).all())}")
    err = (got - want).abs()
    rel = ((got - want).norm() / want.norm()).item()
    bad = err > tol["atol_of_max"] * scale + tol["rtol"] * want.abs()
    if bad.any() or rel > tol["rel_norm"]:
        raise AssertionError(f"max abs err {err.max().item():.3e} (max|want| "
                             f"{scale:.3e}), relative norm error {rel:.3e} "
                             f"beyond {tol} at {int(bad.sum())} elements")
    return err.max().item(), rel


def measure_bwd(timer: Timer, q, k, v, o, lse, do, causal: bool, window: int,
                softcap: float) -> dict:
    """K4 against its plain version on the forward's own (o, lse): error,
    bit-for-bit determinism over two runs, times, bound."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K4 gave other bits on a second run")
    errs = [_close_scaled(g, w, BWD_TOL[q.dtype]) for g, w in zip(got, want)]
    b, t, h, hd = q.shape
    es = q.element_size()
    # q, o, do, k, v and lse read once; dq, dk, dv written once
    bytes_ = es * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    # five products of hd per live pair: s, dp, dq, dk, dv
    flops = 10 * hd * h * b * (fwd_live_pairs(t, k.shape[1], window)
                               if causal else t * k.shape[1])
    bound_ms, bound_by = _bound(bytes_, flops, q.dtype)
    backends = {}
    if softcap == 0.0 and window == 0:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        for name, backend in SDPA_BACKENDS:
            with sdpa_kernel(backend):
                try:    # the graph is recorded under this backend
                    out = F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)
                    torch.autograd.grad(out, (qt, kt, vt), dot,
                                        retain_graph=True)
                    torch.cuda.synchronize()
                except (RuntimeError, ValueError):   # refuses these inputs
                    continue
                backends[name] = timer.stats(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True))

    def call():
        return ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)

    def delta():
        return fa.flash_attention_delta(o, do)
    delta_err = _close(delta(), ref.flash_attention_delta_ref(o, do),
                       dict(atol=1e-4, rtol=1e-5))
    run = timer.stats(call)
    return {"max_abs_err": max(e for e, _ in errs),
            "rel_err": max(r for _, r in errs),
            "max_abs_out": [w.abs().max().item() for w in want],
            "tolerance": BWD_TOL[q.dtype], "deterministic": True,
            "ms": run["mean"], "ms_spread": run, "host_ms": host_ms(call),
            # the delta kernel alone (the K4 call launches it first)
            "delta_ms": timer.ms(delta), "delta_host_ms": host_ms(delta),
            "delta_max_abs_err": delta_err,
            "plain_ms": timer.ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, **kw)),
            "bound_ms": bound_ms, "bound_by": bound_by, **_library(backends)}


def phase_train_kernels(timer: Timer, device: torch.device) -> None:
    gen = torch.Generator(device).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, s, h, hkv, hd, causal, window, softcap in BWD_CASES:
            def rnd(*shape):
                return torch.randn(*shape, generator=gen,
                                   device=device).to(dtype)
            q, k, v = rnd(b, t, h, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
            do = rnd(b, t, h, hd)
            o, lse = ops.flash_attention_fwd_res(q, k, v, causal=causal,
                                                 window=window, softcap=softcap)
            r = measure_bwd(timer, q, k, v, o, lse, do, causal, window, softcap)
            log("train-kernels", f"K4 flash_attention_bwd {str(dtype)[6:]} "
                f"B={b} T={t} S={s} H={h} Hkv={hkv} hd={hd} causal={causal} "
                f"window={window} softcap={softcap}: {json.dumps(r)}")


# ---------------------------------------------------------------- training
class BwdRecorder:
    """Keeps the first K4 call of the main path (its inputs), below the
    counting wrapper, so the launch counts are untouched."""

    def __init__(self):
        self.call = None
        self._bwd = fa.flash_attention_bwd

    def __enter__(self):
        def bwd(q, k, v, o, lse, do, **kw):
            if self.call is None:
                self.call = (q, k, v, o, lse, do, kw)
            return self._bwd(q, k, v, o, lse, do, **kw)
        fa.flash_attention_bwd = bwd
        return self

    def __exit__(self, *exc):
        fa.flash_attention_bwd = self._bwd


class SlotClock:
    """Wall seconds of each harness slot (`mll_harness_step`), each between
    two device synchronisations."""

    def __init__(self):
        self.seconds = []
        self._step = harness_mod.mll_harness_step

    def __enter__(self):
        def step(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._step(*a, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out
        harness_mod.mll_harness_step = step
        return self

    def __exit__(self, *exc):
        harness_mod.mll_harness_step = self._step


TRAIN_MLL = dict(tau=2, q=2, eta=0.05, hub_topology="ring",
                 worker_rates=(1.0, 0.8, 1.0, 0.6), mixing="two_stage")


def _train_loop(**kw) -> TrainLoopConfig:
    return TrainLoopConfig(**dict(dict(
        steps=8, eval_every=4, seq_len=128, batch_per_worker=4,
        tokens_per_worker=8192, policy="deadline", rate_model="bernoulli",
        impl="flash"), **kw))


def _layers_of(cfg, kind: str) -> int:
    return cfg.num_super_blocks * cfg.pattern.count(kind)


def phase_train(cfg, device: torch.device, smi: str, *, phase: str = "train",
                seq_len: int = 128):
    mll = MLLConfig(**TRAIN_MLL)
    loop = _train_loop(seq_len=seq_len)
    logs = []
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    with BwdRecorder() as rec, SLSTMRecorder() as srec, SlotClock() as clock:
        out = run_training(cfg, mll, loop, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_attention_bwd": ops.flash_attention_bwd.launches,
                "flash_decode": ops.flash_decode.launches,
                "slstm_scan": ops.slstm_scan.launches,
                "slstm_scan_bwd": ops.slstm_scan_bwd.launches}
    for line in logs:
        log(phase, line)
    plan, hist = out["plan"], out["history"]
    w = out["network"].num_workers
    grad_slots = sum(1 for s in range(plan.slots) if not (
        plan.gate_mode == "forced" and not plan.active[s].any()))
    n_evals = len(hist["step"])
    n_attn, n_slstm = _layers_of(cfg, "attn"), _layers_of(cfg, "slstm")
    want = {"flash_attention": n_attn * (w * grad_slots + n_evals),
            "flash_attention_bwd": n_attn * w * grad_slots,
            "flash_decode": 0,
            "slstm_scan": n_slstm * (w * grad_slots + n_evals),
            "slstm_scan_bwd": n_slstm * w * grad_slots}
    if launches != want or sum(launches.values()) == 0:
        raise AssertionError(f"launches {launches}, expected {want}")
    check_tensor_cores(phase)
    if not np.isfinite(hist["avg_loss"]).all() or not np.isfinite(
            hist["loss"]).all():
        raise AssertionError(f"non-finite loss history {hist}")
    secs = clock.seconds
    seq_tokens = loop.batch_per_worker * loop.seq_len
    counts = out["train_state"].opt_state["counts"].tolist()
    steady = secs[1:]
    log(phase, f"plan {plan.gate_mode}: {len(plan.events)} events "
        f"{[(e.slot, e.kind) for e in plan.events]}; counts {counts}")
    log(phase, f"u_k loss {hist['avg_loss']} at slots {hist['step']}; "
        f"worker loss {hist['loss']}")
    # every worker computes its gradients each slot (W*B*S processed
    # tokens); only the gated-in ones apply them (sum(counts)*B*S applied)
    log(phase, f"seconds per slot {secs}; first slot {secs[0]} s, steady "
        f"mean {sum(steady) / len(steady)} s; processed tokens/s per harness "
        f"slot (W*B*S over the slot's wall) steady "
        f"{w * seq_tokens * len(steady) / sum(steady)}; applied tokens "
        f"{sum(counts) * seq_tokens} of {w * seq_tokens * len(secs)} "
        f"processed; applied tokens/s over the whole run_training wall "
        f"(data, evaluations, checkpoints included) "
        f"{sum(counts) * seq_tokens / wall}; "
        f"run_training wall {wall} s; peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30} GiB; launches "
        f"{launches} on {smi}")
    return out, mll, launches, rec, srec


def phase_train_profile(cfg, out, mll, device: torch.device, smi: str, *,
                        phase: str = "train", seq_len: int = 128):
    """Two more local slots of the trained fleet: the first timed on the
    host clock without the profiler, the second under `torch.profiler` for
    the device's busy time, the top device time and the sLSTM kernels'."""
    from torch.profiler import ProfilerActivity, profile
    st = build_state(mll, out["network"], device=device)
    h = harness_mod.TrainHarness(cfg, mll, st, gate_mode="bernoulli")
    tokens = torch.randint(1, cfg.vocab_size, (4, 4, seq_len + 1),
                           generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tokens[..., :-1].to(device),
             "labels": tokens[..., 1:].to(device)}
    state = out["train_state"]
    act = np.ones(4, np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = h.step(state, batch, act)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = h.step(state, batch, act)
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    device_us: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us[e.name] = device_us.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy_ms = sum(device_us.values()) / 1e3
    n_ops = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    kernel_ms = {k: sum(us for name, us in device_us.items() if k in name) / 1e3
                 for k in ("flash_fwd_tc_kernel", "flash_bwd_tc_kernel",
                           "group_sum_kernel",
                           "slstm_fwd_kernel", "slstm_bwd_kernel",
                           "slstm_dr_kernel")}
    log(phase, f"local slot (W=4 fwd+bwd+update, 4 x {seq_len} tokens per "
        f"worker): wall {wall_ms} ms (no profiler; {prof_ms} ms under it); "
        f"device busy {busy_ms} ms ({100 * busy_ms / wall_ms}% of the wall), "
        f"{n_ops} device operations; hand-written kernels {kernel_ms} ms; "
        f"top: "
        + "; ".join(f"{name[:50]} {us / 1e3} ms" for name, us in top)
        + f" on {smi}")
    return state


def _parity_batch(cfg, seq_len: int, device: torch.device) -> dict:
    tokens = torch.randint(1, cfg.vocab_size, (1, 4, seq_len + 1),
                           generator=torch.Generator().manual_seed(3))
    return {"tokens": tokens[..., :-1].to(device),
            "labels": tokens[..., 1:].to(device)}


def _worker_grads(cfg, worker0: dict, batch: dict, impl: str
                  ) -> tuple[list, list, float]:
    """-> (leaf names, gradient leaves, loss) of one worker on ``batch``."""
    grads, m = per_worker_grads(tree_map(lambda x: x[None], worker0), batch,
                                cfg, impl=impl)
    names, leaves = [], []

    def leaf(key, block, x):
        names.append(key if block is None else f"{key}[{block}]")
        leaves.append(x[0].float())
    interop.map_with_keys(leaf, grads)
    return names, leaves, m["loss"].item()


def _rel_errors(got: list, want: list) -> list:
    return [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
            for a, b in zip(got, want)]


def grad_parity(cfg, worker0: dict, device: torch.device, seq_len: int
                ) -> tuple[list, list, float, float]:
    """Gradients of one worker on one batch of 4 x ``seq_len`` tokens,
    flash vs plain.  -> (leaf names, relative norm error per leaf, flash
    loss, plain loss)."""
    batch = _parity_batch(cfg, seq_len, device)
    names, gf, lf = _worker_grads(cfg, worker0, batch, "flash")
    _, gp, lp = _worker_grads(cfg, worker0, batch, "plain")
    return names, _rel_errors(gf, gp), lf, lp


def phase_train_parity(cfg, worker0: dict, device: torch.device, *,
                       phase: str = "train-parity", seq_len: int = 128,
                       report: tuple[str, ...] = (),
                       limits: tuple[float, float] = (0.05, 0.25)) -> None:
    """Full-width gradients of one worker on one batch, flash vs plain,
    held to ``limits`` (the median and the largest relative error of a
    leaf) and a loss |diff| of 0.05; the leaves whose key holds a name in
    ``report`` are printed apart."""
    names, rel, lf, lp = grad_parity(cfg, worker0, device, seq_len)
    loss_diff = abs(lf - lp)
    order = np.argsort(rel)[::-1]
    log(phase, f"{cfg.name} ({cfg.num_layers} layers, {cfg.compute_dtype}), "
        f"one worker, 4 x {seq_len} tokens: loss flash {lf} plain {lp} "
        f"(|diff| {loss_diff}); {len(rel)} leaves, relative grad error median "
        f"{float(np.median(rel))} max {max(rel)}; largest: " + ", ".join(
            f"{names[i]} {rel[i]:.4f}" for i in order[:4]))
    for key in report:
        log(phase, f"{key}: " + ", ".join(
            f"{n} {r:.3e}" for n, r in zip(names, rel) if key in n))
    if (not all(np.isfinite(rel)) or max(rel) > limits[1]
            or np.median(rel) > limits[0] or loss_diff > 0.05):
        raise AssertionError(
            f"flash and plain gradients disagree beyond rounding noise "
            f"(limits: median {limits[0]}, max {limits[1]}, loss 0.05)")


def phase_serve_uk(cfg, u_k: dict, device: torch.device) -> None:
    """The trained u_k (float32 average of the bf16 fleet) served in memory."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(32, 129)))
               .astype(np.int32) for _ in range(4)]
    ops.reset_launches()
    eng = ServeEngine(u_k, cfg, EngineConfig(max_batch=4, block_size=16,
                                            max_len=160, num_blocks=40,
                                            impl="flash"), device=device)
    res = eng.run(poisson_arrivals(prompts, max_new=8, rate=4.0, seed=0))
    ok = all(len(res["outputs"][i]) == len(p) + 8 and all(
        0 <= t < cfg.vocab_size for t in res["outputs"][i])
        for i, p in enumerate(prompts))
    log("uk-serve", f"u_k ({str(tree_leaves(u_k)[0].dtype)[6:]}) served "
        f"{len(res['outputs'])} requests, {res['generated']} tokens in "
        f"{res['wall_s']} s; launches K3 {ops.flash_attention.launches} K6 "
        f"{ops.flash_decode.launches}")
    if not ok or min(ops.flash_attention.launches,
                     ops.flash_decode.launches) == 0:
        raise AssertionError("serving the trained u_k failed")


def phase_resume(device: torch.device) -> None:
    cfg = get_smoke_config("qwen3-1.7b")
    mll = MLLConfig(**dict(TRAIN_MLL, inner_opt="momentum"))
    log("resume", f"at {cfg.name} (bf16): a full-width full-state checkpoint "
        "of W = 4 workers is ~30 GB on disk, so kill + resume runs at the "
        "smoke config")
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(seq_len=32, batch_per_worker=2, tokens_per_worker=2048,
                  checkpoint_every=4, policy="barrier",
                  rate_model="deterministic")
        full = run_training(cfg, mll, _train_loop(
            checkpoint_dir=f"{tmp}/a", **kw), log=lambda *a: None)
        run_training(cfg, mll, _train_loop(checkpoint_dir=f"{tmp}/b",
                                           stop_slot=4, **kw),
                     log=lambda *a: None)
        res = run_training(cfg, mll, _train_loop(checkpoint_dir=f"{tmp}/b",
                                                 resume=True, **kw),
                           log=lambda *a: None)
        la, lb = (tree_leaves(x["train_state"]) for x in (full, res))
        same = len(la) == len(lb) and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(la, lb))
        log("resume", f"killed at slot 4 + resumed vs uninterrupted: "
            f"{len(la)} state leaves, all equal bit for bit: {same}; u_k "
            f"loss {res['history']['avg_loss']} vs "
            f"{full['history']['avg_loss'][-1:]}")
        if not same or res["history"]["avg_loss"] != \
                full["history"]["avg_loss"][-1:]:
            raise AssertionError("resume is not the uninterrupted run")
        eng = ServeEngine.from_checkpoint(
            f"{tmp}/b", cfg, EngineConfig(max_batch=2, block_size=8,
                                          num_blocks=16, max_len=48),
            device=device)
        prompts = [np.arange(1, 9, dtype=np.int32),
                   np.arange(20, 33, dtype=np.int32)]
        out = eng.run(poisson_arrivals(prompts, max_new=6, seed=0))
        if sorted(out["outputs"]) != [0, 1]:
            raise AssertionError("from_checkpoint did not serve")
        log("resume", f"ServeEngine.from_checkpoint served {out['generated']}"
            f" tokens for {len(prompts)} requests")


# ------------------------------------------------------ K7 / K8 measurement
# (b, t, h, hd, block_b, chunk, zx dtype) for the K7 / K8 checks: the
# training path's shape (xlstm-125m: B 4, T 512, H 4, hd 384; 4 rows a
# cluster), the smoke geometry (hd 128), then B not a multiple of block_b,
# T not a multiple of chunk, T < chunk, hd 16 and 32, H = 1, 5 and 8 rows
# in a block, bf16 zx; hd 384 at 8 rows, hd 512 (R partly resident in
# shared memory) at 4 and 8 rows, hd 20 and 200 (no power-of-two cluster
# divides them: the last block owns fewer units), bf16 at 4 rows; 1 row at
# hd 90 and 2 rows at hd 45, where hd x rows is no multiple of 4 floats (the
# second h buffer must still start on 16 bytes), and hd 45 in bf16 at 1 row
SLSTM_CASES = [(4, 512, 4, 384, 8, 128, torch.float32),
               (4, 512, 4, 128, 8, 128, torch.float32),
               (3, 200, 2, 32, 2, 64, torch.float32),
               (2, 21, 1, 16, 8, 32, torch.float32),
               (8, 64, 4, 16, 8, 16, torch.float32),
               (5, 100, 4, 384, 8, 128, torch.bfloat16),
               (2, 24, 2, 16, 2, 8, torch.bfloat16),
               (8, 128, 2, 384, 8, 64, torch.float32),
               (4, 96, 2, 512, 4, 32, torch.float32),
               (8, 64, 1, 512, 8, 32, torch.float32),
               (3, 100, 2, 20, 4, 32, torch.float32),
               (5, 120, 2, 200, 8, 64, torch.float32),
               (4, 200, 4, 384, 4, 64, torch.bfloat16),
               (1, 64, 1, 90, 8, 32, torch.float32),
               (2, 50, 1, 45, 2, 16, torch.float32),
               (1, 40, 2, 45, 8, 16, torch.bfloat16)]
# h, the four bounds, dzx, dR and db, kernel vs plain, each held to its own
# scale as K4's outputs are (`_close_scaled`).  Both sides compute in
# float32 from the same inputs; they differ by the order of the hd- and
# 4hd-term recurrent sums, of the B*T-term dR / db sums, and by the last
# bits of expf / log1pf / tanhf, carried through up to 512 dependent steps:
# 1e-4.  An output in bf16 (h, dzx for a bf16 zx) adds one rounding (2^-9
# relative): 1e-2.  A wrong kernel (a gate zeroed, the max routing dropped,
# the chunks walked in the wrong order) moves every output by O(1).
SLSTM_TOL = BWD_TOL


def _close_state(got: torch.Tensor, want: torch.Tensor, tol: dict
                 ) -> tuple[float, float]:
    """`_close_scaled`, except that a state that is exactly zero (h, c and m
    entering the first chunk) must come back exactly zero."""
    if want.abs().max().item() == 0.0:
        if not torch.equal(got, want):
            raise AssertionError("a zero state came back non-zero")
        return 0.0, 0.0
    return _close_scaled(got, want, tol)


def measure_slstm(timer: Timer, zx, r, b, dh, block_b: int, chunk: int,
                  timed: bool) -> tuple[dict, dict]:
    """K7 (with residuals) and K8 against their plain versions on the same
    inputs (K8 from K7's bounds): errors, K8's bits over two runs, and with
    ``timed`` the kernel, plain and bound times."""
    kw = dict(block_b=block_b, chunk=chunk)
    f32 = SLSTM_TOL[torch.float32]
    tol = SLSTM_TOL[zx.dtype]
    h, bounds = ops.slstm_scan_fwd_res(zx, r, b, **kw)
    want_h, want_bounds = ref.slstm_scan_fwd_res_ref(zx, r, b, **kw)
    fwd = [_close_scaled(h, want_h, tol)] + [
        _close_state(g, w, f32) for g, w in zip(bounds, want_bounds)]
    got = ops.slstm_scan_bwd(zx, r, b, bounds, dh, **kw)
    again = ops.slstm_scan_bwd(zx, r, b, bounds, dh, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("K8 gave other bits on a second run")
    want = ref.slstm_scan_bwd_ref(zx, r, b, bounds, dh, **kw)
    bwd = [_close_scaled(got[0], want[0], tol),
           _close_scaled(got[1], want[1], f32),
           _close_scaled(got[2], want[2], f32)]
    bsz, t, nh, hd4 = zx.shape
    es = zx.element_size()
    bound_bytes = 4 * sum(x.numel() for x in bounds)
    rb_bytes = 4 * (r.numel() + b.numel())
    # the recurrent products: 2 B T H hd 4hd float32 operations a pass
    flops = 2 * bsz * t * nh * (hd4 // 4) * hd4
    k7 = {"max_abs_err": max(e for e, _ in fwd),
          "rel_err": max(x for _, x in fwd),
          "max_abs_out": [x.abs().max().item() for x in (want_h,) + want_bounds],
          "tolerance": {"h": tol, "bounds": f32}}
    k8 = {"max_abs_err": max(e for e, _ in bwd),
          "rel_err": max(x for _, x in bwd),
          "max_abs_out": [x.abs().max().item() for x in want],
          "tolerance": {"dzx": tol, "dR, db": f32}, "deterministic": True}
    # the cluster each launched with: blocks, rows of R resident, bytes
    for k, backward in ((k7, False), (k8, True)):
        plan = ss.launch_plan(zx, block_b=block_b, backward=backward)
        k["cluster"] = {key: plan[key] for key in (
            "cluster", "resident_rows", "smem_bytes", "units")}
    if timed:
        # K7: zx, R, b read; h and the bounds written
        b7 = _bound(es * (zx.numel() + h.numel()) + rb_bytes + bound_bytes,
                    flops, torch.float32)
        # K8: zx, dh, R, b, bounds read; dzx, dR, db written; the forward
        # recomputed, dh = dz R^T and dR = h^T dz
        b8 = _bound(es * (2 * zx.numel() + dh.numel()) + 2 * rb_bytes
                    + bound_bytes, 3 * flops, torch.float32)
        k7.update(ms=timer.ms(lambda: ops.slstm_scan_fwd_res(zx, r, b, **kw)),
                  plain_ms=timer.ms(lambda: ref.slstm_scan_fwd_res_ref(
                      zx, r, b, **kw), reps=3),
                  bound_ms=b7[0], bound_by=b7[1], library_ms=None)
        k8.update(ms=timer.ms(lambda: ops.slstm_scan_bwd(zx, r, b, bounds, dh,
                                                         **kw)),
                  plain_ms=timer.ms(lambda: ref.slstm_scan_bwd_ref(
                      zx, r, b, bounds, dh, **kw), reps=3),
                  bound_ms=b8[0], bound_by=b8[1], library_ms=None)
    return k7, k8


def phase_xlstm_kernels(timer: Timer, device: torch.device) -> None:
    gen = torch.Generator(device).manual_seed(4)
    for i, (b, t, h, hd, bb, chunk, dtype) in enumerate(SLSTM_CASES):
        def rnd(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device=device)
        zx = rnd(b, t, h, 4 * hd).to(dtype)
        r = rnd(h, hd, 4 * hd, scale=1.0 / math.sqrt(hd))
        bias = rnd(h, 4 * hd, scale=0.1)
        dh = rnd(b, t, h, hd).to(dtype)
        k7, k8 = measure_slstm(timer, zx, r, bias, dh, bb, chunk, timed=i == 0)
        case = (f"{str(dtype)[6:]} B={b} T={t} H={h} hd={hd} block_b={bb} "
                f"chunk={chunk}")
        log("xlstm-kernels", f"K7 slstm_scan {case}: {json.dumps(k7)}")
        log("xlstm-kernels", f"K8 slstm_scan_bwd {case}: {json.dumps(k8)}")


class SLSTMRecorder:
    """Keeps the first K8 call of the main path (its inputs: the zx, R and b
    that K7 ran on, and dh), below the counting wrapper, so the launch
    counts are untouched."""

    def __init__(self):
        self.call = None
        self._bwd = ss.slstm_scan_bwd

    def __enter__(self):
        def bwd(zx, r, b, bounds, dh, **kw):
            if self.call is None:
                self.call = (zx, r, b, dh, kw)
            return self._bwd(zx, r, b, bounds, dh, **kw)
        ss.slstm_scan_bwd = bwd
        return self

    def __exit__(self, *exc):
        ss.slstm_scan_bwd = self._bwd


def xlstm_slot_parts(cfg, worker0: dict, timer: Timer, smi: str) -> None:
    """Device time of one worker's mLSTM layers (the quadratic form, fwd +
    bwd, x num_super_blocks) and of the LM head with its cross entropy
    (fwd + bwd), each on its own at the slot's shapes (4 x 512 tokens)."""
    device = worker0["embed"]["table"].device
    gen = torch.Generator(device).manual_seed(7)
    cdt = getattr(torch, cfg.compute_dtype)
    x = torch.randn(4, 512, cfg.d_model, generator=gen, device=device) \
        .to(cdt).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                           device=device)
    mix = {k: v.detach().requires_grad_()
           for k, v in worker0["blocks"][0]["pos0"]["mixer"].items()}
    embed = {k: v.detach().requires_grad_()
             for k, v in worker0["embed"].items()}
    head_w = embed["table" if cfg.tie_embeddings else "lm_head"]

    def mlstm():
        y = xlstm_mod.mlstm_train(mix, x, cfg)
        torch.autograd.grad(y.float().square().mean(), [x, *mix.values()])

    def head():
        logits = layers_mod.lm_logits(embed, x, cfg)
        loss = F.cross_entropy(logits.float().reshape(-1, cfg.vocab_size),
                               labels.reshape(-1))
        torch.autograd.grad(loss, [x, head_w])
    n = cfg.num_super_blocks
    log("train-xlstm", f"one worker's slot parts, fwd + bwd at 4 x 512 "
        f"tokens: {n} mLSTM layers {n * timer.ms(mlstm, reps=3)} ms, LM head "
        f"+ cross entropy {timer.ms(head, reps=3)} ms on {smi}")


def phase_xlstm_parity(cfg, worker0: dict, device: torch.device) -> None:
    """Flash vs plain gradients of one trained worker at full width and
    depth (6 super-blocks, 4 x 512 tokens), with the params and the
    compute in float32, held ten times tighter than phase train-parity.

    The stack multiplies a relative change of the sLSTM outputs by 100-300
    in the gradient (`tools/xlstm_grad_conditioning.py`; PERF.md).  K7 /
    K8 and the cell loop differ by float32 rounding (~1e-7), so their
    gradients agree to ~5e-4 (median) and ~7e-3 (the worst leaf): limits
    5e-3 and 5e-2.  In bf16 every operation rounds at 2^-9, which the
    same gain turns into gradients ~100% apart, with or without the
    kernels; that comparison holds nothing."""
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    phase_train_parity(f32, tree_map(lambda x: x.float(), worker0), device,
                       phase="xlstm-parity", seq_len=512,
                       report=("r_gates", "b_gates", "w_gates"),
                       limits=(5e-3, 5e-2))


def phase_slstm_layer_f32(device: torch.device) -> None:
    """One sLSTM layer at xlstm-125m's width in float32 (B 2, T 512):
    output and gradients, ``impl="flash"`` (K7 + K8) against ``"plain"``
    (the cell loop).  Both compute in float32 and differ by the
    recurrence's summation order and the last bits of the math functions
    through 512 steps: every output within 1e-4 of its scale (relative
    norm error <= 1e-4)."""
    cfg = dataclasses.replace(get_config("xlstm-125m"), param_dtype="float32",
                              compute_dtype="float32")
    gen = torch.Generator(device).manual_seed(6)
    p = xlstm_mod.init_slstm(gen, cfg)
    p["b_gates"] = 0.1 * torch.randn(p["b_gates"].shape, generator=gen,
                                     device=device)
    x = torch.randn(2, 512, cfg.d_model, generator=gen, device=device)
    wy = torch.randn(2, 512, cfg.d_model, generator=gen, device=device)

    def run(impl):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        y = xlstm_mod.slstm_train(leaves, xx, cfg, impl=impl)
        grads = torch.autograd.grad((y * wy).sum(), [xx, *leaves.values()])
        return [y.detach(), *grads]
    before = (ops.slstm_scan.launches, ops.slstm_scan_bwd.launches)
    got = run("flash")
    if (ops.slstm_scan.launches, ops.slstm_scan_bwd.launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError("the flash layer did not run K7 and K8 once")
    want = run("plain")
    names = ["y", "dx"] + [f"d{k}" for k in p]
    tol = SLSTM_TOL[torch.float32]
    errs = {n: _close_scaled(g, w, tol) for n, g, w in zip(names, got, want)}
    log("xlstm-parity", "one sLSTM layer at xlstm-125m width, float32, B 2 x "
        "T 512, flash vs plain (max abs err, relative norm error): "
        + ", ".join(f"{n} {e[0]:.3e} {e[1]:.3e}" for n, e in errs.items())
        + f"; tolerance {tol}")


def phase_xlstm(timer: Timer, device: torch.device, smi: str
                ) -> tuple[dict, dict, dict]:
    """Phases xlstm-kernels, train-xlstm and xlstm-parity, then K7 and K8
    at the training path's inputs.  -> (train-xlstm launches, K7, K8)."""
    phase_xlstm_kernels(timer, device)
    xcfg = get_config("xlstm-125m")
    xtrained, xmll, xl_launches, _, srec = phase_train(
        xcfg, device, smi, phase="train-xlstm", seq_len=512)
    xstate = phase_train_profile(xcfg, xtrained, xmll, device, smi,
                                 phase="train-xlstm", seq_len=512)
    xworker0 = tree_map(lambda x: x[0].clone(), xstate.params)
    del xtrained, xstate
    torch.cuda.empty_cache()
    xlstm_slot_parts(xcfg, xworker0, timer, smi)
    phase_xlstm_parity(xcfg, xworker0, device)
    del xworker0
    phase_slstm_layer_f32(device)
    zx, r, b, dh, kw = (x.detach() if torch.is_tensor(x) else x
                        for x in srec.call)
    k7, k8 = measure_slstm(timer, zx, r, b, dh, kw["block_b"], kw["chunk"],
                           timed=True)
    log("report", f"K7 / K8 at the training path's shapes zx "
        f"{tuple(zx.shape)} {str(zx.dtype)[6:]}, block_b {kw['block_b']}, "
        f"chunk {kw['chunk']}: K7 {json.dumps(k7)}; K8 {json.dumps(k8)}")
    del srec, zx, r, b, dh
    torch.cuda.empty_cache()
    return xl_launches, k7, k8


# ------------------------------------------------ K1/K2/K5 measurement
# The fused update + mix kernel and its plain version share one arithmetic
# (products and sums rounded one by one, in one order), so they are held
# equal bit for bit; so are packed and per-leaf launches and chunked and
# single launches.
SIM_EXACT = dict(atol=0.0, rtol=0.0)
SIM_ETA = 0.05
SIM_NET = dict(topology="ring", workers_per_subnet=[2, 2], tau=2, q=2,
               worker_rates=(1.0, 0.8, 1.0, 0.6))
SIM_SLOTS, SIM_CHUNKS = 8, 4
# (e) kernel="xla" against kernel="pallas": the two mix in other orders, so
# u differs by float32 rounding at each event; the bf16 forward can turn a
# 1-ulp float32 difference of a parameter into a bf16-sized difference of
# its gradient, so the runs are held to the update they made: ||u_e - u_a||
# within 1e-2 of ||u_a - u_0|| (a wrong kernel differs by ~100%).
SIM_XLA_REL = 1e-2
# paper-scale runs, pallas against xla: float32 sums of W = 100 terms in
# two orders over the run (a wrong kernel moves the loss by >= 1e-2)
PAPER_TOL = 1e-4


def _exact(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel and plain version differ, "
                             f"max abs err {err}")
    return err


def _mix_bound(w: int, c: int, d: int, grouped: bool, hub: bool,
               es: int) -> tuple[float, str]:
    """x and g read once, out written once (element size ``es``), the
    operators and theta once; float32 operations per column: the update
    (2 W) and the contraction (2 W^2, or 4 W D + 2 D^2)."""
    op = (2 * w * d + (d * d if hub else 0)) if grouped else w * w
    bytes_ = 3 * es * w * c + 4 * (op + w)
    per_col = 2 * w + ((4 * w * d + (2 * d * d if hub else 0)) if grouped
                       else 2 * w * w)
    return _bound(bytes_, per_col * c, torch.float32)


def measure_mix(timer: Timer, x, g, op, theta, kind: str,
                chunks: int = SIM_CHUNKS) -> dict:
    """K1a (one leaf), K1b / K2 (the packed buffer of a one-leaf tree, a
    view: no pack copy) or K5 (its chunked launches) on (W, C) inputs,
    against the plain version: error, times, bound, and the unfused torch
    pair (update, then one cuBLAS product with the dense operator)."""
    grouped = isinstance(op, hm.GroupedOperator)
    if kind == "K1a":
        def run():
            return ops.hier_mix(x, g, op, theta, SIM_ETA)
    elif kind == "K5":
        def run():
            return ops.hier_mix_packed_chunked(
                {"x": x}, {"x": g}, op, theta, SIM_ETA,
                num_chunks=chunks)["x"]
    else:
        def run():
            return ops.hier_mix_packed({"x": x}, {"x": g}, op, theta,
                                       SIM_ETA)["x"]

    def plain():
        if grouped:
            return ref.hier_mix_grouped_ref(x, g, op.scatter, op.broadcast,
                                            op.hub, theta, SIM_ETA)
        return ref.hier_mix_ref(x, g, op, theta, SIM_ETA)
    w, c = x.shape
    got = run()
    err = _exact(got, plain(), f"{kind} W={w} C={c}")
    del got
    if grouped:
        h = op.hub if op.hub is not None else torch.eye(
            op.scatter.shape[0], device=x.device)
        dense_t = (op.broadcast @ h.t() @ op.scatter).t().contiguous()
    else:
        dense_t = op
    a = theta * SIM_ETA

    def library():       # two calls and a product: no single torch call
        return torch.mm(dense_t.t(), x - a[:, None] * g)
    d = op.scatter.shape[0] if grouped else 0
    bound_ms, bound_by = _mix_bound(
        w, c, d, grouped, grouped and op.hub is not None, x.element_size())
    reps = 5 if x.numel() > 1e8 else 20
    return {"max_abs_err": err, "tolerance": SIM_EXACT,
            "ms": timer.ms(run, reps), "plain_ms": timer.ms(plain, reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timer.ms(library, reps) if x.dtype ==
            torch.float32 else None,
            "library": "two calls: x - (eta*theta)*g, then torch.mm with "
                       "the dense operator"}


def _grouped_op(w: int, d: int, hub: bool, device) -> hm.GroupedOperator:
    net = MultiLevelNetwork.build("ring", [w // d] * d)
    return hm.make_grouped_operator(net.subnet_of, net.v,
                                    net.hub_net.h if hub else None,
                                    device=device)


def qwen2_packed_cols() -> tuple[int, int]:
    """(total packed columns, largest leaf) of qwen2-0.5b, from the meta
    skeleton (no memory)."""
    sizes = [x.numel() for x in tree_leaves(
        model_mod.param_skeleton(get_config("qwen2-0.5b")))]
    return sum(sizes), max(sizes)


def phase_sim_kernels(timer: Timer, device: torch.device, smi: str) -> dict:
    """K1a / K1b / K2 / K5 against their plain versions: small and awkward
    shapes, the paper's W = 100 (D = 10), bf16 leaves, then the qwen2-0.5b
    packed fleet of the sim phase (W = 4 float32).  -> the measurements at
    the main path's shapes, for the report."""
    gen = torch.Generator(device).manual_seed(4)

    def inputs(w, c, dtype=torch.float32):
        x = torch.randn(w, c, generator=gen, device=device).to(dtype)
        gr = torch.randn(w, c, generator=gen, device=device).to(dtype)
        t = torch.rand(w, w, generator=gen, device=device)
        theta = (torch.rand(w, generator=gen, device=device) > 0.3).float()
        return x, gr, t / t.sum(0, keepdim=True), theta

    for w, c, dtype in ((4, 1, torch.float32), (4, 301, torch.float32),
                        (13, 4101, torch.bfloat16), (100, 200, torch.float32),
                        (100, 100_003, torch.float32)):
        x, gr, t, theta = inputs(w, c, dtype)
        r = measure_mix(timer, x, gr, t, theta, "K1a")
        log("sim-kernels", f"K1a dense W={w} C={c} {str(dtype)[6:]}: "
            f"{json.dumps(r)}")
        if dtype == torch.float32:
            for kind in ("K1b", "K5"):
                r = measure_mix(timer, x, gr, t, theta, kind, chunks=3)
                log("sim-kernels", f"{kind} dense W={w} C={c}: "
                    f"{json.dumps(r)}")
    for w, d, hub in ((4, 2, False), (4, 2, True), (100, 10, True)):
        x, gr, _, theta = inputs(w, 100_003)
        op = _grouped_op(w, d, hub, device)
        for kind in ("K2", "K5"):
            r = measure_mix(timer, x, gr, op, theta, kind, chunks=3)
            log("sim-kernels", f"{kind} grouped W={w} D={d} hub={hub} "
                f"C=100003: {json.dumps(r)}")
    # packed = per leaf on a mixed tree
    tree = {"a": torch.randn(4, 37, 11, generator=gen, device=device),
            "b": torch.randn(4, generator=gen, device=device),
            "h": torch.randn(4, 300, generator=gen,
                             device=device).to(torch.bfloat16)}
    grads = tree_map(lambda v: torch.randn(v.shape, generator=gen,
                                           device=device).to(v.dtype), tree)
    t, theta = inputs(4, 1)[2:]
    packed = ops.hier_mix_packed(tree, grads, t, theta, SIM_ETA)
    perleaf = ops.hier_mix_pytree(tree, grads, t, theta, SIM_ETA)
    for k in tree:
        _exact(packed[k], perleaf[k], f"packed vs per-leaf, leaf {k}")
    log("sim-kernels", "packed (K1b) = per-leaf (K1a) bit for bit on a "
        "float32 + bf16 + (W,) tree")

    # the main path's shapes: the packed qwen2-0.5b fleet, W = 4 float32
    total, largest = qwen2_packed_cols()
    out = {}
    x, gr = (torch.randn(4, total, generator=gen, device=device)
             for _ in range(2))
    theta = torch.tensor([1.0, 0.0, 1.0, 1.0], device=device)
    net = MultiLevelNetwork.build(SIM_NET["topology"],
                                  SIM_NET["workers_per_subnet"])
    z_op = torch.as_tensor(net.z_matrix(), dtype=torch.float32,
                           device=device)
    shapes = f"W=4 C={total} float32 on {smi}"
    out["K1b"] = measure_mix(timer, x, gr, z_op, theta, "K1b")
    log("sim-kernels", f"K1b dense (Z) at the packed qwen2-0.5b fleet "
        f"{shapes}: {json.dumps(out['K1b'])}")
    grouped = _grouped_op(4, 2, True, device)
    out["K2"] = measure_mix(timer, x, gr, grouped, theta, "K2")
    log("sim-kernels", f"K2 grouped (two_stage hub) at the packed fleet "
        f"{shapes}: {json.dumps(out['K2'])}")
    out["K5"] = measure_mix(timer, x, gr, grouped, theta, "K5")
    single = ops.hier_mix_packed({"x": x}, {"x": gr}, grouped, theta,
                                 SIM_ETA)["x"]
    chunked = ops.hier_mix_packed_chunked({"x": x}, {"x": gr}, grouped,
                                          theta, SIM_ETA,
                                          num_chunks=SIM_CHUNKS)["x"]
    _exact(chunked, single, "K5 (4 chunks) vs one K2 launch")
    del single, chunked
    log("sim-kernels", f"K5 grouped, {SIM_CHUNKS} chunks, at the packed "
        f"fleet {shapes} (= one K2 launch bit for bit): "
        f"{json.dumps(out['K5'])}")
    del x, gr
    x, gr = (torch.randn(4, largest, generator=gen, device=device)
             for _ in range(2))
    out["K1a"] = measure_mix(timer, x, gr, z_op, theta, "K1a")
    log("sim-kernels", f"K1a dense at qwen2-0.5b's largest leaf (the "
        f"embedding, W=4 C={largest} float32) on {smi}: "
        f"{json.dumps(out['K1a'])}")
    del x, gr
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- simulator path
def mix_launches() -> dict:
    """Launches of K1a / K1b / K2 / K5 since the last reset."""
    packed, chunked = ops.hier_mix_packed, ops.hier_mix_packed_chunked
    return {"K1a": ops.hier_mix.launches + ops.hier_mix_pytree.launches,
            "K1b": packed.launches - packed.grouped_launches,
            "K2": packed.grouped_launches, "K5": chunked.launches,
            "K3": ops.flash_attention.launches,
            "K4": ops.flash_attention_bwd.launches}


class ExecClock:
    """Host seconds of the event executor's local segments (per slot) and
    event slots, each between two device synchronisations."""

    def __init__(self):
        self.local, self.event = [], []
        self._scan, self._step = ttl.EventExecutor.scan_local, \
            ttl.EventExecutor._step

    def __enter__(self):
        clock = self

        def scan(ex, carry, data, active):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = clock._scan(ex, carry, data, active)
            torch.cuda.synchronize()
            clock.local.append((time.perf_counter() - t0) / len(active))
            return out

        def step(ex, carry, data, act, op):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = clock._step(ex, carry, data, act, op)
            torch.cuda.synchronize()
            clock.event.append(time.perf_counter() - t0)
            return out
        ttl.EventExecutor.scan_local, ttl.EventExecutor._step = scan, step
        return self

    def __exit__(self, *exc):
        ttl.EventExecutor.scan_local, ttl.EventExecutor._step = \
            self._scan, self._step


def lm_task(cfg, device):
    """The transformer as a simulator task: the token cross-entropy through
    ``impl="flash"`` (K3 forward, K4 backward) and next-token accuracy."""
    stream = make_token_stream(4, 65 * 129, vocab_size=cfg.vocab_size,
                               seed=0).astype(np.int64)
    worker_data = {"tokens": torch.from_numpy(
        stream[:, :64 * 129].reshape(4, 64, 129))}
    eval_data = {"tokens": torch.from_numpy(stream[:, 64 * 129:])}

    def loss_fn(p, b):
        t = b["tokens"]
        return train_loss_fn(p, {"tokens": t[:, :-1], "labels": t[:, 1:]},
                             cfg, impl="flash")[0]

    def acc_fn(p, b):
        t = b["tokens"]
        logits, _ = model_mod.forward_train(p, {"tokens": t[:, :-1]}, cfg,
                                            impl="flash")
        return (logits.argmax(-1) == t[:, 1:]).float().mean()
    return loss_fn, acc_fn, worker_data, eval_data


def _u_diff(a: dict, b: dict) -> float:
    return max((x - y).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _u_norm(a: dict, b: dict) -> float:
    return float(sum(((x - y).float() ** 2).sum().item()
                     for x, y in zip(tree_leaves(a), tree_leaves(b))) ** 0.5)


def phase_sim(device: torch.device, smi: str) -> dict:
    """qwen2-0.5b at full width through `run_timeline`: runs (a)-(f) of the
    simulator path, with the launch counts asserted from each plan."""
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = tree_map(lambda x: x.float(), model_mod.init_model(
        torch.Generator(device).manual_seed(0), cfg, device=device))
    torch.cuda.synchronize()
    spec = packing.pack_spec(replicate_meta(params, 4))
    loss_fn, acc_fn, worker_data, eval_data = lm_task(cfg, device)
    net, sched = baselines.mll_sgd(SIM_NET["topology"],
                                   SIM_NET["workers_per_subnet"],
                                   SIM_NET["tau"], SIM_NET["q"],
                                   worker_rates=SIM_NET["worker_rates"])
    log("sim", f"{cfg.name}: {model_mod.count_params(params)} params cast "
        f"to float32 ({len(tree_leaves(params))} leaves; packed "
        f"(W, C) = ({spec.num_workers}, {spec.total_cols})) in "
        f"{time.perf_counter() - t0:.1f} s; W = 4 workers (2 subnets x 2, "
        f"ring, rates {SIM_NET['worker_rates']}), tau = q = 2, eta "
        f"{SIM_ETA}, {SIM_SLOTS} slots of 4 x 128 tokens per worker; W = 8 "
        f"would need ~95 GB, so W = 4 is the one cut")

    def run(label, policy, mixing="dense", kernel="pallas", overlap="none",
            exec_mode="event"):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with ExecClock() as clock:
            res = ttl.run_timeline(
                loss_fn, acc_fn, params, worker_data, eval_data, eval_data,
                net, sched, slots=SIM_SLOTS, policy=policy,
                cfg=SimConfig(eta=SIM_ETA, batch_size=4, eval_every=SIM_SLOTS,
                              mixing=mixing, kernel=kernel, overlap=overlap,
                              overlap_chunks=SIM_CHUNKS),
                seed=0, policy_rng=np.random.default_rng(0),
                exec_mode=exec_mode, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mix_launches()
        check_tensor_cores(f"sim ({label})")
        plan = res.plan
        events = [s for s in range(plan.slots) if plan.op_ids[s] != 0
                  or s in (plan.op_mats or {})]
        log("sim", f"({label}) {policy} {mixing} kernel={kernel} "
            f"overlap={overlap} exec={exec_mode}: {len(events)} events at "
            f"slots {[s + 1 for s in events]}; launches {launches}; u_k loss "
            f"{res.train_loss.tolist()} acc {res.test_acc.tolist()}; "
            f"seconds per local slot {clock.local}, per event slot "
            f"{clock.event}; wall {wall} s; peak memory "
            f"{torch.cuda.max_memory_allocated(device) / 2**30} GiB on {smi}")
        if not np.isfinite(res.train_loss).all():
            raise AssertionError(f"({label}) non-finite loss")
        return res, launches, len(events)

    def expect(label, launches, **want):
        full = {"K1a": 0, "K1b": 0, "K2": 0, "K5": 0, **want}
        got = {k: launches[k] for k in full}
        if got != full:
            raise AssertionError(f"({label}) launches {got}, expected {full}")

    w, layers = 4, cfg.num_layers
    res_a, la, ev_a = run("a", "deadline", "two_stage")
    expect("a", la, K2=ev_a)
    want_k4 = layers * w * SIM_SLOTS
    if la["K4"] != want_k4 or la["K3"] != layers * (w * SIM_SLOTS + 2):
        raise AssertionError(f"(a) K3/K4 launches {la}, expected K4 "
                             f"{want_k4}, K3 {layers * (w * SIM_SLOTS + 2)}")
    u_a = res_a.final_avg_params
    del res_a
    res, ld, ev_d = run("d", "deadline", "two_stage", overlap="chunked")
    n_chunks = len(packing.chunk_views(spec, SIM_CHUNKS))
    expect("d", ld, K5=ev_d * n_chunks)
    diff_d = _u_diff(u_a, res.final_avg_params)
    if diff_d != 0.0:
        raise AssertionError(f"(d) chunked u differs from (a) by {diff_d}")
    res, le, _ = run("e", "deadline", "two_stage", kernel="xla")
    expect("e", le)
    rel_e = _u_norm(u_a, res.final_avg_params) / _u_norm(u_a, params)
    log("sim", f"(d) u equal to (a) bit for bit; (e) kernel=xla vs (a): max "
        f"|du| {_u_diff(u_a, res.final_avg_params)}, ||u_e - u_a|| / "
        f"||u_a - u_0|| {rel_e} (limit {SIM_XLA_REL})")
    if not rel_e <= SIM_XLA_REL:
        raise AssertionError("(e) kernel=xla and kernel=pallas disagree")
    del u_a, res
    res_b, lb, ev_b = run("b", "barrier")
    expect("b", lb, K1b=ev_b)
    res, lf, _ = run("f", "barrier", exec_mode="full")
    expect("f", lf, K1b=SIM_SLOTS)
    diff_f = _u_diff(res_b.final_avg_params, res.final_avg_params)
    if diff_f != 0.0 or list(res.train_loss) != list(res_b.train_loss):
        raise AssertionError(f"(f) full scan differs from (b) by {diff_f}")
    del res
    # (f') the full scan per leaf (K1a every slot) from the same plan
    ops.reset_launches()
    scan = ttl.make_timeline_step_fn(loss_fn, net, SimConfig(
        eta=SIM_ETA, batch_size=4, kernel="pallas"),
        gate_mode=res_b.plan.gate_mode, pallas_packed=False, device=device)
    carry = init_sim_carry(replicate(params, w), SimConfig(kernel="pallas"),
                           seed=0)
    t0 = time.perf_counter()
    carry = scan(carry, to_device(worker_data, device), res_b.plan.op_ids,
                 res_b.plan.active)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    u_f2 = weighted_average(carry[0], torch.as_tensor(
        np.asarray(net.a), dtype=torch.float32, device=device))
    lf2 = mix_launches()
    del carry
    expect("f'", lf2, K1a=SIM_SLOTS * len(spec.slots))
    diff_f2 = _u_diff(res_b.final_avg_params, u_f2)
    log("sim", f"(f) exec=full (K1b every slot, T = I at local slots) and "
        f"(f') the full scan per leaf (K1a, {lf2['K1a']} launches, {wall} "
        f"s) against (b) event-sparse: u equal bit for bit: "
        f"{diff_f == 0.0 and diff_f2 == 0.0}")
    if diff_f2 != 0.0:
        raise AssertionError(f"(f') per-leaf full scan differs by {diff_f2}")
    del res_b, u_f2
    _, lc, ev_c = run("c", "gossip")
    expect("c", lc, K1b=ev_c)
    launches = {k: la[k] + lb[k] + lc[k] + ld[k] + le[k] + lf[k] + lf2[k]
                for k in la}
    profile_event(loss_fn, net, params, worker_data, device, smi)
    del params
    torch.cuda.empty_cache()
    return launches


def replicate_meta(params: dict, w: int) -> dict:
    """The stacked tree's shapes and dtypes, as meta tensors."""
    return tree_map(lambda x: torch.empty((w,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta"),
                    params)


def profile_event(loss_fn, net, params, worker_data, device, smi) -> None:
    """One hub event slot of run (a)'s configuration (K2 over the packed
    fleet) and one local slot: host wall without the profiler, then
    `torch.profiler` for the device's busy time; and one mixing event
    split into pack / kernel / unpack."""
    from torch.profiler import ProfilerActivity, profile
    cfg = SimConfig(eta=SIM_ETA, batch_size=4, mixing="two_stage",
                    kernel="pallas")
    ex = ttl.EventExecutor(loss_fn, net, cfg, gate_mode="bernoulli",
                           device=device)
    data = to_device(worker_data, device)
    carry = init_sim_carry(replicate(params, 4), cfg, seed=0)
    ones = np.ones(4, np.float32)
    hub = protocol.PHASE_HUB

    def busy(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        return out, wall_ms, busy_ms, len(dev)

    carry = ex.step_phase[hub](carry, data, ones)        # warm-up
    for name, fn in (("event (hub, K2)", lambda: ex.step_phase[hub](
                          carry, data, ones)),
                     ("local", lambda: ex.scan_local(carry, data,
                                                     ones[None]))):
        carry, wall_ms, busy_ms, n_ops = busy(fn)
        log("sim", f"{name} slot at full width: wall {wall_ms} ms (no "
            f"profiler); device busy {busy_ms} ms ({100 * busy_ms / wall_ms}"
            f"% of the wall), {n_ops} device operations on {smi}")
    stacked, key = carry[0], carry[3]
    grads, theta, _ = ex._sample(stacked, key, data, ones)
    op = ex._phase_ops[hub]
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    mark()
    spec = packing.pack_spec(stacked)
    x = packing.pack(stacked, spec)
    g = packing.pack(grads, spec)
    mark()
    out = hm.hier_mix_chunks(x, g, op, theta.to(device), SIM_ETA)
    mark()
    packing.unpack(out, spec)
    mark()
    ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    log("sim", f"one mixing event (hub, K2) at full width: pack (params + "
        f"grads, {len(spec.slots)} leaves each) {ms[0]} ms, kernel {ms[1]} "
        f"ms, unpack {ms[2]} ms (host clock between syncs) on {smi}")


def phase_sim_paper(device: torch.device, smi: str) -> dict:
    """The paper's logistic regression at the paper's scale
    (benchmarks/common.py `BenchScale.paper()`: W = 100 in 10 sub-networks,
    512 samples per worker, eta 0.1, batch 16, dim 24, 8 classes) through
    `simulate` (K1b at W = 100, dense mixing) and through `run_timeline`
    with two_stage mixing (K2 at D = 10), each with kernel="pallas"
    against kernel="xla".  Depth cut: 256 of the paper's 8192 steps (64
    timeline slots)."""
    steps, slots, dim, classes = 256, 64, 24, 8
    rates = tuple(np.linspace(0.5, 1.0, 100))
    net, sched = baselines.mll_sgd("ring", [10] * 10, tau=8, q=2,
                                   worker_rates=rates)
    data = make_classification(100, 512, dim=dim, num_classes=classes,
                               test_size=1024, seed=0)

    def loss_fn(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        gold = torch.gather(logits, 1, b["y"].long()[:, None])[:, 0]
        return (torch.logsumexp(logits, -1) - gold).mean()

    def acc_fn(p, b):
        return ((b["x"] @ p["w"] + p["b"]).argmax(-1) == b["y"]).float() \
            .mean()
    init = {"w": torch.zeros(dim, classes), "b": torch.zeros(classes)}
    launches, res = {}, {}
    for kind in ("simulate", "timeline"):
        for kernel in ("pallas", "xla"):
            ops.reset_launches()
            t0 = time.perf_counter()
            if kind == "simulate":
                r = simulate(loss_fn, acc_fn, init, data.worker_data(),
                             data.full, data.test, net, sched, steps=steps,
                             cfg=SimConfig(eta=0.1, batch_size=16,
                                           eval_every=64, kernel=kernel),
                             seed=0, device=device)
            else:
                r = ttl.run_timeline(
                    loss_fn, acc_fn, init, data.worker_data(), data.full,
                    data.test, net, sched, slots=slots, policy="deadline",
                    cfg=SimConfig(eta=0.1, batch_size=16, eval_every=32,
                                  mixing="two_stage", kernel=kernel),
                    seed=0, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[kind, kernel] = mix_launches()
            res[kind, kernel] = r
            log("sim-paper", f"{kind} W=100 D=10 kernel={kernel}: loss "
                f"{r.train_loss.tolist()} acc {r.test_acc.tolist()}; "
                f"launches {launches[kind, kernel]}; wall {wall} s on {smi}")
        a, b = res[kind, "pallas"], res[kind, "xla"]
        dl = float(np.abs(a.train_loss - b.train_loss).max())
        du = _u_diff(a.final_avg_params, b.final_avg_params)
        log("sim-paper", f"{kind}: pallas vs xla max |d loss| {dl}, max |du| "
            f"{du} (limit {PAPER_TOL})")
        if not (dl <= PAPER_TOL and du <= PAPER_TOL):
            raise AssertionError(f"{kind}: pallas and xla disagree")
        if not a.train_loss[-1] < a.train_loss[0]:
            raise AssertionError(f"{kind}: the loss did not decrease")
    events = int((res["timeline", "pallas"].plan.op_ids != 0).sum())
    want = {("simulate", "pallas"): dict(K1b=steps),
            ("timeline", "pallas"): dict(K2=events)}
    for key, lz in launches.items():
        full = {"K1a": 0, "K1b": 0, "K2": 0, "K5": 0, **want.get(key, {})}
        if {k: lz[k] for k in full} != full:
            raise AssertionError(f"{key}: launches {lz}, expected {full}")
    return {k: sum(lz[k] for lz in launches.values())
            for k in ("K1a", "K1b", "K2", "K5")}


# ------------------------------------------------------------------- main
# -------------------------------------------- compression ladder, overlap
LADDER = ("int8", "int8_ef", "int4_ef", "bf16", "topk_ef", "powersgd")
# tau = 1, q = 2: a two_stage subnet round in odd slots, the rung's hub
# round in even ones
LADDER_MLL = dict(tau=1, q=2, eta=0.05, hub_topology="ring",
                  worker_rates=(1.0, 0.8, 1.0, 0.6))
# consensus input (every worker equal): the largest error one hub round may
# leave, per element, as a share of max|x| (integer rungs: half a level),
# of |x| itself (bf16: half a bf16 ulp), or of the k-th largest |x|
# (top-k drops everything below its threshold); float32 rounding on top
CONSENSUS_BOUND = {"int8": 0.5 / 127, "int8_ef": 0.5 / 127,
                   "int4_ef": 0.5 / 7, "bf16": 2.0 ** -9, "topk_ef": 1.0}


class HubClock:
    """Synchronised milliseconds of each hub round of one strategy (its
    class's ``hub_with_state``), and whether the state it returned first
    held a nonzero leaf."""

    def __init__(self, name: str):
        self.cls = protocol.MIXING_REGISTRY[name]
        self.ms, self.first_state_nonzero = [], None
        self._hub = self.cls.hub_with_state
        self._own = "hub_with_state" in vars(self.cls)

    def __enter__(self):
        def hub(strategy, stacked, st, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._hub(strategy, stacked, st, state)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if self.first_state_nonzero is None:
                self.first_state_nonzero = any(
                    bool(x.abs().max() > 0) for x in tree_leaves(out[1])
                    if x.numel())
            return out
        self.cls.hub_with_state = hub
        return self

    def __exit__(self, *exc):
        if self._own:
            self.cls.hub_with_state = self._hub
        else:                               # inherited: unshadow it
            del self.cls.hub_with_state


def _ladder_subtree(tree: dict, norm: torch.Tensor | None = None) -> dict:
    """The check tree of a params-shaped tree: every super-block's K
    projection (one JAX leaf, (W, 24, 896, 2, 64) for qwen2-0.5b) and the
    final norm's scale (``norm`` replaces it: all ones, the top-k tie
    case)."""
    return {"blocks": [{"pos0": {"mixer": {"wk": b["pos0"]["mixer"]["wk"]}}}
                       for b in tree["blocks"]],
            "final_norm": {"scale": tree["final_norm"]["scale"]
                           if norm is None else norm}}


def _ladder_state(name: str, state, norm_ef: torch.Tensor | None = None):
    """The check tree's part of a rung's trained mixing state (``norm_ef``
    replaces the final norm's residual)."""
    if name == "powersgd":
        q = state["q"]
        return {"ef": _ladder_subtree(state["ef"], norm=norm_ef),
                "q": {"blocks": {"pos0": {"mixer": {
                    "wk": q["blocks"]["pos0"]["mixer"]["wk"]}}},
                      "final_norm": {"scale": q["final_norm"]["scale"]}}}
    if isinstance(state, tuple):
        return state
    return _ladder_subtree(state, norm=norm_ef)


def ladder_card_vs_cpu(name: str, params: dict, state, st_card, network
                       ) -> float:
    """Check (a): one hub round of the trained check tree (float32) on the
    card against the same round through the port on the CPU."""
    ones = torch.ones_like(params["final_norm"]["scale"], dtype=torch.float32)
    sub = tree_map(lambda x: x.float().clone(), _ladder_subtree(params, ones))
    sub_state = tree_map(torch.clone, _ladder_state(
        name, state, norm_ef=torch.zeros_like(ones)))
    cpu = (tree_map(lambda x: x.cpu(), sub),
           tree_map(lambda x: x.cpu(), sub_state))
    strat = protocol.get_mixing(name)
    st_cpu = build_state(MLLConfig(**LADDER_MLL, mixing=name), network,
                         device="cpu")
    got = strat.hub_with_state(sub, st_card, sub_state)
    want = strat.hub_with_state(cpu[0], st_cpu, cpu[1])
    gp, gs = (interop.flatten(t, worker_axis=True) for t in got)
    wp, ws = (interop.flatten(t, worker_axis=True) for t in want)
    scale = max(float(np.abs(v).max()) for v in wp.values())
    err = max(ladder_error(name, torch.from_numpy(gp[k]),
                           torch.from_numpy(wp[k])) for k in wp)
    for k in ws:
        g, v = torch.from_numpy(gs[k]), torch.from_numpy(ws[k])
        if k.startswith("q::"):
            g = align_columns(g, v)
        err = max(err, ladder_error(name, g, v, scale=scale))
    return err


def ladder_consensus(name: str, params: dict, st_card) -> float:
    """Check (b): a consensus fleet (worker 0's check tree on every worker)
    after one hub round stays within the rung's bound of its input."""
    sub = _ladder_subtree(params)
    fleet = tree_map(lambda x: x[0].float().expand_as(x).contiguous(), sub)
    before = tree_map(torch.clone, fleet)
    strat = protocol.get_mixing(name)
    out, _ = strat.hub_with_state(fleet, st_card, strat.init_state(fleet))
    worst = 0.0
    for (key, xs, blk), (_, ys, _) in zip(interop.leaf_groups(before),
                                          interop.leaf_groups(out)):
        x = torch.stack(xs, 1) if blk else xs[0]
        y = torch.stack(ys, 1) if blk else ys[0]
        err = (y - x).abs()
        if name == "powersgd":
            # a projection of each hub's matrix: never longer than it;
            # vector leaves cross exact
            ok = (float(err.norm()) <= float(x.norm()) * (1 + 1e-5)
                  if x.dim() >= 3 else float(err.max()) <= 1e-6 *
                  float(x.abs().max()))
        elif name == "bf16":
            ok = bool((err <= CONSENSUS_BOUND[name] * x.abs()
                       + 1e-6 * x.abs().max()).all())
        else:
            ref = x.abs().max()
            if name == "topk_ef":
                flat = x[0].abs().flatten()
                k = protocol._topk_count(flat.numel(), 1 / 32)
                ref = torch.topk(flat, k).values[-1]
            ok = float(err.max()) <= float(CONSENSUS_BOUND[name] * ref
                                           + 1e-6 * x.abs().max())
        if not ok:
            raise AssertionError(f"train-ladder {name}: consensus {key} "
                                 f"moved by {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def ladder_state_roundtrip(name: str, params: dict, state) -> int:
    """Check (c): the check tree's part of the trained state goes through
    `checkpoint.save_state` / `restore_state` bit for bit.  -> leaves."""
    sub = _ladder_subtree(params)
    sub_state = _ladder_state(name, state)
    ts = protocol.MLLTrainState(sub, {"counts": torch.zeros(
        4, dtype=torch.int32)}, sub_state, torch.tensor(4, dtype=torch.int32))
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_state(tmp, ts, slot=4)
        back, slot, _ = checkpoint.restore_state(tmp, ts)
    la, lb = tree_leaves(ts.mix_state), tree_leaves(back.mix_state)
    if slot != 4 or len(la) != len(lb) or not all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(la, lb)):
        raise AssertionError(f"train-ladder {name}: mixing state changed "
                             "through a checkpoint")
    return len(la)


def phase_train_ladder(device: torch.device, smi: str) -> dict:
    """Every compression rung trains qwen2-0.5b at full width through
    `run_training` (K3 + K4), then checks (a) card = CPU on one hub round
    of the check tree, (b) consensus within the rung's bound, (c) stateful
    rungs' state nonzero after the first hub round and through a
    checkpoint bit for bit, (d) a finite loss.  An uncompressed two_stage
    run first is the yardstick of times, memory and loss."""
    cfg = get_config("qwen2-0.5b")
    n_attn = _layers_of(cfg, "attn")
    rows = {}
    ops.reset_launches()
    seen = {"flash_attention": 0, "flash_attention_bwd": 0}
    for name in ("two_stage",) + LADDER:
        mll = MLLConfig(**LADDER_MLL, mixing=name)
        loop = _train_loop(steps=4, eval_every=4)
        logs = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with HubClock(name) as hub, SlotClock() as clock:
            out = run_training(cfg, mll, loop, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        hist = out["history"]
        w = out["network"].num_workers
        now = {k: getattr(ops, k).launches for k in seen}
        got = {k: now[k] - seen[k] for k in seen}
        seen = now
        want = {"flash_attention": n_attn * (w * 4 + len(hist["step"])),
                "flash_attention_bwd": n_attn * w * 4}
        if got != want:
            raise AssertionError(f"train-ladder {name}: launches {got}, "
                                 f"expected {want}")
        if not np.isfinite(hist["avg_loss"]).all() or not np.isfinite(
                hist["loss"]).all():
            raise AssertionError(f"train-ladder {name}: non-finite loss "
                                 f"{hist}")
        state = out["train_state"]
        st = build_state(mll, out["network"], device=device)
        spec = protocol.wire_spec(state.params)
        wire = protocol.get_mixing(name).wire_bytes(st, spec)
        f32_wire = protocol.get_mixing("two_stage").wire_bytes(st, spec)
        stateful = bool(tree_leaves(state.mix_state))
        if stateful and not hub.first_state_nonzero:
            raise AssertionError(f"train-ladder {name}: the state after the "
                                 "first hub round is all zero")
        card_err = consensus = leaves = None
        if name in LADDER:
            card_err = ladder_card_vs_cpu(name, state.params, state.mix_state,
                                          st, out["network"])
            consensus = ladder_consensus(name, state.params, st)
            leaves = (ladder_state_roundtrip(name, state.params,
                                             state.mix_state)
                      if stateful else 0)
        for line in logs:
            log("train-ladder", f"{name}: {line}")
        rows[name] = dict(
            slot_seconds=clock.seconds, hub_ms=hub.ms, peak_gib=peak,
            wire_bytes=wire, two_stage_wire_bytes=f32_wire,
            wire_ratio=wire / f32_wire, u_k_loss=hist["avg_loss"],
            worker_loss=hist["loss"], run_training_s=wall,
            card_vs_cpu_max_abs_err=card_err, consensus_max_abs_err=consensus,
            state_leaves_round_tripped=leaves, launches=got)
        log("train-ladder", f"{name}: {json.dumps(rows[name])} on {smi}")
        del out, state, st
    check_tensor_cores("train-ladder")
    return dict(rows=rows, launches={k: seen[k] for k in seen})


def phase_train_overlap(cfg, device: torch.device, smi: str) -> dict:
    """qwen3-1.7b with phase 7's settings for 4 slots from one seed, with
    ``overlap="none"`` and ``overlap="chunked"`` (4 chunks): the two u_k
    leaf by leaf within the reference's reduction-order change at bf16
    (below), the event slots' seconds and both runs' peak memory."""
    mll = MLLConfig(**TRAIN_MLL)
    runs = {}
    ops.reset_launches()
    for overlap in ("none", "chunked"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        with SlotClock() as clock:
            out = run_training(cfg, mll, _train_loop(
                steps=4, eval_every=4, overlap=overlap, overlap_chunks=4),
                log=lambda *a: None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        hist = out["history"]
        if not np.isfinite(hist["avg_loss"]).all():
            raise AssertionError(f"train-overlap {overlap}: {hist}")
        # u_k leaves the card, so the next run's peak is its own
        runs[overlap] = dict(u=interop.flatten(out["avg_params"]), peak=peak,
                             seconds=clock.seconds, loss=hist["avg_loss"],
                             spec=packing.pack_spec(out["train_state"].params))
        del out
    check_tensor_cores("train-overlap")
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_attention_bwd": ops.flash_attention_bwd.launches}
    n_attn = _layers_of(cfg, "attn")
    want = {"flash_attention": 2 * n_attn * (4 * 4 + 1),
            "flash_attention_bwd": 2 * n_attn * 4 * 4}
    if launches != want:
        raise AssertionError(f"train-overlap: launches {launches}, expected "
                             f"{want}")
    # The fleet is bf16.  "none" mixes in bf16 (the subnet mean, then the
    # hub rolls, each rounded to bf16); "chunked" contracts the dense
    # operator in float32 and rounds once.  With v = 1/2 and H's 1/2 the
    # subnet rounds agree exactly, the hub round by its double rounding:
    # one bf16 ulp of its operands.  Where the two subnet means cancel, the
    # ulp of the result is smaller than theirs: bound every element by one
    # bf16 ulp of its own value and one of the leaf's largest value.
    worst, spread = 0.0, 0.0
    for (key, a), (_, b) in zip(runs["none"]["u"].items(),
                                runs["chunked"]["u"].items()):
        a, b = torch.from_numpy(a).double(), torch.from_numpy(b).double()
        err = (a - b).abs()
        bound = 2.0 ** -7 * (a.abs() + 2.0 ** -1 * a.abs().max())
        if not bool((err <= bound).all()):
            raise AssertionError(f"train-overlap: u_k {key} differs by "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
        spread = max(spread, float((err / (a.abs().max() + 1e-30)).max()))
    spec = runs["chunked"]["spec"]
    slab = 4 * spec.num_workers * max(
        ch.size for ch in packing.chunk_views(spec, 4))
    grew = runs["chunked"]["peak"] - runs["none"]["peak"]
    if grew > 2 * slab:
        raise AssertionError(f"train-overlap: the chunked peak exceeds the "
                             f"unchunked one by {grew} B > 2 slabs of {slab}")
    row = {k: dict(peak_gib=v["peak"] / 2**30, slot_seconds=v["seconds"],
                   event_slot_seconds=[v["seconds"][1], v["seconds"][3]],
                   u_k_loss=v["loss"]) for k, v in runs.items()}
    row.update(u_k_max_abs_diff=worst, u_k_max_diff_of_leaf_max=spread,
               chunk_slab_gib=slab / 2**30, launches=launches)
    log("train-overlap", f"{json.dumps(row)} on {smi}")
    return row


# ------------------------------------------------------ the mesh path
MESH_MIXINGS = ("two_stage", "ppermute", "bf16", "dense")
MESH_RANKS = 4


def _slot_summary(stats: list) -> dict:
    """Seconds of the local and of the event slots, and each event's
    collectives with their staging and transfer milliseconds."""
    local = [s["seconds"] for s in stats if s["event"] == "local"]
    events = [dict(event=s["event"], seconds=s["seconds"],
                   collectives=s["collectives"], stage_ms=s["stage_s"] * 1e3,
                   transfer_ms=s["transfer_s"] * 1e3)
              for s in stats if s["event"] != "local"]
    return dict(local_slot_seconds=local, events=events)


def phase_train_mesh(device: torch.device, smi: str,
                     backend: str = "gloo") -> dict:
    """qwen2-0.5b at full width as W = 4 (2 x 2 on a ring, rates
    1.0/0.8/1.0/0.6), tau 2, q 2, 4 slots of 4 x 128 tokens (slot 2 a subnet
    event, slot 4 a hub event), through K3 + K4, under each mixing of
    ``MESH_MIXINGS``: once in one process on the card, then on mesh (4, 1),
    four ranks (one worker each; rank r on card r mod the card count), all
    four mixings in one world.  Check: every worker row of every leaf of
    the fleet and u_k are the one-process run's bits (SHA-256 of each row),
    the u_k losses equal.  Logged per mixing: seconds per local and per
    event slot, each event's collectives split into host staging and the
    transfer, each rank's peak memory, K3 / K4 launches summed over the
    ranks.  With one card and ``backend="gloo"`` (the script's run) the
    four ranks share it and gloo moves every collective through host
    memory: those are not NCCL's times across cards
    (`tools/mesh_nccl.py` runs ``backend="nccl"`` on four cards)."""
    phase = "train-mesh" if backend == "gloo" else f"train-mesh-{backend}"
    where = (f"{backend}, {MESH_RANKS} ranks on "
             f"{min(MESH_RANKS, torch.cuda.device_count())} card(s)"
             + (", staged through host memory" if backend == "gloo" else ""))
    cfg = get_config("qwen2-0.5b")
    n_attn = _layers_of(cfg, "attn")
    runs = [dict(mll=MLLConfig(**dict(TRAIN_MLL, mixing=m)),
                 loop=_train_loop(steps=4, eval_every=4,
                                  mesh=(MESH_RANKS, 1), profile_slots=True))
            for m in MESH_MIXINGS]
    single = {}
    for name, run in zip(MESH_MIXINGS, runs):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        out = run_training(cfg, run["mll"], dataclasses.replace(
            run["loop"], mesh=None), log=lambda *a: None)
        single[name] = dict(
            rows=fleet_digests(out["train_state"].params),
            u=fleet_digests(tree_map(lambda x: x[None], out["avg_params"])),
            history=out["history"], peak_gib=torch.cuda.max_memory_allocated(
                device) / 2**30, **_slot_summary(out["slot_stats"]))
        del out
    _free(phase, device)
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn(train_rank, MESH_RANKS, cfg, runs,
                           ship="digests", backend=backend, device="cuda",
                           timeout=600)
    world_s = time.perf_counter() - t0
    rows, total = {}, {"flash_attention": 0, "flash_attention_bwd": 0}
    for k, name in enumerate(MESH_MIXINGS):
        ref = single[name]
        w = len(ref["rows"][0])
        launches = {key: sum(r[k]["launches"][key] for r in ranks)
                    for key in ("flash_attention", "flash_attention_bwd",
                                "tc_flash_attention",
                                "tc_flash_attention_bwd")}
        want = {"flash_attention": n_attn * (w * 4 + MESH_RANKS),
                "flash_attention_bwd": n_attn * w * 4}
        for key, n in want.items():
            if launches[key] != n or launches[f"tc_{key}"] != n:
                raise AssertionError(f"{phase} {name}: {key} launches "
                                     f"{launches}, expected {n}, all bf16")
            total[key] += n
        for r in ranks:
            run = r[k]
            lo, hi = run["rows"]
            for leaf, (got, want_rows) in enumerate(zip(run["state"],
                                                        ref["rows"])):
                if got != want_rows[lo:hi]:
                    raise AssertionError(f"{phase} {name}: rank rows "
                                         f"{lo}:{hi} differ at leaf {leaf}")
            if run["history"]["avg_loss"] != ref["history"]["avg_loss"]:
                raise AssertionError(f"{phase} {name}: u_k loss "
                                     f"{run['history']} != {ref['history']}")
        if ranks[0][k]["u"] != ref["u"]:
            raise AssertionError(f"{phase} {name}: u_k differs")
        rows[name] = dict(
            single_process=dict(
                peak_gib=ref["peak_gib"],
                local_slot_seconds=ref["local_slot_seconds"],
                event_slot_seconds=[e["seconds"] for e in ref["events"]]),
            ranks=[dict(rank=i, peak_gib=r[k]["peak_bytes"] / 2**30,
                        run_training_s=r[k]["seconds"],
                        **_slot_summary(r[k]["slot_stats"]))
                   for i, r in enumerate(ranks)],
            u_k_loss=ref["history"]["avg_loss"], launches=launches,
            bit_identical=True)
        log(phase, f"{name}: {json.dumps(rows[name])} ({where}) on {smi}")
    TC_LAUNCHES[phase] = dict(total)
    log(phase, f"world of {MESH_RANKS} ranks: {world_s:.1f} s for "
        f"{len(MESH_MIXINGS)} runs, start-up included")
    return dict(rows=rows, launches=total, world_seconds=world_s)


# ------------------------------------------------------ offline generation
# float32 decode against a float32 forward of the same model: the two round
# in other orders through 12-28 layers (~1e-4 of the logits at most); a
# wrong cache slot, mask, position or recurrence moves them by ~100%
F32_MAX_REL, F32_MEAN_REL = 1e-2, 1e-3


def _free(phase: str, device: torch.device) -> None:
    """Drop what earlier phases left behind, then log what is still held."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    log(phase, f"memory allocated on entry "
        f"{torch.cuda.memory_allocated(device) / 2**30} GiB, reserved "
        f"{torch.cuda.memory_reserved(device) / 2**30} GiB")


def _no_launches(phase: str) -> dict:
    """The launch counters since the last reset: the generation paths run
    no hand-written kernel (the JAX package's `generate` runs plain XLA)."""
    got = ops.launch_counts()
    log(phase, f"kernel launches on the path (none expected): {got}")
    if any(got.values()):
        raise AssertionError(f"{phase}: the plain path launched {got}")
    return got


def _relative_check(phase: str, what: str, got: torch.Tensor,
                    want: torch.Tensor, max_rel: float | None,
                    mean_rel: float) -> dict:
    """max / mean |got - want| against max_rel / mean_rel times the max /
    mean |want| (max_rel None: the max is reported, not held); raises
    beyond them or on a non-finite value."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    row = dict(max_abs=diff.max().item(), mean_abs=diff.mean().item(),
               max_ref=want.abs().max().item(),
               mean_ref=want.abs().mean().item(), max_rel=max_rel,
               mean_rel=mean_rel)
    log(phase, f"{what}: {json.dumps(row)}")
    if (not torch.isfinite(got).all()
            or (max_rel is not None
                and row["max_abs"] > max_rel * row["max_ref"])
            or row["mean_abs"] > mean_rel * row["mean_ref"]):
        raise AssertionError(f"{phase}: {what} beyond its tolerance")
    return row


@torch.inference_mode()
def dense_logits(params, cfg, seq: torch.Tensor, plen: int,
                 max_len: int) -> torch.Tensor:
    """`generate`'s dense path teacher-forced over ``seq`` (B, L): the
    batched prefill of ``seq[:, :plen]``, then decode steps fed its tokens.
    -> float32 logits at positions plen-1 .. L-2 (B, L - plen, V)."""
    state, _ = serve_step._batched_prefill(params, seq[:, :plen], cfg,
                                           max_len, prng.prng_key(0))
    out = []
    for t in range(plen - 1, seq.shape[1] - 1):
        lg, state = model_mod.decode_step(params, state,
                                          {"tokens": seq[:, t:t + 1]}, t, cfg)
        out.append(lg[:, 0].float())
    return torch.stack(out, dim=1)


@torch.inference_mode()
def loop_logits(params, cfg, seq: torch.Tensor, max_len: int, state=None
                ) -> tuple[torch.Tensor, list]:
    """Every position of ``seq`` (B, L) through `decode_step` from a fresh
    (or the given) state -> (float32 logits (B, L, V), final state)."""
    if state is None:
        state = model_mod.init_decode_state(cfg, seq.shape[0], max_len,
                                            seq.device)
    out = []
    for t in range(seq.shape[1]):
        lg, state = model_mod.decode_step(params, state,
                                          {"tokens": seq[:, t:t + 1]}, t, cfg)
        out.append(lg[:, 0].float())
    return torch.stack(out, dim=1), state


@torch.inference_mode()
def profile_dense_decode(params, cfg, prompt: torch.Tensor, max_len: int,
                         phase: str, smi: str, n: int = 5,
                         temperature: float = 0.0) -> dict:
    """Where a dense decode step's time goes: the batched prefill of
    ``prompt``, two warm steps, ``n`` steps on the host clock, then ``n``
    more under `torch.profiler`: device busy time, operations, host syncs
    and the top device operations per step.  Sampled steps (temperature
    > 0) also time ``n`` calls of `prng.categorical` alone on logits of the
    step's shape: the sampler's host time and device operations a call;
    the sampler's host time inside the traced steps is its range there."""
    from torch.profiler import ProfilerActivity, profile
    state, key = serve_step._batched_prefill(params, prompt, cfg, max_len,
                                             prng.prng_key(3))
    tok, cur = prompt[:, -1:], prompt.shape[1] - 1

    def steps(k):
        nonlocal tok, state, cur, key
        for _ in range(k):
            key, sub = prng.split(key)
            nxt, state = serve_step.serve_step(
                params, state, {"tokens": tok}, cur, cfg,
                temperature=temperature, rng=sub if temperature > 0 else None)
            tok, cur = nxt[:, None], cur + 1

    def traced(fn):
        """fn under the profiler, `prng.categorical` marked as a range ->
        (device ms by operation name, device operations, host syncs, host
        us inside the sampler)."""
        inner = prng.categorical

        def categorical(key, logits):
            with torch.profiler.record_function("categorical"):
                return inner(key, logits)
        prng.categorical = categorical
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        finally:
            prng.categorical = inner
        device_us: dict[str, float] = {}
        n_ops = syncs = sampler_us = 0
        for e in prof.events():
            if e.name == "categorical":
                # the range on the host; its device-side copy is no kernel
                if e.device_type == torch.autograd.DeviceType.CPU:
                    sampler_us += e.time_range.elapsed_us()
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                # kernels summed by the first 70 characters of their name
                # (template instances of one kernel share them)
                device_us[e.name[:70]] = (device_us.get(e.name[:70], 0.0)
                                          + e.time_range.elapsed_us())
                n_ops += 1
            elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
                syncs += 1
        return device_us, n_ops, syncs, sampler_us

    steps(2)
    _, wall = _timed(lambda: steps(n))
    device_us, n_ops, syncs, sampler_us = traced(lambda: steps(n))
    busy = sum(device_us.values()) / 1e3 / n
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    row = dict(temperature=temperature, wall_ms_per_step=wall / n,
               device_busy_ms_per_step=busy, busy_share=busy / (wall / n),
               device_ops_per_step=n_ops / n, host_syncs_per_step=syncs / n,
               sampler_host_ms_per_step=sampler_us / 1e3 / n,
               top_device_ms_per_step={k: us / 1e3 / n for k, us in top})
    if temperature > 0:
        logits = torch.randn(prompt.shape[0], cfg.vocab_size,
                             device=prompt.device)

        def sample():
            for i in range(n):
                prng.categorical((0, i), logits)
        sample()
        _, wall = _timed(sample)
        device_us, n_ops, syncs, _ = traced(sample)
        row["categorical_alone"] = dict(
            wall_ms=wall / n, device_busy_ms=sum(device_us.values()) / 1e3
            / n, device_ops=n_ops / n, host_syncs=syncs / n)
    log(phase, f"dense decode step at {prompt.shape[1]} tokens of "
        f"{max_len} slots: {json.dumps(row)} on {smi}")
    return row


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _check_tokens(phase: str, out: torch.Tensor, prompt: torch.Tensor,
                  n_new: int, vocab: int) -> None:
    if (tuple(out.shape) != (prompt.shape[0], prompt.shape[1] + n_new)
            or not torch.equal(out[:, :prompt.shape[1]], prompt)
            or int(out.min()) < 0 or int(out.max()) >= vocab):
        raise AssertionError(f"{phase}: wrong shape, prefix or token range")


def _generate_split(params, prompt: torch.Tensor, cfg, **kw
                    ) -> tuple[torch.Tensor, float, float]:
    """`serve_step.generate` with the batched prefill, its two parts timed
    inside the one call: -> (tokens, prefill ms, decode ms), the decode
    window opening when `_batched_prefill` has returned and the device has
    drained."""
    inner, marks = serve_step._batched_prefill, []

    def prefill(*args, **kwargs):
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out
    serve_step._batched_prefill = prefill
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_step.generate(params, prompt, cfg, prefill="batched",
                                  **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        serve_step._batched_prefill = inner
    (tp,) = marks
    return out, (tp - t0) * 1e3, (t1 - tp) * 1e3


def phase_generate(device: torch.device, smi: str) -> dict:
    """qwen3-1.7b at full width (28 layers, bf16, seeded random weights):
    `serve_step.generate` on 4 prompts of 512 tokens, 64 new tokens, a
    rotating dense cache of max_len 8,192 (28 x 2 x 4 x 8,192 x 8 x 128
    bf16 = 3.5 GiB, every slot read by every decode step under the
    position mask), greedy with the batched prefill, then sampled
    (temperature 0.8, seed 3).  Check 3 (bf16): its dense logits against
    `ServeEngine`'s path (K3 prefill, K6 decode) at the serve contract.
    Checks 1 and 2 (float32, full width, 6.9 GB of params): batched and
    loop prefill give the same greedy tokens, and the dense logits equal a
    teacher-forced `forward_train`."""
    _free("generate", device)
    cfg = get_config("qwen3-1.7b")
    params = model_mod.init_model(torch.Generator(device).manual_seed(7),
                                  cfg, device=device)
    b, plen, max_new, max_len = 4, 512, 64, 8192
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, plen))
                              ).to(device)
    serve_step.generate(params, prompt[:1, :8], cfg, max_new=2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    runs = {}
    for name, kw in (("greedy", {}), ("sampled", dict(temperature=0.8,
                                                      seed=3))):
        out, prefill_ms, decode_ms = _generate_split(
            params, prompt, cfg, max_new=max_new, max_len=max_len, **kw)
        _check_tokens("generate", out, prompt, max_new, cfg.vocab_size)
        runs[name] = dict(
            tokens=out, wall_ms=prefill_ms + decode_ms,
            prefill_ms=prefill_ms, decode_ms_per_step=decode_ms / max_new,
            decode_tokens_per_s=b * max_new / (decode_ms / 1e3),
            tokens_per_s=b * max_new / ((prefill_ms + decode_ms) / 1e3))
    launches = _no_launches("generate")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    row = {name: {k: v for k, v in r.items() if k != "tokens"}
           for name, r in runs.items()}
    row.update(peak_gib=peak, batch=b, prompt=plen,
               max_new=max_new, max_len=max_len,
               cache_gib=cfg.num_layers * 2 * b * max_len * cfg.n_kv_heads
               * cfg.resolved_head_dim * 2 / 2**30)
    log("generate", f"{cfg.name}: {json.dumps(row)} on {smi}")
    greedy = runs["greedy"]["tokens"]
    if torch.equal(greedy, runs["sampled"]["tokens"]):
        raise AssertionError("generate: sampling gave the greedy tokens")

    # check 3: generate's dense logits (bit for bit its own: their argmax is
    # the greedy output) against the paged path through K3 and K6
    dense = dense_logits(params, cfg, greedy, plen, max_len)
    if not torch.equal(dense.argmax(-1), greedy[:, plen:]):
        raise AssertionError("generate: the greedy tokens are not the "
                             "argmax of the dense path's logits")
    paged = teacher_forced_logits(
        params, cfg, [p for p in prompt.cpu().numpy()],
        greedy[:, plen:].tolist(), "flash", device)
    row["check3_dense_vs_paged_flash"] = _relative_check(
        "generate", "check 3, bf16: dense logits vs ServeEngine's K3 + K6 "
        "path", paged, dense, MAX_REL, MEAN_REL)
    agree = (paged.argmax(-1) == dense.argmax(-1)).float().mean().item()
    log("generate", f"check 3: argmax agreement {agree} (floor "
        f"{MIN_ARGMAX_AGREEMENT})")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError("generate: argmax agreement below the floor")
    row["profile"] = profile_dense_decode(params, cfg, prompt, max_len,
                                          "generate", smi)
    row["profile_sampled"] = profile_dense_decode(
        params, cfg, prompt, max_len, "generate", smi, temperature=0.8)
    del params, dense, paged, runs, greedy
    _free("generate", device)

    # checks 1 and 2, float32 at full width
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = model_mod.init_model(torch.Generator(device).manual_seed(8),
                                  f32, device=device)
    p1 = prompt[:1, :64]
    out = {pf: serve_step.generate(params, p1, f32, max_new=16, prefill=pf)
           for pf in ("batched", "loop")}
    new = {pf: o[0, 64:].tolist() for pf, o in out.items()}
    log("generate", f"check 1, float32: batched {new['batched']} loop "
        f"{new['loop']}")
    if not torch.equal(out["batched"], out["loop"]):
        raise AssertionError("generate: batched and loop prefill disagree")
    seq = out["batched"]
    dense = dense_logits(params, f32, seq, 64, 80)
    with torch.inference_mode():
        train, _ = model_mod.forward_train(params, {"tokens": seq}, f32,
                                           impl="plain")
    row["check2_dense_vs_forward_train_f32"] = _relative_check(
        "generate", "check 2, float32: dense decode logits vs teacher-forced "
        "forward_train", dense, train[:, 63:-1], F32_MAX_REL, F32_MEAN_REL)
    if not torch.equal(train[:, 63:-1].argmax(-1), seq[:, 64:]):
        raise AssertionError("generate: forward_train's argmax is not the "
                             "generated text")
    row["launches"] = launches
    del params, dense, train, out
    return row


def phase_generate_xlstm(device: torch.device, smi: str) -> dict:
    """xlstm-125m at full width (6 x (mLSTM, sLSTM), bf16 with float32 gate
    leaves): `generate` with prefill="auto" (the loop, for a recurrent
    pattern) on 4 prompts of 128 tokens, 32 new.  Check (float32): the
    per-token `decode_step` logits over 128 positions equal
    `forward_train`'s (the JAX package's test_decode_matches_train_forward
    at full width)."""
    _free("generate-xlstm", device)
    cfg = get_config("xlstm-125m")
    params = model_mod.init_model(torch.Generator(device).manual_seed(9),
                                  cfg, device=device)
    b, plen, max_new = 4, 128, 32
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        1, cfg.vocab_size, (b, plen))).to(device)
    serve_step.generate(params, prompt[:1, :4], cfg, max_new=2)   # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    out, ms = _timed(lambda: serve_step.generate(params, prompt, cfg,
                                                 max_new=max_new))
    _check_tokens("generate-xlstm", out, prompt, max_new, cfg.vocab_size)
    launches = _no_launches("generate-xlstm")
    steps = plen - 1 + max_new
    row = dict(wall_ms=ms, steps=steps, ms_per_step=ms / steps,
               tokens_per_s=b * max_new / (ms / 1e3),
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               launches=launches)
    log("generate-xlstm", f"{cfg.name}: {json.dumps(row)} on {smi}")
    del params
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = model_mod.init_model(torch.Generator(device).manual_seed(10),
                                  f32, device=device)
    seq = out[:2, :plen]
    dec, _ = loop_logits(params, f32, seq, plen)
    with torch.inference_mode():
        train, _ = model_mod.forward_train(params, {"tokens": seq}, f32,
                                           impl="plain")
    row["check_decode_vs_forward_train_f32"] = _relative_check(
        "generate-xlstm", "float32 decode_step vs forward_train, 128 "
        "positions", dec, train, F32_MAX_REL, F32_MEAN_REL)
    del params, dec, train
    return row


def _routed(fn, *args, **kwargs) -> tuple[object, list[torch.Tensor]]:
    """``fn(*args, **kwargs)`` with the experts of every `moe.top_k` call
    recorded -> (fn's result, one (tokens, k) tensor a call, in call
    order, the tokens in their flat (batch, position) order)."""
    inner, calls = moe_mod.top_k, []

    def top_k(probs, k):
        vals, idx = inner(probs, k)
        calls.append(idx.reshape(-1, k))
        return vals, idx
    moe_mod.top_k = top_k
    try:
        out = fn(*args, **kwargs)
    finally:
        moe_mod.top_k = inner
    return out, calls


def _routing_flips(dec_calls: list[torch.Tensor],
                   train_calls: list[torch.Tensor], b: int, s: int
                   ) -> torch.Tensor:
    """Where the decode loop (a call a MoE layer and position, each of b
    tokens) and the forward (a call a MoE layer, of b * s tokens) chose
    another set of top-k experts -> bool (MoE layers, b, s)."""
    n_moe, k = len(train_calls), dec_calls[0].shape[-1]
    dec = torch.stack(dec_calls).reshape(s, n_moe, b, k).permute(1, 2, 0, 3)
    train = torch.stack(train_calls).reshape(n_moe, b, s, k)
    return (dec.sort(-1).values != train.sort(-1).values).any(-1)


def phase_generate_jamba(device: torch.device, smi: str) -> dict:
    """jamba-v0.1-52b at full width cut from 32 to 8 layers: one
    super-block of 7 mamba layers and 1 attention layer, 4 MoE layers of
    16 experts top-2 (d_ff 14,336), ~13.3 B params in bf16.  `generate`
    with the loop prefill on 2 prompts of 64 tokens, 16 new.  Checks
    (capacity factor 8, so the forward drops no token): the
    teacher-forced `decode_step` logits against `forward_train` in bf16,
    at the serve contract on every position whose top-2 experts agree
    between the two paths (the experts of both recorded), its mean and
    argmax floor over all; then the same weights cast to float32 (53 GB)
    at float32's limits; the decode state changed and every output is
    finite."""
    _free("generate-jamba", device)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    t0 = time.perf_counter()
    params = model_mod.init_model(torch.Generator(device).manual_seed(11),
                                  cfg, device=device)
    torch.cuda.synchronize()
    n_params = model_mod.count_params(params)
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    log("generate-jamba", f"{cfg.name} cut to {cfg.num_layers} layers "
        f"(pattern {cfg.pattern}, MoE at {cfg.moe_positions}): {n_params} "
        f"params, {weight_bytes / 1e9} GB, initialised in "
        f"{time.perf_counter() - t0} s")
    b, plen, max_new = 2, 64, 16
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        1, cfg.vocab_size, (b, plen))).to(device)
    serve_step.generate(params, prompt[:, :2], cfg, max_new=1)   # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    out, ms = _timed(lambda: serve_step.generate(
        params, prompt, cfg, max_new=max_new, prefill="loop"))
    _check_tokens("generate-jamba", out, prompt, max_new, cfg.vocab_size)
    launches = _no_launches("generate-jamba")
    steps = plen - 1 + max_new
    row = dict(wall_ms=ms, steps=steps, ms_per_step=ms / steps,
               floor_ms_per_step=weight_bytes / PEAK_BYTES * 1e3,
               tokens_per_s=b * max_new / (ms / 1e3),
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               params=n_params, weight_gb=weight_bytes / 1e9,
               launches=launches)
    log("generate-jamba", f"{json.dumps(row)} (the floor: every expert's "
        f"capacity buffer runs, so a step reads all the weights at "
        f"{PEAK_BYTES / 1e12} TB/s) on {smi}")
    wide = dataclasses.replace(cfg, capacity_factor=8.0)
    seq_len = out.shape[1]
    state = model_mod.init_decode_state(wide, b, seq_len, device)
    fresh = tree_map(torch.clone, state)
    (dec, state), dec_route = _routed(loop_logits, params, wide, out,
                                      seq_len, state)
    with torch.inference_mode():
        (train, _), train_route = _routed(
            model_mod.forward_train, params, {"tokens": out}, wide,
            impl="plain")
    # bf16: the two paths round the router's input differently, so where
    # a token's second and third expert lie close it can take another
    # expert on one side, and its logits then move by tens of percent.
    # The serve contract holds in full on every position whose top-2
    # experts agree at every MoE layer; the mean and the argmax floor hold
    # over all positions; the flipped positions are reported apart
    flips = _routing_flips(dec_route, train_route, b, seq_len)
    flipped = flips.any(0)                                    # (b, s)
    scale = train.abs().max().item()
    rel = ((dec - train).abs().amax(-1) / scale).cpu()         # (b, s)
    earlier = (flipped.long().cumsum(-1) - flipped.long()).bool().cpu()
    flipped = flipped.cpu()
    over = [dict(row=i, pos=j, rel=rel[i, j].item(),
                 flipped=bool(flipped[i, j]), earlier_flip=bool(earlier[i, j]))
            for i, j in (rel > MAX_REL).nonzero().tolist()]
    routing = dict(positions=b * seq_len, flipped=int(flipped.sum()),
                   flips_by_moe_layer=flips.sum((1, 2)).tolist(),
                   flipped_positions=[dict(row=i, pos=j, rel=rel[i, j].item())
                                      for i, j in flipped.nonzero().tolist()],
                   beyond_max_rel=over)
    log("generate-jamba", f"bf16 routing, decode vs forward_train: "
        f"{json.dumps(routing)}")
    if 2 * int(flipped.sum()) > b * seq_len:
        raise AssertionError("generate-jamba: the routing differs on more "
                             "than half the positions")
    agree = ~flipped.to(device)
    row["routing_bf16"] = routing
    row["check_decode_vs_forward_train_bf16"] = _relative_check(
        "generate-jamba", f"bf16 decode_step vs forward_train (capacity "
        f"factor 8), the {int(agree.sum())} positions whose routing agrees",
        dec[agree], train[agree], MAX_REL, MEAN_REL)
    row["check_decode_vs_forward_train_bf16_all"] = _relative_check(
        "generate-jamba", f"bf16 decode_step vs forward_train (capacity "
        f"factor 8), all {b * seq_len} positions", dec, train, None,
        MEAN_REL)
    argmax = (dec.argmax(-1) == train.argmax(-1)).float().mean().item()
    row["check_decode_vs_forward_train_bf16_all"]["argmax_agreement"] = argmax
    leaves = tree_leaves(state)
    unchanged = [i for i, (a, z) in enumerate(zip(tree_leaves(fresh), leaves))
                 if torch.equal(a, z)]
    finite = all(bool(torch.isfinite(x.float()).all()) for x in leaves)
    log("generate-jamba", f"decode state: {len(leaves)} leaves, unchanged "
        f"{unchanged}, all finite {finite}; bf16 argmax agreement {argmax} "
        f"(floor {MIN_ARGMAX_AGREEMENT})")
    if (unchanged or not finite or not torch.isfinite(dec).all()
            or argmax < MIN_ARGMAX_AGREEMENT):
        raise AssertionError("generate-jamba: a state leaf did not change, "
                             "an output is not finite or the argmax "
                             "agreement is below the floor")
    del state, fresh, dec, train
    # float32 at full width: the same weights that generated, cast up one
    # leaf at a time (53 GB; the bf16 copy shrinks as the float32 grows)
    _free("generate-jamba", device)
    for leaf in tree_leaves(params):
        if leaf.is_floating_point():
            leaf.data = leaf.data.float()
    f32 = dataclasses.replace(wide, param_dtype="float32",
                              compute_dtype="float32")
    (dec, _), dec_route = _routed(loop_logits, params, f32, out, seq_len)
    with torch.inference_mode():
        (train, _), train_route = _routed(
            model_mod.forward_train, params, {"tokens": out}, f32,
            impl="plain")
    flips = _routing_flips(dec_route, train_route, b, seq_len)
    row["routing_f32_flipped"] = int(flips.any(0).sum())
    log("generate-jamba", f"float32 routing, decode vs forward_train: "
        f"{row['routing_f32_flipped']} of {b * seq_len} positions flipped")
    row["check_decode_vs_forward_train_f32"] = _relative_check(
        "generate-jamba", f"float32 decode_step vs forward_train (capacity "
        f"factor 8), all {b * seq_len} positions", dec, train, F32_MAX_REL,
        F32_MEAN_REL)
    row["f32_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del params, dec, train
    return row


def phase_chunked(timer: Timer, device: torch.device, smi: str) -> dict:
    """One qwen3-1.7b attention geometry (16 / 8 heads of 128), B = 1,
    T = 8,192, bf16, causal: `_sdpa_chunked` (query chunks of 512), the
    plain `_sdpa` (float32 scores of 4.3 GB), K3 and SDPA.  Chunked
    against plain and SDPA against plain within the bf16 tolerance of
    `kernels/tolerance.py`, K3 against its plain version (in
    `measure_fwd`) and against the plain `_sdpa` there too.  -> K3's
    measurement at this shape, with the other three's times."""
    _free("chunked", device)
    cfg = get_config("qwen3-1.7b")
    gen = torch.Generator(device).manual_seed(12)
    b, t = 1, 8192
    h, hkv, hd = GEOMETRIES["qwen3-1.7b"]
    q, k, v = (torch.randn(b, t, n, hd, generator=gen, device=device)
               .to(torch.bfloat16) for n in (h, hkv, hkv))
    mask = attn_mod.causal_mask(t, t, 0, device=device)[None]
    with torch.inference_mode():
        plain = attn_mod._sdpa(q, k, v, cfg, mask)
        chunked = attn_mod._sdpa_chunked(q, k, v, cfg)
        flash = ops.flash_attention(q, k, v, causal=True)
        sdpa = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.repeat_interleave(h // hkv, 2).transpose(1, 2),
            v.repeat_interleave(h // hkv, 2).transpose(1, 2),
            is_causal=True).transpose(1, 2)
    tol = TOL[torch.bfloat16]
    errs = {"chunked_vs_plain": _close(chunked, plain, tol),
            "k3_vs_plain": _close(flash, plain, tol),
            "sdpa_vs_plain": _close(sdpa, plain, tol)}
    del plain, chunked, flash, sdpa
    torch.cuda.empty_cache()
    k3 = measure_fwd(timer, q, k, v, 0, 0.0)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats(device)
        plain_ms = timer.ms(lambda: attn_mod._sdpa(q, k, v, cfg, mask), 3)
        plain_peak = torch.cuda.max_memory_allocated(device) / 2**30
        torch.cuda.reset_peak_memory_stats(device)
        chunked_ms = timer.ms(lambda: attn_mod._sdpa_chunked(q, k, v, cfg))
        chunked_peak = torch.cuda.max_memory_allocated(device) / 2**30
    row = dict(q=[b, t, h, hd], errors=errs, errors_tolerance=tol,
               sdpa_plain_ms=plain_ms, sdpa_plain_peak_gib=plain_peak,
               sdpa_chunked_ms=chunked_ms,
               sdpa_chunked_peak_gib=chunked_peak, **k3)
    log("chunked", f"{json.dumps(row)} on {smi}")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log("device", f"{smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", f"nvcc seconds per source {secs}; wall "
        f"{time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    ptxas = {}
    for stem in secs:
        text = (build.BUILD_DIR / f"{stem}.log").read_text()
        ptxas[stem] = ptxas_report(text)
        log("build", f"{stem}: ptxas {json.dumps(ptxas[stem])}")
        for line in text.splitlines():
            if "wgmma" in line or "arning" in line:
                log("build", f"{stem}: {line.strip()}")
    # blocks of the bf16 tensor-core kernels resident on one SM at once
    blocks_per_sm = {
        stem: {f"hd {hd}": build.load(stem, f"{stem}_blocks_per_sm",
                                      [ctypes.c_int])(hd) for hd in (64, 128)}
        for stem in ("flash_fwd", "flash_bwd")}
    log("build", f"blocks per SM: {json.dumps(blocks_per_sm)}")

    timer = Timer(device)
    phase_kernels(timer, device)
    cfg = get_config("qwen3-1.7b")
    params, reqs, out, launches, rec = phase_serve(cfg, device, smi)
    phase_profile(cfg, params, device, smi)
    by_prompt = sorted(reqs, key=lambda r: len(r.prompt))
    phase_parity(cfg, params, [by_prompt[0], by_prompt[-1]], out, device)

    q, k, v, kw = rec.fwd
    k3 = measure_fwd(timer, q, k, v, kw["window"], kw["softcap"])
    rec_shape = q.shape
    log("report", f"K3 at the main path's largest prefill q {tuple(q.shape)}"
        f" k {tuple(k.shape)}: {json.dumps(k3)}")
    q, kp, vp, tables, lengths, kw = rec.busiest_decode()
    k6 = measure_decode(timer, q, kp, vp, tables, lengths, kw["window"],
                        kw["softcap"])
    log("report", f"K6 at the main path's busiest decode tick, lengths "
        f"{lengths.tolist()} pools {tuple(kp.shape)}, {k6['splits']} splits:"
        f" {json.dumps(k6)}")
    k6_shapes = {"serve-busiest-tick": dict(
        lengths=lengths.tolist(), ms=k6["ms"], splits=k6["splits"])}
    # one long lane, where the split count matters most: qwen3 geometry
    h, hkv, hd = GEOMETRIES["qwen3-1.7b"]
    gen = torch.Generator(device).manual_seed(5)
    n_pages = 4096 // 16
    lane = [torch.randn(*shape, generator=gen, device=device)
            .to(torch.bfloat16) for shape in
            ((1, h, hd), (n_pages, 16, hkv, hd), (n_pages, 16, hkv, hd))]
    lane += [torch.randperm(n_pages, generator=gen, device=device).int()
             [None], torch.tensor([4096], dtype=torch.int32, device=device)]
    k6_shapes["one-lane-4096"] = dict(lengths=[4096], **measure_decode(
        timer, *lane, 0, 0.0))
    log("report", f"K6 at one 4,096-token qwen3 lane, "
        f"{k6_shapes['one-lane-4096']['splits']} splits: "
        f"{json.dumps(k6_shapes['one-lane-4096'])}")
    del params, reqs, out, rec, q, k, v, kp, vp, tables, lengths, lane
    torch.cuda.empty_cache()
    group16_launches = phase_serve_group16(device, smi)
    torch.cuda.empty_cache()

    phase_train_kernels(timer, device)
    trained, mll, train_launches, bwd_rec, _ = phase_train(cfg, device, smi)
    state = phase_train_profile(cfg, trained, mll, device, smi)
    worker0 = tree_map(lambda x: x[0].clone(), state.params)
    u_k = trained["avg_params"]
    del trained, state
    torch.cuda.empty_cache()
    phase_train_parity(cfg, worker0, device)
    del worker0
    torch.cuda.empty_cache()
    phase_serve_uk(cfg, u_k, device)
    del u_k
    torch.cuda.empty_cache()
    phase_resume(device)
    ladder = phase_train_ladder(device, smi)
    torch.cuda.empty_cache()
    overlap = phase_train_overlap(cfg, device, smi)
    torch.cuda.empty_cache()
    mesh = phase_train_mesh(device, smi)
    torch.cuda.empty_cache()

    q, k, v, o, lse, do, kw = bwd_rec.call
    k4 = measure_bwd(timer, q, k, v, o, lse, do, kw["causal"], kw["window"],
                     kw["softcap"])
    log("report", f"K4 at the training path's shapes q {tuple(q.shape)} k "
        f"{tuple(k.shape)} {str(q.dtype)[6:]}: {json.dumps(k4)}")
    # K3 at the shapes that launch it most: training and simulation
    k3_shapes = {"serve": dict(q=list(rec_shape), ms=k3["ms"])}
    k3_shapes["train"] = dict(q=list(q.shape), **measure_fwd(
        timer, q.detach(), k.detach(), v.detach(), kw["window"],
        kw["softcap"], kw["causal"]))
    gen = torch.Generator(device).manual_seed(2)
    qs, ks, vs = (torch.randn(4, 128, hh, 64, generator=gen, device=device)
                  .to(torch.bfloat16) for hh in (14, 2, 2))
    k3_shapes["sim-qwen2"] = dict(q=list(qs.shape), **measure_fwd(
        timer, qs, ks, vs, 0, 0.0))
    for path in ("train", "sim-qwen2"):
        log("report", f"K3 at the {path} path's shape q "
            f"{tuple(k3_shapes[path]['q'])}: {json.dumps(k3_shapes[path])}")
    del q, k, v, o, lse, do, bwd_rec, qs, ks, vs
    torch.cuda.empty_cache()

    xl_launches, k7, k8 = phase_xlstm(timer, device, smi)

    mix = phase_sim_kernels(timer, device, smi)
    sim_launches = phase_sim(device, smi)
    paper_launches = phase_sim_paper(device, smi)
    phase_generate(device, smi)
    phase_generate_xlstm(device, smi)
    phase_generate_jamba(device, smi)
    k3_shapes["chunked-8192"] = phase_chunked(timer, device, smi)
    log("report", f"K3 at the chunked phase's shape q (1, 8192, 16, 128): "
        f"{json.dumps(k3_shapes['chunked-8192'])}")
    src = "src/repro_torch/csrc/hier_mix.cu"

    def mix_entry(key, name, line):
        by_path = {"sim-qwen2": sim_launches[key],
                   "sim-paper": paper_launches[key]}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"{key} was launched no time on its path")
        return dict(name=name, route="cuda", source=src,
                    replaces=f"src/repro/kernels/hier_mix.py:{line}",
                    launches=sum(by_path.values()),
                    launches_by_path=by_path, **mix[key])
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_attention.py:148",
             launches=launches["flash_attention"]
             + group16_launches["flash_attention"]
             + train_launches["flash_attention"]
             + ladder["launches"]["flash_attention"]
             + overlap["launches"]["flash_attention"]
             + mesh["launches"]["flash_attention"] + sim_launches["K3"],
             launches_by_path={
                 "serve": launches["flash_attention"],
                 "serve-group16": group16_launches["flash_attention"],
                 "train": train_launches["flash_attention"],
                 "train-ladder": ladder["launches"]["flash_attention"],
                 "train-overlap": overlap["launches"]["flash_attention"],
                 "train-mesh": mesh["launches"]["flash_attention"],
                 "sim-qwen2": sim_launches["K3"]},
             tensor_core_launches_by_path={
                 path: n["flash_attention"] for path, n in TC_LAUNCHES.items()
                 if n["flash_attention"]},
             shapes=k3_shapes,
             ptxas={k: v for k, v in ptxas["flash_fwd"].items()
                    if "tc_kernel" in k},
             blocks_per_sm=blocks_per_sm["flash_fwd"],
             **k3),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_attention.py:282",
             launches=launches["flash_decode"]
             + group16_launches["flash_decode"],
             launches_by_path={
                 "serve": launches["flash_decode"],
                 "serve-group16": group16_launches["flash_decode"]},
             shapes=k6_shapes, ptxas=ptxas["flash_decode"], **k6),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:473",
             launches=train_launches["flash_attention_bwd"]
             + ladder["launches"]["flash_attention_bwd"]
             + overlap["launches"]["flash_attention_bwd"]
             + mesh["launches"]["flash_attention_bwd"]
             + sim_launches["K4"],
             launches_by_path={
                 "train": train_launches["flash_attention_bwd"],
                 "train-ladder": ladder["launches"]["flash_attention_bwd"],
                 "train-overlap": overlap["launches"]["flash_attention_bwd"],
                 "train-mesh": mesh["launches"]["flash_attention_bwd"],
                 "sim-qwen2": sim_launches["K4"]},
             tensor_core_launches_by_path={
                 path: n["flash_attention_bwd"]
                 for path, n in TC_LAUNCHES.items()
                 if n["flash_attention_bwd"]},
             ptxas={k: v for k, v in ptxas["flash_bwd"].items()
                    if "tc_kernel" in k or "group_sum" in k
                    or "delta" in k},
             blocks_per_sm=blocks_per_sm["flash_bwd"],
             **k4),
        dict(name="slstm_scan", route="cuda",
             source="src/repro_torch/csrc/slstm_scan.cu",
             replaces="src/repro/kernels/slstm_scan.py:118",
             launches=xl_launches["slstm_scan"],
             launches_by_path={"train-xlstm": xl_launches["slstm_scan"]},
             **k7),
        dict(name="slstm_scan_bwd", route="cuda",
             source="src/repro_torch/csrc/slstm_scan.cu",
             replaces="src/repro/kernels/slstm_scan.py:292",
             launches=xl_launches["slstm_scan_bwd"],
             launches_by_path={"train-xlstm": xl_launches["slstm_scan_bwd"]},
             **k8),
        mix_entry("K1a", "hier_mix_chunks (K1a, per leaf)", 94),
        mix_entry("K1b", "hier_mix_packed dense (K1b)", 202),
        mix_entry("K2", "hier_mix_packed grouped (K2)", 72),
        mix_entry("K5", "hier_mix_packed_chunked (K5)", 283),
    ]
    log("report", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
