#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU: build, check, serve and train.

    python3 chip_smoke.py            # from the repository root

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- requires CUDA; prints the card, its power limit, torch and CUDA
   versions; turns TF32 off for every float32 product.
2. build   -- nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a, one
   process per source, into ``build/repro_torch/``.
3. kernels -- each hand-written kernel against its plain PyTorch version on
   the card, bf16 and float32, at the qwen3-1.7b (H 16 / Hkv 8 / hd 128) and
   qwen2-0.5b (H 14 / Hkv 2 / hd 64) geometries, with window and softcap
   cases; kernel, plain and library times beside the card's bound.
4. serve   -- `ServeEngine` on qwen3-1.7b at full width (28 layers, bf16,
   seeded random weights) serves 8 Poisson requests through 4 lanes with
   the kernels (``impl="flash"``); the launch counters show every prefill
   went through the flash-attention kernel and every decode tick through
   the paged flash-decode kernel, 28 launches each.
5. parity  -- two served requests teacher-forced through ``impl="flash"``
   and ``impl="plain"`` on the same block tables: logits at every generated
   position agree within the bf16 tolerance.
6. train-kernels -- the flash-attention backward (K4) against its plain
   version in bf16 and float32, at the training path's geometry, head_dim
   64 and 128, with GQA, a window and a softcap, each output held to its
   own scale; two runs of K4 on the same inputs give the same bits.
7. train   -- `launch.train.run_training` trains qwen3-1.7b at full width
   (28 layers, bf16, seeded random weights) as W = 4 workers (2 subnets x
   2 on a ring hub graph, rates 1.0/0.8/1.0/0.6), two_stage mixing, the
   deadline policy, tau = q = 2, 8 slots of 4 x 128 tokens per worker,
   through K3 forward and K4 backward; the launch counters show 28 K4
   launches per worker and slot.  One more slot runs under the profiler.
8. train-parity -- one worker's gradients on one batch, ``impl="flash"``
   against ``impl="plain"``, at full width: per-leaf relative error.
9. uk-serve -- the trained u_k served in memory by `ServeEngine`.
10. resume -- at the smoke config (a full-width full-state checkpoint is
   ~30 GB on disk): killed at slot 4 and resumed = the uninterrupted run,
   bit for bit; `ServeEngine.from_checkpoint` serves that directory.
11. report -- one ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

Without a GPU, or away from the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import interop  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.mllsgd import MLLConfig, build_state  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import harness as harness_mod  # noqa: E402
from repro_torch.launch.train import TrainLoopConfig, run_training  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.serve import kv_cache as kvc  # noqa: E402
from repro_torch.serve.engine import (PROMPT_PAD, EngineConfig,  # noqa: E402
                                      ServeEngine, poisson_arrivals)
from repro_torch.train.train_step import per_worker_grads  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel call
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain on the same inputs: float32 differs by summation order
# only; bf16 outputs may round to neighbouring bf16 values (2^-8 relative)
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-4)     # lse is float32 on both sides
# served logits, flash vs plain path, after 28 bf16 layers (phase 5): the
# two paths round attention to bf16 at other places, a noise of ~1% of the
# logits; a wrong kernel (head, position, mask) moves them by ~100%.  With
# 151936 random-weight logits the top two often lie closer than that noise,
# so argmax agreement is reported with a floor that only catches garbage.
MAX_REL, MEAN_REL, MIN_ARGMAX_AGREEMENT = 0.25, 0.05, 0.5
GEOMETRIES = {"qwen3-1.7b": (16, 8, 128), "qwen2-0.5b": (14, 2, 64)}
MASKING = [(0, 0.0), (256, 0.0), (0, 30.0)]          # (window, softcap)
DECODE_LENGTHS = [0, 1, 17, 255, 1000, 2048, 4096, 4097]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
class Timer:
    """Mean device time of a call, each launch after a write of 128 MiB so
    it starts with a cold 50 MB L2, as the real caller finds it."""

    def __init__(self, device: torch.device):
        self.flush = torch.empty(32 * 2**20, dtype=torch.float32,
                                 device=device)

    def ms(self, fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps


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


# ---------------------------------------------------------- K3 measurement
def fwd_live_pairs(t: int, s: int, window: int) -> int:
    """(query, key) pairs that causal + window masking leaves live."""
    i = np.arange(t)
    hi = np.minimum(i, s - 1) + 1
    lo = np.maximum(0, i - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo).sum())


def measure_fwd(timer: Timer, q, k, v, window: int, softcap: float) -> dict:
    """K3 against its plain version on (q, k, v): error, times, bound."""
    o, lse = ops.flash_attention_fwd_res(q, k, v, window=window,
                                         softcap=softcap)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, window=window,
                                                   softcap=softcap)
    err = max(_close(o, want_o, TOL[q.dtype]),
              _close(lse, want_lse, LSE_TOL))
    b, t, h, hd = q.shape
    es = q.element_size()
    bytes_ = es * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    flops = 4 * hd * h * b * fwd_live_pairs(t, k.shape[1], window)
    bound_ms, bound_by = _bound(bytes_, flops, q.dtype)
    library_ms = None
    if softcap == 0.0:     # SDPA has no softcap; GQA expanded outside the call
        group = h // k.shape[2]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(group, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(group, dim=2).transpose(1, 2)
        mask = None
        if window > 0:
            qp = torch.arange(t, device=q.device)[:, None]
            kp = torch.arange(k.shape[1], device=q.device)[None, :]
            mask = (kp <= qp) & (qp - kp < window)
        library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None))
    return {"max_abs_err": err, "tolerance": TOL[q.dtype],
            "ms": timer.ms(lambda: ops.flash_attention_fwd_res(
                q, k, v, window=window, softcap=softcap)),
            "plain_ms": timer.ms(lambda: ref.flash_attention_fwd_ref(
                q, k, v, window=window, softcap=softcap)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---------------------------------------------------------- K6 measurement
def measure_decode(timer: Timer, q, k_pool, v_pool, tables, lengths,
                   window: int, softcap: float) -> dict:
    """K6 against its plain version: error, times, bound."""
    out = ops.flash_decode(q, k_pool, v_pool, tables, lengths,
                           window=window, softcap=softcap)
    want = ref.flash_decode_ref(q, k_pool, v_pool, tables, lengths,
                                window=window, softcap=softcap)
    err = _close(out, want, TOL[q.dtype])
    dead = lengths == 0
    if dead.any() and (out[dead] != 0).any():
        raise AssertionError("a lane of length 0 is not exactly zero")
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
    return {"max_abs_err": err, "tolerance": TOL[q.dtype],
            "ms": timer.ms(lambda: ops.flash_decode(
                q, k_pool, v_pool, tables, lengths, window=window,
                softcap=softcap)),
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


def phase_parity(cfg, params, reqs, out, device: torch.device) -> None:
    pick = sorted(reqs, key=lambda r: len(r.prompt))
    pick = [pick[0], pick[-1]]                # shortest and longest prompt
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
    log("parity", f"requests {[r.rid for r in pick]} "
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


# ------------------------------------------------------ K4 measurement
# (b, t, s, h, hkv, hd, causal, window, softcap) for the K4 checks: the
# training path's geometry, both head dims, GQA groups 2 and 7, window,
# softcap, T % 64 != 0, T != S
BWD_CASES = [(4, 128, 128, 16, 8, 128, True, 0, 0.0),
             (2, 512, 512, 16, 8, 128, True, 0, 0.0),
             (2, 300, 300, 14, 2, 64, True, 100, 0.0),
             (2, 200, 200, 8, 4, 128, True, 0, 30.0),
             (2, 190, 260, 4, 2, 64, False, 0, 0.0)]
# dq/dk/dv, kernel vs plain, each output held to its own scale (a
# loss-gradient `do` makes them ~1e-5, unit inputs ~10): every element
# within atol_of_max * max|want| + rtol * |want|, and the relative norm
# error ||got - want|| / ||want|| within rel_norm.  float32 differs by
# summation order; bf16 by one rounding of each output (2^-9 relative).
BWD_TOL = {torch.float32: dict(atol_of_max=1e-4, rtol=1e-4, rel_norm=1e-4),
           torch.bfloat16: dict(atol_of_max=1e-2, rtol=1e-2, rel_norm=1e-2)}


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
    library_ms = None
    if softcap == 0.0 and window == 0:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)
        library_ms = timer.ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
    return {"max_abs_err": max(e for e, _ in errs),
            "rel_err": max(r for _, r in errs),
            "max_abs_out": [w.abs().max().item() for w in want],
            "tolerance": BWD_TOL[q.dtype], "deterministic": True,
            "ms": timer.ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse,
                                                           do, **kw)),
            "plain_ms": timer.ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, **kw)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def phase_train(cfg, device: torch.device, smi: str):
    mll = MLLConfig(**TRAIN_MLL)
    loop = _train_loop()
    logs = []
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    with BwdRecorder() as rec, SlotClock() as clock:
        out = run_training(cfg, mll, loop, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_attention_bwd": ops.flash_attention_bwd.launches,
                "flash_decode": ops.flash_decode.launches}
    for line in logs:
        log("train", line)
    plan, hist = out["plan"], out["history"]
    w = out["network"].num_workers
    grad_slots = sum(1 for s in range(plan.slots) if not (
        plan.gate_mode == "forced" and not plan.active[s].any()))
    n_evals = len(hist["step"])
    want = {"flash_attention": cfg.num_layers * (w * grad_slots + n_evals),
            "flash_attention_bwd": cfg.num_layers * w * grad_slots,
            "flash_decode": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if not np.isfinite(hist["avg_loss"]).all() or not np.isfinite(
            hist["loss"]).all():
        raise AssertionError(f"non-finite loss history {hist}")
    secs = clock.seconds
    seq_tokens = loop.batch_per_worker * loop.seq_len
    counts = out["train_state"].opt_state["counts"].tolist()
    steady = secs[1:]
    log("train", f"plan {plan.gate_mode}: {len(plan.events)} events "
        f"{[(e.slot, e.kind) for e in plan.events]}; counts {counts}")
    log("train", f"u_k loss {hist['avg_loss']} at slots {hist['step']}; "
        f"worker loss {hist['loss']}")
    # every worker computes its gradients each slot (W*B*S processed
    # tokens); only the gated-in ones apply them (sum(counts)*B*S applied)
    log("train", f"seconds per slot {secs}; first slot {secs[0]} s, steady "
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
    return out, mll, launches, rec


def phase_train_profile(cfg, out, mll, device: torch.device, smi: str):
    """Two more local slots of the trained fleet: the first timed on the
    host clock without the profiler, the second under `torch.profiler` for
    the device's busy time and the top device time."""
    from torch.profiler import ProfilerActivity, profile
    st = build_state(mll, out["network"], device=device)
    h = harness_mod.TrainHarness(cfg, mll, st, gate_mode="bernoulli")
    tokens = torch.randint(1, cfg.vocab_size, (4, 4, 129),
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
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    log("train", f"local slot (W=4 fwd+bwd+update): wall {wall_ms} ms "
        f"(no profiler; {prof_ms} ms under it); device busy {busy_ms} ms "
        f"({100 * busy_ms / wall_ms}% of the wall), {n_ops} device "
        f"operations; top: "
        + "; ".join(f"{name[:50]} {us / 1e3} ms" for name, us in top)
        + f" on {smi}")
    return state


def phase_train_parity(cfg, worker0: dict, device: torch.device) -> None:
    """Full-width gradients of one worker on one batch, flash vs plain."""
    tokens = torch.randint(1, cfg.vocab_size, (1, 4, 129),
                           generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens[..., :-1].to(device),
             "labels": tokens[..., 1:].to(device)}
    one = tree_map(lambda x: x[None], worker0)
    gf, mf = per_worker_grads(one, batch, cfg, impl="flash")
    gp, mp = per_worker_grads(one, batch, cfg, impl="plain")
    names, rel = [], []

    def leaf(key, block, a, b):
        a, b = a.float(), b.float()
        names.append(key if block is None else f"{key}[{block}]")
        rel.append(((a - b).norm() / b.norm().clamp(min=1e-30)).item())
    flat_p = []
    interop.map_with_keys(lambda k, blk, x: flat_p.append(x), gp)
    it = iter(flat_p)
    interop.map_with_keys(lambda k, blk, x: leaf(k, blk, x, next(it)), gf)
    loss_diff = abs(mf["loss"].item() - mp["loss"].item())
    order = np.argsort(rel)[::-1]
    log("train-parity", f"one worker, 4 x 128 tokens: loss flash "
        f"{mf['loss'].item()} plain {mp['loss'].item()} (|diff| {loss_diff});"
        f" {len(rel)} leaves, relative grad error median "
        f"{float(np.median(rel))} max {max(rel)}; largest: " + ", ".join(
            f"{names[i]} {rel[i]:.4f}" for i in order[:4]))
    if not all(np.isfinite(rel)) or max(rel) > 0.25 or np.median(rel) > 0.05 \
            or loss_diff > 0.05:
        raise AssertionError("flash and plain gradients disagree beyond bf16 "
                             "noise (limits: max 0.25, median 0.05, loss 0.05)")


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


# ------------------------------------------------------------------- main
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
    for stem in secs:
        for line in (build.BUILD_DIR / f"{stem}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{stem}: {line.strip()}")

    timer = Timer(device)
    phase_kernels(timer, device)
    cfg = get_config("qwen3-1.7b")
    params, reqs, out, launches, rec = phase_serve(cfg, device, smi)
    phase_profile(cfg, params, device, smi)
    phase_parity(cfg, params, reqs, out, device)

    q, k, v, kw = rec.fwd
    k3 = measure_fwd(timer, q, k, v, kw["window"], kw["softcap"])
    log("report", f"K3 at the main path's largest prefill q {tuple(q.shape)}"
        f" k {tuple(k.shape)}: {json.dumps(k3)}")
    q, kp, vp, tables, lengths, kw = rec.busiest_decode()
    k6 = measure_decode(timer, q, kp, vp, tables, lengths, kw["window"],
                        kw["softcap"])
    log("report", f"K6 at the main path's busiest decode tick, lengths "
        f"{lengths.tolist()} pools {tuple(kp.shape)}: {json.dumps(k6)}")
    del params, reqs, out, rec, q, k, v, kp, vp, tables, lengths
    torch.cuda.empty_cache()

    phase_train_kernels(timer, device)
    trained, mll, train_launches, bwd_rec = phase_train(cfg, device, smi)
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

    q, k, v, o, lse, do, kw = bwd_rec.call
    k4 = measure_bwd(timer, q, k, v, o, lse, do, kw["causal"], kw["window"],
                     kw["softcap"])
    log("report", f"K4 at the training path's shapes q {tuple(q.shape)} k "
        f"{tuple(k.shape)} {str(q.dtype)[6:]}: {json.dumps(k4)}")
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_attention.py:148",
             launches=launches["flash_attention"]
             + train_launches["flash_attention"],
             launches_by_path={"serve": launches["flash_attention"],
                               "train": train_launches["flash_attention"]},
             **k3),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_attention.py:282",
             launches=launches["flash_decode"], **k6),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:473",
             launches=train_launches["flash_attention_bwd"], **k4),
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
