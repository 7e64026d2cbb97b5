#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU: build, check and serve.

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
6. report  -- one ``{"kernels": [...]}`` JSON line, the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

Without a GPU, or away from the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.serve import kv_cache as kvc  # noqa: E402
from repro_torch.serve.engine import (PROMPT_PAD, EngineConfig,  # noqa: E402
                                      ServeEngine, poisson_arrivals)

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
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_attention.py:148",
             launches=launches["flash_attention"], **k3),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_attention.py:282",
             launches=launches["flash_decode"], **k6),
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
