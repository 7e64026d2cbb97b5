"""Continuous-batching serving engine over the paged KV cache (counterpart
of `repro/serve/engine.py`).

One `ServeEngine` owns ``max_batch`` decode lanes, a shared pool of KV
blocks, and a FIFO queue:

  * **admission** -- a queued request is admitted when a lane is free AND
    its full worst-case block budget fits (all-or-nothing);
  * **prefill** -- newly admitted lanes run ONE batched forward over their
    prompts (padded to a multiple of 16; `model.prefill_forward`), the k/v
    of the real prompt positions are written into the block pools, and the
    first token is sampled from the last prompt position's logits;
  * **decode** -- every active lane advances one token per slot through
    `model.paged_decode_step` (token k/v written, then paged attention);
  * **eviction** -- a finished request frees its blocks immediately; the
    next admission reuses them (LIFO).

Each engine step is one SLOT: one prefill batch or one decode tick.
`ServeEngine.trace` emits the ``mll-timeline-trace/v1`` document the JAX
package's timeline tooling reads (`repro.core.timeline.load_trace`).

The engine serves the merged model u_k: pass params directly, or serve a
harness checkpoint directory (`load_u_k`, `ServeEngine.from_checkpoint`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import protocol
from repro_torch.core.mllsgd import MLLConfig, build_network
from repro_torch.core.simulator import weighted_average
from repro_torch.core.timeline import TRACE_SCHEMA
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.serve import kv_cache as kvc
from repro_torch.train import checkpoint
from repro_torch.tree import tree_map

PROMPT_PAD = 16                          # prompts pad to a multiple of this


# ------------------------------------------------------------------ requests
@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` is the slot index at which the
    request becomes visible to the scheduler (0 = available at start)."""
    rid: int
    prompt: np.ndarray            # (plen,) int32 token ids
    max_new: int = 16
    arrival: int = 0


def poisson_arrivals(prompts: list[np.ndarray], *, max_new: int = 16,
                     rate: float = 1.0, seed: int = 0) -> list[Request]:
    """Requests with Poisson arrivals: exponential inter-arrival slots at
    ``rate`` requests/slot, cumulative and floored onto the slot clock."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=len(prompts))
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    return [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new=max_new, arrival=int(a))
            for i, (p, a) in enumerate(zip(prompts, arrivals))]


# ---------------------------------------------------------------- u_k loader
def load_u_k(path: str, cfg: ArchConfig,
             device: str | torch.device | None = None) -> dict:
    """The averaged model u_k from a harness checkpoint directory, written
    by either package, on ``device`` (default ``cuda``).

    Preferred source is the full protocol checkpoint (`restore_state`): its
    ``plan_config`` rebuilds the MLLConfig and network the run trained
    under, the per-worker params are restored, and u_k = X a is recomputed
    with the network's weights.  Falls back to the root params checkpoint
    for directories written without ``save_state``."""
    device = resolve_device(device)
    skeleton = model_mod.param_skeleton(cfg)
    state_manifest = os.path.join(checkpoint.state_dir(path), "manifest.json")
    if not os.path.exists(state_manifest):
        return checkpoint.restore(path, skeleton, device=device)[0]
    extra = checkpoint.load_manifest(checkpoint.state_dir(path)).get(
        "extra", {})
    pcfg = extra.get("plan_config")
    if pcfg is None:
        raise ValueError(
            f"{path}: full-protocol checkpoint carries no plan_config -- "
            "cannot rebuild the network's averaging weights")
    mll = MLLConfig(
        tau=int(pcfg["tau"]), q=int(pcfg["q"]), eta=float(pcfg["eta"]),
        granularity="worker_per_data", hub_topology=pcfg["hub_topology"],
        worker_rates=tuple(float(r) for r in pcfg["worker_rates"]),
        mixing=pcfg["mixing"], mix_dtype=pcfg["mix_dtype"],
        inner_opt=pcfg["inner_opt"],
        inner_opt_args=tuple(tuple(kv) for kv in pcfg["inner_opt_args"]),
        seed=int(pcfg["seed"]))
    wps = [int(n) for n in pcfg["workers_per_subnet"]]
    network = build_network(mll, len(wps), wps[0])
    w = network.num_workers
    # restore reads only the meta skeleton's shapes and dtypes
    stacked = tree_map(
        lambda x: x.unsqueeze(0).expand((w,) + tuple(x.shape)), skeleton)
    like = protocol.init_train_state(stacked, cfg=mll)
    train_state, _, _ = checkpoint.restore_state(path, like, device=device)
    return weighted_average(train_state.params,
                            torch.as_tensor(np.asarray(network.a),
                                            dtype=torch.float32,
                                            device=device))


# ------------------------------------------------------------------- engine
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8            # decode lanes
    block_size: int = 16
    num_blocks: int = 128
    max_len: int = 256            # per-request context cap (prompt + new)
    temperature: float = 0.0
    seed: int = 0
    impl: str = "flash"           # flash (hand-written kernels) | plain


@dataclasses.dataclass
class _Lane:
    rid: int
    blocks: list[int]
    ctx_len: int                  # tokens currently in cache
    budget: int                   # hard context cap for this request
    max_new: int
    produced: int = 0
    tokens: list[int] = dataclasses.field(default_factory=list)
    record: dict = dataclasses.field(default_factory=dict)


def _to_device(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return [_to_device(v, device) for v in tree]


class ServeEngine:
    """Continuous-batching decode over a paged KV cache (module docstring
    has the scheduling semantics).  Runs on ``device`` (default ``cuda``;
    raises without a GPU unless ``device="cpu"``); params are moved there."""

    def __init__(self, params: dict, cfg: ArchConfig, ecfg: EngineConfig,
                 device: str | torch.device | None = None):
        if any(kind != "attn" for kind in cfg.pattern):
            raise NotImplementedError(
                f"ServeEngine requires an attention-only pattern; {cfg.name} "
                f"has {cfg.pattern}")
        if cfg.input_mode != "tokens":
            raise NotImplementedError("ServeEngine serves token models only")
        attn_mod.check_impl(ecfg.impl, attn_mod.KERNEL_IMPLS)
        self.device = resolve_device(device)
        self.cfg, self.ecfg = cfg, ecfg
        self.params = _to_device(params, self.device)
        self.pc = kvc.PagedCacheConfig(block_size=ecfg.block_size,
                                       num_blocks=ecfg.num_blocks,
                                       max_len=ecfg.max_len)
        self.alloc = kvc.BlockAllocator(ecfg.num_blocks)
        with torch.inference_mode():
            self.state = model_mod.init_paged_state(
                cfg, ecfg.num_blocks, ecfg.block_size, self.device)
        self.tables = np.zeros((ecfg.max_batch, self.pc.max_blocks_per_seq),
                               np.int32)
        self.lanes: list[_Lane | None] = [None] * ecfg.max_batch
        self.gen = torch.Generator(self.device).manual_seed(ecfg.seed)
        self.t = 0                           # slot clock
        self._t0 = None                      # wall clock at first submit()
        self._queue: list[Request] = []
        self._pending: list[Request] = []    # future arrivals, sorted
        self._busy: list[int] = []           # per-slot active lane count
        self._events: list[dict] = []
        self._records: list[dict] = []
        self._finished = 0

    # ------------------------------------------------------------- device
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits: torch.Tensor) -> list[int]:
        """logits (G, V) -> one token per row: greedy at temperature 0,
        else a draw from softmax(logits / T) with the engine's generator."""
        logits = logits.float()
        if self.ecfg.temperature > 0.0:
            probs = torch.softmax(logits / self.ecfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.tolist()

    @torch.inference_mode()
    def _prefill(self, toks: np.ndarray, tables: np.ndarray,
                 plens: np.ndarray) -> list[int]:
        logits, kvs = model_mod.prefill_forward(
            self.params, {"tokens": self._tensor(toks).long()}, self.cfg,
            impl=self.ecfg.impl)
        tables_t, plens_t = self._tensor(tables), self._tensor(plens)
        for layer_state, layer_kv in zip(self.state, kvs):
            for name, pools in layer_state.items():
                k, v = layer_kv[name]
                kvc.write_prefill_kv(pools["k_pool"], pools["v_pool"], k, v,
                                     tables_t, plens_t)
        rows = torch.arange(len(plens), device=self.device)
        return self._sample(logits[rows, plens_t.long() - 1])

    @torch.inference_mode()
    def _decode(self, toks: np.ndarray, lengths: np.ndarray) -> list[int]:
        logits, self.state = model_mod.paged_decode_step(
            self.params, self.state, {"tokens": self._tensor(toks).long()},
            self._tensor(self.tables), self._tensor(lengths), self.cfg,
            impl=self.ecfg.impl)
        return self._sample(logits[:, 0])

    # ------------------------------------------------------------ scheduling
    def submit(self, requests: list[Request]) -> None:
        """Queue requests; the wall clock of the records starts at the
        first submit."""
        if self._t0 is None:
            self._t0 = time.time()
        self._pending.extend(requests)
        self._pending.sort(key=lambda r: r.arrival)

    def _admit(self) -> list[tuple[int, Request]]:
        """Arrivals -> queue -> free lanes, all-or-nothing on blocks."""
        while self._pending and self._pending[0].arrival <= self.t:
            self._queue.append(self._pending.pop(0))
        admitted = []
        for i, lane in enumerate(self.lanes):
            if lane is not None or not self._queue:
                continue
            req = self._queue[0]
            plen = len(req.prompt)
            budget = min(plen + req.max_new, self.ecfg.max_len)
            if plen > self.ecfg.max_len:
                raise ValueError(f"request {req.rid}: prompt of {plen} tokens "
                                 f"exceeds max_len={self.ecfg.max_len}")
            blocks = self.alloc.alloc(self.pc.blocks_for(budget))
            if blocks is None:               # pool exhausted -- stay queued
                break
            self._queue.pop(0)
            self.tables[i, :len(blocks)] = blocks
            self.lanes[i] = _Lane(
                rid=req.rid, blocks=blocks, ctx_len=0, budget=budget,
                max_new=req.max_new, tokens=list(map(int, req.prompt)),
                record={"rid": req.rid, "arrival": req.arrival,
                        "admitted": self.t, "prompt_len": plen})
            admitted.append((i, req))
            self._events.append({"slot": self.t, "kind": "admit",
                                 "participants": [i], "round_index": req.rid})
        return admitted

    def _wall(self) -> float:
        return time.time() - self._t0

    def _emit_token(self, i: int, tok: int) -> None:
        """Account one generated token on lane i; evict when done."""
        lane = self.lanes[i]
        lane.tokens.append(tok)
        lane.produced += 1
        if lane.produced == 1:
            lane.record["first_token"] = self.t
            lane.record["ttft_s"] = self._wall()
        # the next decode would write at position ctx_len -- stop when that
        # position falls outside the request's block budget
        if lane.produced >= lane.max_new or lane.ctx_len + 1 > lane.budget:
            lane.record.update(finished=self.t, generated=lane.produced,
                               latency_s=self._wall(),
                               tokens=list(lane.tokens))
            self._records.append(lane.record)
            self._events.append({"slot": self.t, "kind": "finish",
                                 "participants": [i],
                                 "round_index": lane.rid})
            self.alloc.free(lane.blocks)
            self.lanes[i] = None
            self._finished += 1

    def _prefill_step(self, admitted: list[tuple[int, Request]]) -> None:
        idx = [i for i, _ in admitted]
        plens = np.array([len(r.prompt) for _, r in admitted], np.int32)
        s = int(-(-plens.max() // PROMPT_PAD) * PROMPT_PAD)
        toks = np.zeros((len(idx), s), np.int32)
        for row, (_, req) in enumerate(admitted):
            toks[row, :len(req.prompt)] = req.prompt
        nxt = self._prefill(toks, self.tables[idx], plens)
        self._events.append({"slot": self.t, "kind": "prefill",
                             "participants": idx,
                             "round_index": min(r.rid for _, r in admitted)})
        for row, i in enumerate(idx):
            self.lanes[i].ctx_len = int(plens[row])
            self._emit_token(i, nxt[row])
        self._busy.append(len(idx))

    def _decode_tick(self) -> None:
        active = [i for i, ln in enumerate(self.lanes) if ln is not None]
        toks = np.zeros((self.ecfg.max_batch, 1), np.int32)
        lengths = np.zeros(self.ecfg.max_batch, np.int32)
        for i in active:
            toks[i, 0] = self.lanes[i].tokens[-1]
            lengths[i] = self.lanes[i].ctx_len + 1   # incl. token decoded now
        nxt = self._decode(toks, lengths)
        for i in active:
            self.lanes[i].ctx_len += 1
            self._emit_token(i, nxt[i])
        self._busy.append(len(active))

    def step(self) -> None:
        """One engine slot: a prefill batch if anything was admitted, else
        one decode tick for every active lane."""
        admitted = self._admit()
        if admitted:
            self._prefill_step(admitted)
        elif any(ln is not None for ln in self.lanes):
            self._decode_tick()
        else:
            self._busy.append(0)                     # idle slot (gap in arrivals)
        self.t += 1

    def run(self, requests: list[Request]) -> dict:
        """Serve ``requests`` to completion.  -> {"outputs": {rid: tokens},
        "records": [...per-request latency records...], "slots", "wall_s",
        "generated"} -- outputs include the prompt prefix."""
        self.submit(requests)
        while (self._pending or self._queue
               or any(ln is not None for ln in self.lanes)):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        outputs = {r["rid"]: r["tokens"] for r in self._records}
        return {"outputs": outputs, "records": list(self._records),
                "slots": self.t, "wall_s": self._wall(),
                "generated": sum(r["generated"] for r in self._records)}

    # -------------------------------------------------------------- trace
    def trace(self, **meta: Any) -> dict:
        """The engine's run as an ``mll-timeline-trace/v1`` document: one
        slot per engine step, busy = lanes that produced a token that slot,
        one round per finished request (round cost = admission->finish
        slots), per-request latency records under ``meta["requests"]``."""
        busy = [int(b) for b in self._busy]
        costs = [int(r["finished"] - r["admitted"] + 1)
                 for r in self._records]
        return {
            "schema": TRACE_SCHEMA,
            "slots": self.t,
            "slots_used": sum(1 for b in busy if b > 0),
            "rounds_completed": self._finished,
            "gate_mode": "serve",
            "busy_slots": busy,
            "idle_slots": [self.ecfg.max_batch - b for b in busy],
            "round_costs": costs,
            "events": list(self._events),
            "meta": dict(meta, source="serve.engine",
                         requests=[{k: v for k, v in r.items()
                                    if k != "tokens"}
                                   for r in self._records]),
        }

    def export_trace(self, path: str, **meta: Any) -> str:
        with open(path, "w") as f:
            json.dump(self.trace(**meta), f, indent=2)
        return path

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_checkpoint(cls, path: str, cfg: ArchConfig,
                        ecfg: EngineConfig = EngineConfig(),
                        device: str | torch.device | None = None
                        ) -> "ServeEngine":
        """An engine serving the averaged u_k of a harness checkpoint."""
        return cls(load_u_k(path, cfg, device), cfg, ecfg, device=device)
