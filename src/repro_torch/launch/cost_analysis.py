"""Counting a program's work on the card's roofline (counterpart of
`repro/launch/hlo_analysis.py`).

The JAX module parses XLA's compiled HLO text, because XLA's own
``cost_analysis()`` visits a ``lax.scan`` body once.  The port produces no
HLO -- eager PyTorch runs op by op -- so that parser has nothing to read
and is not copied.  Its job is: count what a program does under one
documented cost model, then put the count on a roofline.  Here the count
comes from the eager op stream itself, through a ``TorchDispatchMode``
(`CostCounter`), on ``meta`` tensors (the dry run, `launch.dryrun`) or on
the card; the two give the same count.

Cost model (the JAX module's, ``hlo_analysis.py:11-32``):

  FLOPs      : matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
               count 2 * prod(result) * prod(contracted) exactly (equal
               to ``torch.utils.flop_counter``'s count); other ops that
               registry knows (convolutions) count as it says; elementwise
               arithmetic (an op tagged ``pointwise`` that computes:
               neither a comparison, a select nor a copy) counts 1 FLOP
               per output element.
  HBM bytes  : every op that materialises costs operand bytes + result
               bytes; views, reshapes and allocations are free (the
               counterpart of ``bitcast`` / ``get-tuple-element``).  Eager
               code fuses nothing, so this is an upper bound, as the JAX
               count is; and eager code runs every layer, so no trip
               count is needed.  Ops that touch no device tensor (host
               bookkeeping) are not counted.
  Kernels    : a hand-written kernel (K3, K4, K7, K8) is counted by its
               wrapper in `kernels.ops`, by the formulas of its bound
               (``PERF.md`` §6: its inputs read once, its outputs written
               once, its products), and the torch ops inside the wrapper
               are not counted; so a count is the same on ``meta`` (where
               the wrapper returns stand-ins) and on the card.
  Collective : result bytes of every all-reduce / all-gather / send-recv
               the mixing's lowerings make (`core.collectives` records
               them, on a ``meta`` stand-in group too); the bytes whose
               group spans two pods (``pod_stride`` apart) are split out as
               cross-node traffic -- the JAX module's ``_crosses_pods``.

Roofline terms (one NVIDIA H100 SXM5 80GB, NVIDIA's data sheet, dense):

  compute    = flops / 989e12        [bf16 tensor cores; 67e12 float32]
  memory     = bytes / 3.35e12       [HBM3]
  collective = coll_bytes / 450e9    [NVLink 4, per direction]
  dcn        = dcn_bytes / 50e9      [across nodes: 400 Gb/s a GPU, assumed]
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import collectives
from repro_torch.kernels import ops as kops

# NVIDIA H100 SXM5 data sheet (dense, no sparsity)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s per GPU
PEAK_FLOPS_F32 = 67e12       # float32 (CUDA cores) FLOP/s per GPU
PEAK = {torch.bfloat16: PEAK_FLOPS, torch.float32: PEAK_FLOPS_F32}
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
NVLINK_BW = 450e9            # NVLink 4 bytes/s per GPU, per direction
DCN_BW = 50e9                # bytes/s per GPU across nodes (assumed: 400 Gb/s)

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default}
_FREE = {"_unsafe_view", "_reshape_alias", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "lift_fresh",
         "_local_scalar_dense", "record_stream"}
# pointwise-tagged ops that move or select data rather than compute
_NOT_ARITH = {"where", "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
              "logical_or", "logical_not", "logical_xor", "bitwise_and",
              "bitwise_or", "bitwise_not", "bitwise_xor", "clone",
              "masked_fill", "copy", "fill", "isnan", "isinf", "isfinite"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(func, args) -> float:
    """2 * prod(result) * prod(contracted) of one matrix product."""
    a, b = (args[-2], args[-1])
    if func in (_aten.mm.default, _aten.addmm.default):
        m, k = a.shape
        return 2.0 * m * b.shape[1] * k
    bsz, m, k = a.shape
    return 2.0 * bsz * m * b.shape[2] * k


@dataclasses.dataclass
class Costs:
    """A program's count (the JAX module's ``HloCosts`` keys, plus the
    elementwise FLOPs and the kernels' share)."""
    flops: float = 0.0
    dot_flops: float = 0.0
    elementwise_flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    dcn_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_bytes_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    top_collectives: list = dataclasses.field(default_factory=list)
    kernels: dict = dataclasses.field(default_factory=dict)

    def scaled(self, f: float) -> "Costs":
        """Every count times ``f`` (a rank's count as the fleet's, or a
        fleet's as one chip's)."""
        return Costs(
            flops=self.flops * f, dot_flops=self.dot_flops * f,
            elementwise_flops=self.elementwise_flops * f,
            bytes=self.bytes * f,
            collective_bytes=self.collective_bytes * f,
            dcn_bytes=self.dcn_bytes * f,
            collective_counts=defaultdict(float, {
                k: v * f for k, v in self.collective_counts.items()}),
            collective_bytes_by_op=defaultdict(float, {
                k: v * f for k, v in self.collective_bytes_by_op.items()}),
            top_collectives=list(self.top_collectives),
            kernels={k: {kk: vv * f for kk, vv in v.items()}
                     for k, v in self.kernels.items()})

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "dot_flops": self.dot_flops,
            "elementwise_flops": self.elementwise_flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "dcn_bytes": self.dcn_bytes,
            "collective_counts": dict(self.collective_counts),
            "collective_bytes_by_op": dict(self.collective_bytes_by_op),
            "top_collectives": self.top_collectives[:20],
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


class CostCounter(TorchDispatchMode):
    """Counts the work of the device ops run inside it into ``costs``
    (module docstring), with the kernels' and the collectives' shares;
    ``by_op`` holds [calls, FLOPs, bytes] per counted aten op.
    ``pod_stride`` > 0 splits out the collective bytes whose peers lie
    in different pods (global ranks ``pod_stride`` apart)."""

    def __init__(self, *, pod_stride: int = 0):
        super().__init__()
        self.costs = Costs()
        self.by_op: dict = defaultdict(lambda: [0, 0.0, 0.0])
        self.pod_stride = pod_stride
        self._records: list = []
        self._paused = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(collectives.record_into(self._records))
        self._prev_sink = kops.set_work_sink(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        kops.set_work_sink(self._prev_sink)
        self._stack.close()
        self._fold_collectives()
        return out

    # ------------------------------------------------------------ kernels
    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float):
        """One call of a hand-written kernel: its work by formula; the ops
        inside the block are not counted."""
        k = self.costs.kernels.setdefault(
            name, {"calls": 0.0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.costs.flops += flops
        self.costs.bytes += nbytes
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -------------------------------------------------------- collectives
    def _pod(self, rank: int) -> int:
        return rank // self.pod_stride if self.pod_stride > 0 else 0

    def _fold_collectives(self) -> None:
        c = self.costs
        details = []
        for rec in self._records:
            c.collective_bytes += rec.bytes
            c.collective_counts[rec.kind] += 1
            c.collective_bytes_by_op[rec.kind] += rec.bytes
            pods = {self._pod(r) for r in rec.peers + (rec.rank,)}
            if len(pods) > 1:
                c.dcn_bytes += rec.bytes
            details.append((rec.bytes, rec.kind, rec.peers))
        self._records.clear()
        details.sort(key=lambda d: -d[0])
        c.top_collectives = [{"bytes": b, "type": t, "peers": list(p)}
                             for b, t, p in details[:20]]

    # ---------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if all(t.device.type == "cpu" for t in ins + outs):
            return                                   # host bookkeeping
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return
        c = self.costs
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        c.bytes += nbytes
        f = 0.0
        if func in _DOTS:
            f = dot_flops(func, args)
            c.dot_flops += f
        elif func.overloadpacket in flop_counter.flop_registry:
            f = float(flop_counter.flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            c.dot_flops += f
        elif torch.Tag.pointwise in func.tags and \
                name.rstrip("_") not in _NOT_ARITH:
            f = float(sum(t.numel() for t in outs))
            c.elementwise_flops += f
        c.flops += f
        rec = self.by_op[str(func)]
        rec[0] += 1
        rec[1] += f
        rec[2] += nbytes


# ---------------------------------------------------------------- roofline
@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dcn_s: float
    flops: float
    bytes: float
    collective_bytes: float
    dcn_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant}


def roofline_terms(costs: Costs, chips: int) -> Roofline:
    """``costs`` are PER-CHIP (the JAX module's are per device after SPMD
    partitioning; the dry run divides its fleet count by the chips).
    Terms are per-chip work over per-chip rates; the flops / bytes fields
    are scaled back to GLOBAL totals for the table."""
    return Roofline(
        compute_s=costs.flops / PEAK_FLOPS,
        memory_s=costs.bytes / HBM_BW,
        collective_s=costs.collective_bytes / NVLINK_BW,
        dcn_s=costs.dcn_bytes / DCN_BW,
        flops=costs.flops * chips,
        bytes=costs.bytes * chips,
        collective_bytes=costs.collective_bytes * chips,
        dcn_bytes=costs.dcn_bytes * chips,
        chips=chips,
    )


def model_flops(param_count_active: int, tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D (training) -- the useful-compute
    yardstick."""
    return 6.0 * param_count_active * tokens


def count(fn, *args, pod_stride: int = 0, **kwargs) -> tuple[object, Costs]:
    """``fn(*args, **kwargs)`` under a fresh `CostCounter` -> (its result,
    the count)."""
    with CostCounter(pod_stride=pod_stride) as counter:
        out = fn(*args, **kwargs)
    return out, counter.costs
