"""Per-architecture sharding rules (counterpart of
`repro/launch/sharding.py`).

Two layers of rules, both derived from the mesh and the ArchConfig:

1. *Parameter specs* -- a partition spec per parameter leaf, matched on the
   leaf's path name (wq/wk/wv/wo, w_gate/w_up/w_down, table/lm_head,
   router, mamba and xlstm projections, norms).  Dims shard only when
   divisible by the mesh axis size; everything else replicates.

2. *Logical activation rules* -- the mapping installed through
   `models.pjit_utils.logical_sharding` that resolves the logical
   activation names ("heads", "mlp", "vocab", "experts", ...) to mesh
   axes.

Hierarchy placement:
  worker_per_data : worker axis -> ("pod","data"); inner dims -> "model"
  worker_per_pod  : worker axis -> ("pod",); inner dims -> "model" and the
                    d_model-sized dim additionally -> "data"  (FSDP/ZeRO-3)

A partition spec is a tuple (`models.pjit_utils.PartitionSpec`) of, per
dim, a mesh-axis name, a tuple of names or ``None``, equal entry for entry
to the JAX package's ``PartitionSpec``.  The plan reads only a
`launch.mesh.Mesh`'s axis names and shape, so a mesh built from its shape
alone (`Mesh(*PRODUCTION[multi_pod])`) serves: no world, no devices.  The
JAX plan's ``named()`` (``NamedSharding`` per leaf) has no counterpart:
the port places nothing -- a rank holds whole workers at runtime -- and
the specs feed the dry run's per-chip byte counts (`launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh, mesh_axis_sizes
from repro_torch.models.pjit_utils import PartitionSpec
from repro_torch.tree import map_with_path

Tree = Any

# archs whose replica does not fit 16 chips -> DiLoCo-style worker per pod
BIG_ARCHS = ("grok-1-314b", "qwen2-vl-72b", "qwen3-moe-235b-a22b",
             "jamba-v0.1-52b")


def granularity_for(cfg: ArchConfig) -> str:
    return "worker_per_pod" if cfg.name in BIG_ARCHS else "worker_per_data"


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def axis_entry(axes: tuple[str, ...]):
    """A spec entry for a dim sharded over ``axes``, in the form the JAX
    package's ``PartitionSpec`` stores it: ``None``, one name, or a tuple
    of two or more."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def leaf_path(path: tuple) -> str:
    """The JAX package's path name of a port leaf: its keys joined by "/",
    without the list position of a super-block (JAX stacks them)."""
    keys = [str(k) for i, k in enumerate(path)
            if not (isinstance(k, int) and i > 0 and path[0] == "blocks")]
    return "/".join(keys)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Mesh
    cfg: ArchConfig
    granularity: str              # worker_per_data | worker_per_pod
    fsdp: bool                    # shard d_model-sized param dims over "data"

    @property
    def axis_sizes(self) -> dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    @property
    def model_size(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def data_size(self) -> int:
        return self.axis_sizes.get("data", 1)

    @property
    def n_pods(self) -> int:
        return self.axis_sizes.get("pod", 1)

    @property
    def worker_axes(self) -> tuple[str, ...]:
        if self.granularity == "worker_per_chip":
            return tuple(a for a in ("pod", "data", "model")
                         if a in self.axis_sizes)
        if self.granularity == "worker_per_data":
            return tuple(a for a in ("pod", "data") if a in self.axis_sizes)
        return tuple(a for a in ("pod",) if a in self.axis_sizes)

    @property
    def num_workers(self) -> int:
        return math.prod(self.axis_sizes[a] for a in self.worker_axes)

    # ----------------------------------------------------------- logical rules
    def logical_rules(self, *, serving: bool) -> dict:
        cfg = self.cfg
        # worker_per_chip: each worker owns one chip -- nothing inner shards
        ms = 0 if self.granularity == "worker_per_chip" else self.model_size
        heads = "model" if _div(cfg.n_heads, ms) else None
        kv = "model" if _div(cfg.n_kv_heads, ms) else None
        # decode: when kv heads don't divide the model axis the cache shards
        # on head_dim instead, and q co-shards
        kv_hd = None
        if serving and kv is None and _div(cfg.resolved_head_dim, ms):
            kv_hd = "model"
            heads = None
        experts_sharded = cfg.n_experts > 0 and _div(cfg.n_experts, ms)
        rules = {
            "heads": heads,
            "kv_heads": kv,
            "kv_hd": kv_hd,
            "mlp": "model" if _div(cfg.d_ff or 0, ms) else None,
            "vocab": "model" if _div(cfg.vocab_size, ms) else None,
            "experts": ("model" if experts_sharded and cfg.moe_groups <= 1
                        else None),
            "moe_ff": (None if experts_sharded and cfg.moe_groups <= 1 else
                       ("model" if _div(cfg.resolved_moe_d_ff, ms)
                        else None)),
            "moe_groups": ("data" if cfg.moe_groups > 1 and
                           _div(cfg.moe_groups, self.data_size) else None),
            "mamba_inner": ("model" if _div(cfg.ssm_expand * cfg.d_model, ms)
                            else None),
            "xlstm_proj": ("model" if _div(int(cfg.xlstm_proj_factor
                                               * cfg.d_model), ms)
                           else None),
            "act_seq": None,
            "mixer_seq": None,
        }
        if serving:
            rules["act_batch"] = tuple(a for a in ("pod", "data")
                                       if a in self.axis_sizes)
        else:
            # training: the worker axis is the fleet's leading dim; the
            # per-worker batch shards over "data" only per pod
            rules["act_batch"] = ("data" if self.granularity ==
                                  "worker_per_pod" else None)
        return rules

    # ----------------------------------------------------------- param specs
    def _leaf_spec(self, path: str, shape: tuple[int, ...]) -> PartitionSpec:
        cfg, ds = self.cfg, self.data_size
        ms = 0 if self.granularity == "worker_per_chip" else self.model_size
        fsdp = self.fsdp
        d = cfg.d_model

        def fs(dim_size: int, axis_idx: int, base: tuple) -> tuple:
            """optionally add FSDP 'data' sharding on a d_model-sized dim"""
            if fsdp and dim_size == d and base[axis_idx] is None and _div(dim_size, ds):
                lst = list(base)
                lst[axis_idx] = "data"
                return tuple(lst)
            return base

        name = path.split("/")[-1]
        if name in ("scale", "bias", "b_if", "b_gates", "dt_bias", "d_skip",
                    "conv_b"):
            return (None,) * len(shape)
        if name == "table":                            # (V, d)
            spec = ("model" if _div(shape[0], ms) else None, None)
            return fs(shape[1], 1, spec)
        if name == "lm_head":                          # (d, V)
            spec = (None, "model" if _div(shape[1], ms) else None)
            return fs(shape[0], 0, spec)
        if name in ("wq", "wk", "wv") and len(shape) == 3:   # (d, H|Hkv, hd)
            spec = (None, "model" if _div(shape[1], ms) else None, None)
            return fs(shape[0], 0, spec)
        if name in ("wq", "wk", "wv"):                 # xlstm (dp, dp)
            return (None, "model" if _div(shape[1], ms) else None)
        if name == "wo":                               # (H, hd, d)
            spec = ("model" if _div(shape[0], ms) else None, None, None)
            return fs(shape[2], 2, spec)
        if name in ("bq", "bk", "bv"):                 # (H, hd)
            return ("model" if _div(shape[0], ms) else None, None)
        if name == "router":                           # (d, E)
            return (None, None)
        if name in ("w_gate", "w_up", "w_down") and len(shape) == 3:
            # MoE experts: (E, d, f) / (E, f, d).  With grouped dispatch the
            # scatter must not cross a sharded E dim --
            # prefer f-sharding whenever groups are active.
            e = shape[0]
            f_idx = 2 if name in ("w_gate", "w_up") else 1
            prefer_f = cfg.moe_groups > 1 and _div(shape[f_idx], ms)
            if _div(e, ms) and not prefer_f:
                spec = ("model", None, None)
            else:
                spec = [None, None, None]
                if _div(shape[f_idx], ms):
                    spec[f_idx] = "model"
                spec = tuple(spec)
            d_idx = 1 if name in ("w_gate", "w_up") else 2
            return fs(shape[d_idx], d_idx, spec)
        if name in ("w_gate", "w_up"):                 # dense MLP (d, f)
            spec = (None, "model" if _div(shape[1], ms) else None)
            return fs(shape[0], 0, spec)
        if name == "w_down":                           # (f, d)
            spec = ("model" if _div(shape[0], ms) else None, None)
            return fs(shape[1], 1, spec)
        # ---- mamba
        if name == "in_proj":                          # (d, 2*di)
            spec = (None, "model" if _div(shape[1], ms) else None)
            return fs(shape[0], 0, spec)
        if name == "conv_w":                           # (K, di)
            return (None, "model" if _div(shape[1], ms) else None)
        if name == "x_proj":                           # (di, dtr + 2n)
            return ("model" if _div(shape[0], ms) else None, None)
        if name == "dt_proj":                          # (dtr, di)
            return (None, "model" if _div(shape[1], ms) else None)
        if name == "a_log":                            # (di, n)
            return ("model" if _div(shape[0], ms) else None, None)
        if name == "out_proj":                         # (di, d)
            spec = ("model" if _div(shape[0], ms) else None, None)
            return fs(shape[1], 1, spec)
        # ---- xlstm (w_up / w_down are the dense MLP's rules above)
        if name in ("wq2", "wk2", "wv2"):
            return (None, "model" if _div(shape[1], ms) else None)
        if name == "w_if":                             # (dp, 2h)
            return ("model" if _div(shape[0], ms) else None, None)
        if name == "w_gates":                          # (dp, 4dp)
            return (None, "model" if _div(shape[1], ms) else None)
        if name == "r_gates":                          # (h, hd, 4hd)
            return (None, None, None)
        # default: replicate
        return (None,) * len(shape)


    def param_specs(self, params_shape: Tree, *,
                    with_worker_axis: bool) -> Tree:
        """A partition spec per leaf of ``params_shape`` (the port's param
        tree, e.g. `models.model.param_skeleton` on meta tensors).  With
        ``with_worker_axis`` the leaves carry a leading worker dim that
        shards over ``self.worker_axes``.  A ``blocks`` leaf's spec holds the
        JAX package's ``None`` for the stacked super-block dim (its
        position after the worker dim), which the port's list of
        super-blocks does not have: `leaf_dims` drops it."""
        waxes = axis_entry(self.worker_axes)

        def one(path, leaf):
            pstr = leaf_path(path)
            shape = tuple(leaf.shape)
            prefix = []
            if with_worker_axis:
                prefix.append(waxes)
                shape = shape[1:]
            if pstr.startswith("blocks"):
                prefix.append(None)          # the stacked super-block dim
            return tuple(prefix) + self._leaf_spec(pstr, shape)

        return map_with_path(one, params_shape)


def leaf_dims(path: tuple, spec: PartitionSpec, *,
              with_worker_axis: bool) -> PartitionSpec:
    """``spec`` entry per dim of the port's leaf at ``path``: a
    ``blocks`` leaf's super-block ``None`` dropped."""
    if leaf_path(path).startswith("blocks"):
        i = 1 if with_worker_axis else 0
        return spec[:i] + spec[i + 1:]
    return spec


def make_plan(mesh: Mesh, cfg: ArchConfig, *,
              granularity: str | None = None) -> ShardingPlan:
    g = granularity or granularity_for(cfg)
    return ShardingPlan(mesh=mesh, cfg=cfg, granularity=g,
                        fsdp=(g == "worker_per_pod"))
