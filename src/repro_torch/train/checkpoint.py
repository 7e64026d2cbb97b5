"""Checkpoints in the JAX package's on-disk format (counterpart of
`repro/train/checkpoint.py`): one ``.npz`` of leaves plus a JSON manifest,
so a checkpoint written by either package restores in the other.

* Keys are the JAX tree paths joined by ``::`` (NamedTuple fields spelled
  ``.params``, ``.step``, ...), and leaves are in the JAX layout: the port's
  list of super-blocks is stacked back (`repro_torch.interop`), so
  ``.params::blocks::pos0::mixer::wq`` holds (W, n_sb, d, H, hd).
* bfloat16 leaves are widened to float32 on disk and narrowed back on
  restore (exact); the manifest records each leaf's dtype.
* The manifest's ``treedef`` is JAX's ``str(PyTreeDef)``, which the port
  cannot compute: the port writes ``null`` (the JAX `restore` skips a null
  treedef) and validates keys, dtypes and shapes itself on restore.
* Saves are crash-consistent: the leaves go to a step-suffixed file first
  and the manifest naming it is replaced atomically last.

* A mixing strategy's state rides in the `MLLTrainState` like the rest:
  error-feedback residuals in the params' layout (``.mix_state::...``),
  PowerSGD's ``{"ef", "q"}`` with the factors already in the JAX layout
  (one per JAX leaf; a vector leaf's (W, 0) placeholder is a zero-size
  array in the npz).

``save``/``restore`` hold any tree (the averaged u_k at the directory's
root); ``save_state``/``restore_state`` the full protocol checkpoint -- an
entire `MLLTrainState` plus the timeline cursor and the data cursor -- under
``state/``, from which a killed run resumes bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import interop

Tree = Any
_STATE_SUBDIR = "state"


def _storable(t: torch.Tensor) -> np.ndarray:
    """npz cannot hold bfloat16: widen it (exactly) to float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().contiguous().numpy()


def _replace_into(path: str, name: str, write) -> str:
    """Write via a temp file + atomic `os.replace`."""
    tmp = os.path.join(path, f".tmp-{os.getpid()}-{name}")
    write(tmp)
    os.replace(tmp, os.path.join(path, name))
    return name


def save(path: str, tree: Tree, *, step: int = 0, extra: dict | None = None,
         worker_axis: bool = False) -> None:
    """Crash-consistent save of a port tree (``worker_axis`` for trees whose
    leaves lead with the worker axis)."""
    os.makedirs(path, exist_ok=True)
    flat = interop.flatten(tree, worker_axis=worker_axis, convert=_storable)
    spec = interop.leaf_spec(tree, worker_axis=worker_axis)
    dtypes = {k: spec[k][1] for k in flat}
    params_file = f"params-{step}.npz"
    _replace_into(path, params_file, lambda tmp: np.savez(tmp, **flat))
    manifest = {"step": step, "treedef": None, "extra": extra or {},
                "keys": sorted(flat), "dtypes": dtypes,
                "params_file": params_file}

    def write_manifest(tmp):
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)

    _replace_into(path, "manifest.json", write_manifest)
    for name in os.listdir(path):       # prune superseded params files
        if name != params_file and (name == "params.npz" or (
                name.startswith("params-") and name.endswith(".npz"))):
            os.remove(os.path.join(path, name))


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _validate(manifest: dict, spec: dict, data) -> None:
    """Keys, per-leaf dtypes and shapes of the checkpoint against the tree
    being restored into (the JAX treedef string is not checked)."""
    files = set(data.files)
    if files != set(spec):
        missing = sorted(files ^ set(spec))
        raise ValueError(f"checkpoint/tree key mismatch: {missing[:5]}")
    saved = manifest.get("dtypes", {})
    bad = [(k, saved[k], spec[k][1]) for k in sorted(spec)
           if k in saved and saved[k] != spec[k][1]]
    if bad:
        k, got, want = bad[0]
        raise ValueError(
            f"checkpoint dtype mismatch on {len(bad)} leaves (first: {k!r} "
            f"saved as {got}, restoring into {want}); refusing to silently "
            "cast -- re-export the checkpoint or fix the target dtypes")
    for k in sorted(spec):
        shape = tuple(data[k].shape)
        if shape != spec[k][0]:
            raise ValueError(f"{k}: shape {shape} != {spec[k][0]}")


def restore(path: str, like: Tree, *, worker_axis: bool = False,
            device: torch.device | None = None) -> tuple[Tree, int]:
    """Restore into the structure and dtypes of ``like``, on ``device``
    (default: each ``like`` leaf's device).  Only the shapes, dtypes and
    devices of ``like``'s leaves are read, so they may be expanded views or
    meta tensors.  -> (tree, step)."""
    manifest = load_manifest(path)
    spec = interop.leaf_spec(like, worker_axis=worker_axis)
    with np.load(os.path.join(path, manifest.get("params_file",
                                                 "params.npz"))) as data:
        _validate(manifest, spec, data)
        tree = interop.unflatten(data, like, worker_axis=worker_axis,
                                 device=device)
    # narrow the on-disk float32 widening back to the leaf dtype
    like_leaves = {}
    interop.map_with_keys(lambda k, b, x: like_leaves.setdefault((k, b), x),
                          like)
    tree = interop.map_with_keys(
        lambda k, b, x: x.to(like_leaves[(k, b)].dtype), tree)
    return tree, int(manifest["step"])


# ----------------------------------------------- full protocol checkpoints
def state_dir(path: str) -> str:
    """Where the full-protocol checkpoint lives inside a checkpoint dir
    (the root keeps the averaged u_k for serving)."""
    return os.path.join(path, _STATE_SUBDIR)


def save_state(path: str, train_state, *, slot: int,
               rng_state: dict | None = None,
               extra: dict | None = None) -> str:
    """Full protocol checkpoint: the whole `MLLTrainState`, the timeline
    cursor ``slot`` and the data cursor ``rng_state`` (JSON-able)."""
    d = state_dir(path)
    payload = dict(extra or ())
    if rng_state is not None:
        payload["rng_state"] = rng_state
    save(d, train_state, step=slot, extra=payload, worker_axis=True)
    return d


def restore_state(path: str, like, *, device: torch.device | None = None
                  ) -> tuple[Any, int, dict]:
    """-> (train_state, slot, extra) with key/dtype/shape validation, on
    ``device`` (default: each ``like`` leaf's device)."""
    d = state_dir(path)
    if not os.path.exists(os.path.join(d, "manifest.json")):
        raise FileNotFoundError(
            f"no full-protocol checkpoint under {path!r} (expected "
            f"{d}/manifest.json) -- was the run checkpointed with "
            "save_state?")
    state, slot = restore(d, like, worker_axis=True, device=device)
    return state, slot, load_manifest(d).get("extra", {})
