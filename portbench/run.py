#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (`repro_torch`): MLL-SGD
training through the port's production harness.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the workload of
``BENCHMARK.json`` asks for.  The cell's configuration, traffic mix,
limits and per-layer readers are found by name (`portbench.cells`).  With
``--trace 0`` the last line of standard output is one JSON object with
the cell's end-to-end metrics; with ``--trace 1`` with its per-layer
metrics and the traced window's breakdown.  The numbers that decide
``correct`` are printed, each beside its limit, as the last lines of
standard error and under ``checks``, the result's last key.

Without the cards, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()
WALL_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def device_info(chips: int, peak: int, device) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def per_layer(cell, rec: dict) -> dict:
    from portbench import cells
    out = {}
    for m in cell.per_layer:
        reader = cells.metric_reader(m["name"])
        if reader.UNIT != m["unit"]:
            raise SystemExit(f"{m['name']}: BENCHMARK.json says unit "
                             f"{m['unit']!r}, its reader {reader.UNIT!r}")
        targets = [t for ts in getattr(reader, "SPANS", {}).values()
                   for t in ts] + list(getattr(reader, "CALLS", {}).values())
        if targets and all(t in rec["missing"] for t in targets):
            out[m["name"]] = {"value": None, "unit": m["unit"]}
            continue
        v = reader.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def end_to_end(cell, values: dict) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def run_one(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """One process, every worker on ``device``.  -> the result object."""
    import torch

    from portbench import check, train_cell
    readers = {}
    if trace:
        from portbench import cells
        readers = {m["name"]: cells.metric_reader(m["name"])
                   for m in cell.per_layer}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx = train_cell.setup(cell, seed, seconds, device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up done ({setup_s:.2f} s)")
    if trace:
        win, rec = train_cell.traced(ctx, cell, readers, seconds, device)
    else:
        win, rec = train_cell.window(ctx, seconds, device), None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window {win['slots']} slots in {win['seconds']:.3f} s; periods "
        f"{' '.join(f'{p:.3f}' for p in win['periods'])} s")
    train_cell.free(ctx)
    got, where = train_cell.reference_numbers(ctx, cell, seed, device)
    log(f"reference done; numbers {json.dumps(got)}; worst gaps "
        f"{json.dumps(where)}")
    ok, table = check.verdict(got, cell.limits)
    rate = win["tokens"] / win["seconds"]
    out = {"correct": ok, "attempted": win["slots"], "failed": 0}
    if trace:
        out["metrics"] = per_layer(cell, rec)
        dev = device_info(cell.chips, peak, device)
        dev.update(busy_s=rec["profile"]["busy_s"],
                   window_s=rec["profile"]["window_s"])
        out["device"] = dev
        from portbench import probe
        out["breakdown"] = probe.breakdown(rec["profile"])
    else:
        out["metrics"] = end_to_end(cell, {
            "train_tokens_per_s": rate, "mesh_tokens_per_s": rate,
            "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s})
        out["device"] = device_info(cell.chips, peak, device)
    out["checks"] = table
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from portbench import cells
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(cell.traffic["host_threads"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "mesh" in cell.traffic:
        from portbench import mesh_cell
        out = mesh_cell.run(cell, args.seed, args.seconds, bool(args.trace),
                            WALL_START, log=log)
    else:
        from repro_torch.kernels import build
        build.build_all()
        torch.cuda.set_device(0)
        out = run_one(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the port must not load: {bad}",
              file=sys.stderr)
        return 4
    for name, row in out["checks"].items():
        print(f"check {name} {row['value']:.6g} limit {row['limit']:.6g}",
              file=sys.stderr)
        if row["value"] != row["value"] or abs(row["value"]) == float("inf"):
            row["value"] = None                 # JSON has no NaN
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
