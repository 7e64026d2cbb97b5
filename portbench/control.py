#!/usr/bin/env python3
"""The readings that a training cell's limits are set from, at the cell's
own size: not part of a benchmark run.

    python3 portbench/control.py --workload <name> --seeds 11 22 33 \\
        [--program] [--variant-seeds N]

For each seed it runs the plain reference over the compared ticks in
float32 as the truth, from the cell's weights and first batches exactly
as a run makes them, and puts in the program's place:

* with ``--program``, the program itself: a run's own set-up
  (`train_cell.setup`, its harness driven through the compared ticks),
  its state freed before the truth is worked out;
* on the first ``--variant-seeds`` seeds (all by default):
  ``control``, the reference computed in fp8 (`reference.numerics`), the
  precision below the configuration's bfloat16, and ``half_batch``,
  ``no_exchange``, ``no_hub``, ``altered``, the faults of `check.follow`
  planted in the float32 reference;

and prints one JSON line per seed and variant with the numbers of
`check.numbers` against the truth.  A state returned unchanged reads 1 on
``grad1`` and ``change`` by construction and is not run.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import cells, check, program, traffic  # noqa: E402

VARIANTS = (("control", "fp8", None), ("half_batch", "float32", "half_batch"),
            ("no_exchange", "float32", "no_exchange"),
            ("no_hub", "float32", "no_hub"),
            ("altered", "float32", "altered"))


def first_batches(cell: cells.Cell, seed: int) -> list[dict]:
    """The batches a run of ``seed`` hands its first compared ticks."""
    from repro_torch.data.pipeline import LMBatcher
    tr = cell.traffic
    w = tr["network"]["subnets"] * tr["network"]["workers_per_subnet"]
    stream = traffic.token_stream(w, tr["tokens"]["per_worker"],
                                  cell.config["vocab_size"], seed,
                                  tr["tokens"]["zipf"])
    batcher = LMBatcher(stream, tr["batch"]["seq_len"],
                        tr["batch"]["sequences"])
    rng = np.random.default_rng(seed)
    return [batcher.sample(rng) for _ in range(tr["compare_steps"])]


def program_readings(cell: cells.Cell, seed: int, device) -> tuple:
    """(the program's readings, the batches it took) from a run's own
    set-up, the program's state freed."""
    from portbench import train_cell
    ctx = train_cell.setup(cell, seed, 1.0, device)
    train_cell.free(ctx)
    return ctx["readings"], ctx["batcher"].kept


def readings(cell: cells.Cell, seed: int, device, variants=VARIANTS,
             log=print, with_program: bool = False) -> list[dict]:
    family = cells.reference(cell.config["reference"])
    t0 = time.perf_counter()
    if with_program:
        prog, batches = program_readings(cell, seed, device)
    else:
        prog, batches = None, first_batches(cell, seed)
    gate = program.mll_seed(seed)
    truth = check.follow(family, cell.config, cell.traffic, batches, seed,
                         gate, device)
    rows = []

    def report(name, reading):
        row = {"seed": seed, "variant": name,
               **check.numbers(reading, truth, cell.traffic),
               "seconds": time.perf_counter() - t0}
        log(json.dumps(row))
        rows.append(row)
    if prog is not None:
        report("program", prog)
    for name, precision, fault in variants:
        report(name, check.follow(family, cell.config, cell.traffic, batches,
                                  seed, gate, device, precision=precision,
                                  fault=fault))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--variant-seeds", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control.py runs on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.load(args.workload)
    if args.program:
        from repro_torch.kernels import build
        build.build_all()
        torch.set_num_threads(cell.traffic["host_threads"])
    n = len(args.seeds) if args.variant_seeds is None else args.variant_seeds
    for i, seed in enumerate(args.seeds):
        readings(cell, seed, "cuda", VARIANTS if i < n else (),
                 with_program=args.program)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
