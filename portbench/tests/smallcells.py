"""Small copies of the benchmark's cells for the CPU: the same files, with
the widths, depth, vocabulary and batch cut down, the limits given."""
from __future__ import annotations

import copy
import json

from portbench import cells, check

SMALL = {
    "qwen3-1.7b": dict(
        published={"hidden_size": 64, "intermediate_size": 128,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 16,
                   "vocab_size": 256},
        port={"d_model": 64, "d_ff": 128, "num_layers": 2, "n_heads": 4,
              "n_kv_heads": 2, "head_dim": 16, "vocab_size": 256}),
}


# the cell's files, and the four-card mix, which BENCHMARK.json leaves out
# until its limits have four-card readings (PERF.md)
CELLS = {"qwen3-1.7b.w4.train": ("qwen3-1.7b", "mll.w4.b2s2048", 1),
         "qwen3-1.7b.w4.nccl4": ("qwen3-1.7b", "mll.w4.b4s2048.nccl4", 4)}


def small(workload: str, *, dtype: str = "float32", seq_len: int = 16,
          sequences: int = 2, limits: dict | None = None) -> cells.Cell:
    """The workload's cell at a CPU size; every limit ``limits`` or 1e-3."""
    bench = json.load(open(cells.ROOT / "BENCHMARK.json"))
    config, mix, chips = CELLS[workload]
    w = {"name": workload, "config": config, "traffic": mix, "chips": chips}
    bench["workloads"] = [w]
    cell = cells.load(workload, bench, {k: 1e-3 for k in check.NUMBERS})
    conf = copy.deepcopy(cell.config)
    s = SMALL[w["config"]]
    conf.update(s["published"], torch_dtype=dtype)
    conf["port"]["set"] = dict(conf["port"]["set"], **s["port"],
                               param_dtype=dtype, compute_dtype=dtype)
    tr = copy.deepcopy(cell.traffic)
    tr["batch"] = {"sequences": sequences, "seq_len": seq_len}
    tr["tokens"]["per_worker"] = 512
    tr["host_threads"] = 1
    cell.config, cell.traffic = conf, tr
    cell.limits.update(limits or {})
    return cell
