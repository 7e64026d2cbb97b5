"""K4's share of its roofline: the least time of the profiled calls of
`repro_torch.kernels.ops.flash_attention_bwd`
(`yardstick.attention_bwd_work`) over the device time of its
kernels (``flash_bwd*``: the backward and its delta, and
``group_sum``) in the profiled slots."""
from portbench import yardstick

UNIT = "%"
CALLS = {"flash_bwd": "repro_torch.kernels.ops:flash_attention_bwd"}
KERNELS = ['flash_bwd', 'group_sum']


def read(rec):
    p = rec["profile"]
    calls = p["calls"].get("flash_bwd", [])
    busy = sum(s for n, s in p["ops"].items()
               if any(k in n for k in KERNELS))
    if not calls or busy <= 0:
        return None
    least = 0.0
    for c in calls:
        q, k = c["args"][0], c["args"][1]
        kw = c["kwargs"]
        work = yardstick.attention_bwd_work(q["shape"], k["shape"], q["dtype"],
                                     kw.get("causal", True),
                                     kw.get("window", 0))
        least += yardstick.least_seconds(*work, q["dtype"])
    return 100.0 * least / busy
