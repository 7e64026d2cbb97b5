"""K3's share of its roofline: the least time of the profiled calls of
`repro_torch.kernels.ops.flash_attention_fwd_res` (their operations
and bytes from the shapes, `yardstick.attention_fwd_work`, against
the card's peaks) over the device time of the forward kernels
(``flash_fwd*``) in the profiled slots."""
from portbench import yardstick

UNIT = "%"
CALLS = {"flash_fwd": "repro_torch.kernels.ops:flash_attention_fwd_res"}
KERNELS = ['flash_fwd']


def read(rec):
    p = rec["profile"]
    calls = p["calls"].get("flash_fwd", [])
    busy = sum(s for n, s in p["ops"].items()
               if any(k in n for k in KERNELS))
    if not calls or busy <= 0:
        return None
    least = 0.0
    for c in calls:
        q, k = c["args"][0], c["args"][1]
        kw = c["kwargs"]
        work = yardstick.attention_fwd_work(q["shape"], k["shape"], q["dtype"],
                                     kw.get("causal", True),
                                     kw.get("window", 0))
        least += yardstick.least_seconds(*work, q["dtype"])
    return 100.0 * least / busy
