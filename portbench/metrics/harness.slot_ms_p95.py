"""The 95th percentile of the plan executor's slot times over every slot
of the traced window (`TrainHarness` ``slot_stats``), in milliseconds:
the slow tail of slots, which the host paces."""
import numpy as np

UNIT = "ms"


def read(rec):
    s = [x["seconds"] for x in rec["slots"]]
    return 1e3 * float(np.percentile(s, 95)) if len(s) >= 20 else None
