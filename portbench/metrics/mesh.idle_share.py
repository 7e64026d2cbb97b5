"""`device.idle_share` on every card of a mesh, the mean over the ranks:
each rank's profiled busy seconds over the median period of its traced
window."""
from portbench import cells

UNIT = "%"


def read(rec):
    idle = cells.metric_reader("device.idle_share").idle_share
    shares = [idle(r["profile"], r["window"].get("periods", []))
              for r in rec["ranks"]]
    if any(s is None for s in shares):
        return None
    return sum(shares) / len(shares)
