"""Collective calls a rank makes in one mixing event
(`repro_torch.core.collectives.COUNTS` through ``slot_stats``), the
ranks' mean: a count that repeats."""
UNIT = "calls"


def read(rec):
    per = []
    for r in rec["ranks"]:
        ev = [s for s in r["slots"] if s["event"] != "local"]
        per.append((sum(sum(s["collectives"].values()) for s in ev), len(ev)))
    if not per[0][1]:
        return None
    return sum(c for c, _ in per) / sum(n for _, n in per)
