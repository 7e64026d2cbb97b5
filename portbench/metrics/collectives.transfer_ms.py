"""Milliseconds a mixing event spends in the collectives themselves
(`repro_torch.core.collectives.SECONDS["transfer"]`, each started after a
device synchronise, through ``slot_stats``), the ranks' mean, over the
window's events."""
UNIT = "ms"


def read(rec):
    per = []
    for r in rec["ranks"]:
        per.append([s["transfer_s"] for s in r["slots"]
                    if s["event"] != "local"])
    if not per[0]:
        return None
    return 1e3 * sum(sum(p) for p in per) / (len(per) * len(per[0]))
