"""Milliseconds of a local slot on the mesh: every rank's
``slot_stats`` (`TrainHarness`, each slot between device synchronises),
each slot's largest over the ranks, summed over the window's local
slots and divided by their count."""
UNIT = "ms"


def read(rec):
    ranks = [r["slots"] for r in rec["ranks"]]
    worst = [max(r[i]["seconds"] for r in ranks)
             for i in range(len(ranks[0]))
             if (ranks[0][i]["event"] == "local")]
    return 1e3 * sum(worst) / len(worst) if worst else None
