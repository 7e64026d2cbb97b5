"""Milliseconds of a mixing-event slot (sub-network or hub round) of the
plan executor (`repro_torch.launch.harness.TrainHarness`): its
``slot_stats``, each slot between two device synchronises, summed over
the window's event slots and divided by their count."""
UNIT = "ms"


def read(rec):
    ev = [s["seconds"] for s in rec["slots"] if s["event"] != "local"]
    return 1e3 * sum(ev) / len(ev) if ev else None
