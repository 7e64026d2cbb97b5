"""Share of a period of the plan in which no operation ran on the device:
the profiled period's busy seconds (`torch.profiler`'s device events,
their union) over the median period of the traced window, which ran
without the profiler.  The profiled period's own wall time is not the
denominator: the profiler slows the host's enqueue 3-5x, and with it the
period, not the device's work."""
import statistics

UNIT = "%"


def idle_share(profile: dict, periods: list) -> float | None:
    if not periods or profile["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / statistics.median(periods))


def read(rec):
    return idle_share(rec["profile"], rec["window"].get("periods", []))
