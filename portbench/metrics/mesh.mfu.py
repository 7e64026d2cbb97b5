"""The whole fleet's share of the cards' bf16 peak: the model's FLOPs of
the traced window's slots over all workers (`yardstick.train_flops`)
over the window's time times the cards times 989e12."""
from portbench import yardstick

UNIT = "%"


def read(rec):
    w = rec["window"]
    if w["seconds"] <= 0:
        return None
    return 100.0 * rec["flops_per_slot"] * w["slots"] / (
        w["seconds"] * len(rec["ranks"]) * yardstick.PEAK_FLOPS["bfloat16"])
