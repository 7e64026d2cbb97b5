"""The whole training step's share of the card's bf16 peak: the model's
FLOPs of the traced window's slots (`yardstick.train_flops`: 6 per
parameter and token, plus attention's) over the window's time times
989e12."""
from portbench import yardstick

UNIT = "%"


def read(rec):
    w = rec["window"]
    if w["seconds"] <= 0:
        return None
    return 100.0 * rec["flops_per_slot"] * w["slots"] / (
        w["seconds"] * yardstick.PEAK_FLOPS["bfloat16"])
