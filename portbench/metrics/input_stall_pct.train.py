"""The share of the timed window that the Trainer's loop waited on its
input (``Trainer.epoch_time["stall_seconds"]``): host time blocked on the
next prefetched batch."""

UNIT = "%"


def read(rec):
    w = rec.get("window")
    if not w or w["seconds"] <= 0:
        return None
    return 100.0 * w["stall_seconds"] / w["seconds"]
