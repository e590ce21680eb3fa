"""The whole step's share of the card's peak: the model's operations a
training image (``yardstick.flops``) times the images of the timed window,
over its seconds, over the peak of the precision the configuration
contracts in."""

UNIT = "%"


def read(rec):
    w = rec.get("window")
    if not w or w["seconds"] <= 0:
        return None
    return (100.0 * rec["train_ops_per_image"] * w["images"] / w["seconds"]
            / rec["peak_ops_per_s"])
