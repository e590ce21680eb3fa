"""``idle_pct.forward.train``'s share for the train step's backward: the
program's ``lbt/backward`` ranges (the ``.backward()`` call in
``train/step.py:forward_backward``; autograd's engine thread launches the
backward's work while the caller waits inside the range)."""

from pathlib import Path

from portbench.harness import metric_reader

UNIT = "%"
_idle = metric_reader("idle_pct.forward.train",
                      Path(__file__).resolve().parents[1]).phase_idle_pct


def read(rec):
    return _idle(rec, "lbt/backward")
