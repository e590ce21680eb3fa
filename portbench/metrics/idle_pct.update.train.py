"""``idle_pct.forward.train``'s share for the train step's update: the
program's ``lbt/update`` ranges (the commit of the staged state at the
end of ``train/step.py:forward_backward``, then ``absorb_sinks`` and
``sgd_update`` in the train step)."""

from pathlib import Path

from portbench.harness import metric_reader

UNIT = "%"
_idle = metric_reader("idle_pct.forward.train",
                      Path(__file__).resolve().parents[1]).phase_idle_pct


def read(rec):
    return _idle(rec, "lbt/update")
