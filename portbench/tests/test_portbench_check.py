"""``check`` with a group of leaves that a model lacks (``bn`` without
BatchNorm): absent from both readings it has no number; absent from the
program's alone it reads infinite; a limit named for an absent number
fails.  Neither crashes."""

import math

from portbench import check

LIMITS = {"loss": 1e-3, "grad": 0.05, "change": 0.05}


def _readings(bn):
    return {"loss": [2.0, 1.5], "grad": {"a.W": 1.0, "b.W": 2.0},
            "change": {"a.W": 0.1, "b.W": 0.2}, "bn": bn,
            "exps": {"a.exp_x": 3}}


def test_a_group_absent_from_both_readings_has_no_number():
    nums = check.numbers(_readings({}), _readings({}))
    assert set(nums) == {"loss", "grad", "change", "exps_differ"}
    assert check.judge(nums, LIMITS)
    assert len(check.lines(nums, LIMITS)) == 3


def test_a_group_absent_from_the_program_s_readings_is_not_correct():
    want = _readings({"bn.mean": 0.3, "bn.var": 0.4})
    got = dict(_readings({}))
    del got["bn"]
    for g in (got, _readings({}), _readings({"bn.mean": 0.3})):
        nums = check.numbers(g, want)
        assert nums["bn"]["value"] == math.inf
        assert not check.judge(nums, {**LIMITS, "bn": 0.05})
    assert check.judge(check.numbers(want, want), {**LIMITS, "bn": 0.05})


def test_a_limit_named_for_an_absent_group_is_not_correct():
    nums = check.numbers(_readings({}), _readings({}))
    limits = {**LIMITS, "bn": 0.05}
    assert not check.judge(nums, limits)
    assert check.lines(nums, limits)[-1].startswith("check bn: absent")
