"""The port's data-parallel train step with the low-bit all-reduce held
against ``lbt_tpu.parallel.dp.make_dp_train_step`` on the CPU, on 2 ranks
against a 2-device mesh (the machinery of ``test_torch_parallel.py``):
the toy Dense model of ``tests/test_parallel.py`` (deterministic
rounding) and ResNet-8 (hash noise), each under the psum transport and
the int16 and int8 rings."""

import pytest

from test_torch_parallel import (check_dp_steps, check_equal_ranks,
                                 jax_steps, run_dp_cases)

pytest_plugins = ["torch_suite"]

TOY = {"kind": "toy", "cfg": {"stochastic": False}}
RESNET = {"kind": "resnet8", "cfg": {"noise_mode": "hash"}}
CASES = {f"{name}_{wire or 'psum'}": dict(model=model, lowbit_bits=8,
                                          lowbit_wire=wire)
         for name, model in (("toy", TOY), ("resnet", RESNET))
         for wire in (None, "int16", "int8")}
# lbt_tpu's int16 ring equals its psum transport bit for bit
# (test_torch_parallel.py::test_lowbit_collective_matches_lbt_tpu holds
# both transports of both packages): ResNet-8's int16 case is held
# against lbt_tpu's psum step, which spares one compile of the step
_JAX_CASE = {"resnet_int16": "resnet_psum"}
_JAX = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_dp_cases(tmp_path_factory.mktemp("lowbit"), CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowbit_dp_step_matches_lbt_tpu(runs, case):
    """3 steps: losses at rtol 1e-5, accuracies and exponents bitwise;
    parameters, velocity, BN state and each rank's ``ebuf`` (against
    ``lbt_tpu``'s shard) at rtol 1e-5, atol 1e-6.  The wire's codes round
    to nearest, so a 1-ulp difference in a gradient at a rounding midpoint
    would flip one and move that residual by a whole grid step; here the
    gradients agree closely enough that no code flips (the residuals
    come out equal)."""
    port = [r[case] for r in runs]
    jcase = _JAX_CASE.get(case, case)
    if jcase not in _JAX:
        _JAX[jcase] = jax_steps(CASES[jcase], port[0]["init"])
    check_dp_steps(CASES[case], port, _JAX[jcase])


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowbit_dp_ranks_hold_equal_state(runs, case):
    """Both ranks' replicated state is bitwise equal after every step;
    each keeps its own ``ebuf``."""
    check_equal_ranks([r[case] for r in runs])
