"""The frozen yardstick against the program's own arithmetic today, and
the model's operation count."""

import dataclasses

import pytest

from conftest import ROOT

from portbench import harness
from portbench.reference import resnet
from portbench.yardstick import flops, roofline


def _headline_calls():
    """Every kernel call shape of the headline's training step at batch
    256: K1 on each conv's input, weight and output, K2 (the stem's
    forward, every dx and dW as GEMMs), #4 / #5 on each 1x1 and 3x3 conv."""
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        "r50-int8-train-b256")
    root, _ = resnet.build(cell.spec)
    b, hw, calls = 256, cell.spec.image_size, []

    def visit(n, hw):
        if n.kind == "conv":
            kh, kw, cin, cout = n.args["ksize"]
            s = n.args["strides"][0]
            pads, (ho, wo) = resnet._geom((hw, hw), (kh, kw), (s, s))
            m, k = b * ho * wo, kh * kw * cin
            calls.append(("k1", (b * hw * hw * cin, 1, True, 2)))
            calls.append(("k1", (kh * kw * cin * cout, 1, True, 2)))
            calls.append(("k1", (m * cout, 1, True, 2)))
            calls.append(("gemm", (m, k, cout, True)))
            calls.append(("gemm_tn", (m, k, cout)))
            if kh in (1, 3):
                calls.append(("conv", ((b, hw, hw, cin), 1, (kh, kw, cin,
                                                             cout),
                                       (s, s), tuple(pads), 2)))
            return ho
        if n.kind == "maxpool":
            return -(-hw // 2)
        if n.kind == "block":
            out = visit(n.children[0], hw)
            visit(n.children[1], hw)
            return out
        for c in n.children:
            hw = visit(c, hw)
        return hw

    visit(root, hw)
    return calls


def test_roofline_copy_equals_the_programs_today():
    """``yardstick/roofline.py`` gives the program's ``work.py`` bytes,
    operations and bounds at every call shape of the headline's step."""
    from lbt_tpu_torch.ops.kernels import work
    fns = {"k1": "quantize_work", "gemm": "gemm_work",
           "gemm_tn": "gemm_tn_work", "conv": "conv_fused_work"}
    calls = _headline_calls()
    assert len(calls) > 300
    for kind, args in calls:
        mine = getattr(roofline, fns[kind])(*args)
        theirs = getattr(work, fns[kind])(*args)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), \
            (kind, args)
        assert mine.bound_ms == theirs.bound_ms
    for name in ("HBM_BYTES_PER_S", "INT8_OPS_PER_S", "F32_OPS_PER_S",
                 "ISSUE_PER_S", "NOISE_INSTRUCTIONS"):
        assert getattr(roofline, name) == getattr(work, name), name


@pytest.mark.parametrize("workload,peak", [
    ("r50-int8-train-b256", 1979e12), ("r50-simbf16-train-b256", 989e12)])
def test_model_operations(workload, peak):
    """ResNet-50 at 224 px: 4,089,184,256 multiply-adds a forward image
    (the 3x3 conv strided; He et al.'s Table 1 counts 3.8e9 with the
    stride on the first 1x1), 118,013,952 of them the stem's; a training
    image 2 * (3 * forward - stem) operations; the peak is the
    configuration's contraction precision's."""
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        workload)
    assert cell.count.forward_macs(cell.spec) == (4_089_184_256,
                                                  118_013_952)
    assert cell.count.train_ops_per_sample(cell.spec) == \
        2 * (3 * 4_089_184_256 - 118_013_952)
    assert flops.peak_ops_per_s(cell.spec) == peak
