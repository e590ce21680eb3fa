"""The bytes, operations and roofline bound that ``chip_smoke.py`` writes
beside each kernel's time, held against counts made by hand."""

import math

import pytest

from lbt_tpu_torch.ops.kernels import work

pytest_plugins = ["torch_suite"]


def test_gemm_tn_work_at_stage_1_dw():
    """K2's X^T.g form at ResNet-20's stage-1 dW (batch 128): A [131072,
    144] (im2col'd split-9 plane), B [131072, 16], int64 [144, 16] out."""
    w = work.gemm_tn_work(131072, 144, 16)
    assert w.bytes == 131072 * 144 + 131072 * 16 + 144 * 16 * 8 == 20989952
    assert w.ops == 603979776
    assert w.bound_by == "bytes"
    # 20,989,952 B / 3.35e12 B/s; the ops take 0.000305 ms at 1,979 TOP/s
    assert math.isclose(w.bound_ms, 0.0062656573, rel_tol=1e-8)
    assert math.isclose(w.ops_ms, 0.00030519443, rel_tol=1e-7)


def test_conv_fused_work_at_stage_1():
    """#4 at stage 1: x [128,32,32,16] int16 codes, w [3,3,16,16], stride
    1 SAME: 4,194,304 B of codes in, 2,304 of weights, 8 of scales;
    2,097,152 B of codes out, 256 of moments, 8 of min/max."""
    same = ((1, 1), (1, 1))
    w = work.conv_fused_work((128, 32, 32, 16), 2, (3, 3, 16, 16), (1, 1),
                             same)
    assert w.bytes == 4194304 + 2304 + 8 + 2097152 + 256 + 8 == 6294032
    # 2 x 131,072 pixels x 144 x 16, twice through split-9
    assert w.ops == 1207959552
    assert w.bound_by == "bytes"
    assert math.isclose(w.bound_ms, 0.0018788155, rel_tol=1e-7)
    w8 = work.conv_fused_work((128, 32, 32, 16), 1, (3, 3, 16, 16), (1, 1),
                              same)
    assert (w.bytes - w8.bytes, w8.ops) == (2097152, 603979776)


@pytest.mark.parametrize("xshape,cin_bytes,cout", [((128, 32, 32, 16), 32, 32),
                                                   ((128, 16, 16, 32), 64, 64)])
def test_conv_fused_work_at_the_shortcuts(xshape, cin_bytes, cout):
    """#5 at ResNet-20's stride-2 shortcuts on 9-bit (int16) codes: the
    output reads every second row and column, a quarter of the input."""
    b, h, w, cin = xshape
    work5 = work.conv_fused_work(xshape, 2, (1, 1, cin, cout), (2, 2),
                                 ((0, 0), (0, 0)))
    pixels = b * (h // 2) * (w // 2)
    assert work5.bytes == (pixels * cin_bytes + cin * cout + 8
                           + pixels * cout + 16 * cout + 8)
    assert work5.ops == 2 * pixels * cin * cout * 2
    # a 3x3 conv at stride 2 reads every row, whatever its padding
    for pads in (((0, 1), (0, 1)), ((1, 1), (1, 1))):
        work4 = work.conv_fused_work(xshape, 2, (3, 3, cin, cout), (2, 2),
                                     pads)
        assert work4.bytes - 9 * cin * cout == (b * h * w * cin_bytes + 8
                                                + pixels * cout + 16 * cout
                                                + 8)


@pytest.mark.parametrize("scaled", [False, True])
def test_gemm_work_counts_the_output_type(scaled):
    w = work.gemm_work(131072, 27, 16, scaled)
    assert w.bytes == 131072 * 27 + 27 * 16 + 131072 * 16 * 4 + 4 * scaled
    assert w.ops == 2 * 131072 * 27 * 16 and w.bound_by == "bytes"


def test_quantize_work_is_bound_by_bytes():
    """K1: 1000 f32 in, 1000 int16 codes out, the int32 exponent in, the
    f32 multiplier out and, with statistics, the f32 [min, max] out."""
    w = work.quantize_work(1000, 2, True)
    assert (w.bytes, w.ops, w.bound_by) == (6016, 5000, "bytes")
    assert math.isclose(w.bound_ms, 6016 / 3.35e9)
    assert work.quantize_work(1000, 1, False).bytes == 5008


@pytest.mark.parametrize("mode,by", [(0, "bytes"), (1, "bytes"),
                                     (2, "bytes"), (3, "operations")])
def test_noise_integer_operations_bound_k1(mode, by):
    """K1's noise counts its fewest integer instructions an element
    against the issue rate, 4 warps x 32 lanes x 132 SMs x 1,980 MHz: the
    hashes stay bound by bytes; threefry's 69 instructions an element make
    K1 bound by operations (int8 codes of a stage-1 ResNet-20 activation,
    2,097,152 elements)."""
    n = 2097152
    w = work.quantize_work(n, 1, True, mode)
    assert w.int_ops == work.NOISE_INSTRUCTIONS[mode] * n
    assert w.bound_by == by
    rate = 128 * 132 * 1.98e9
    assert math.isclose(work.ISSUE_PER_S, rate)
    if mode == 3:
        assert math.isclose(w.bound_ms, 69 * n / rate * 1e3)
        slow = work.quantize_work(n, 1, True, 3, rate / 2)
        assert math.isclose(slow.bound_ms, 2 * w.bound_ms)


def test_noise_integer_operations_in_the_fused_epilogue():
    """#4's epilogue draws one noise a BN-input code: threefry's integer
    instructions count over the output elements, beside the int8 ops."""
    same = ((1, 1), (1, 1))
    args = ((128, 32, 32, 16), 2, (3, 3, 16, 16), (1, 1), same)
    w0, w3 = work.conv_fused_work(*args), work.conv_fused_work(*args, 3)
    assert (w0.int_ops, w3.int_ops) == (0, 69 * 128 * 32 * 32 * 16)
    assert (w3.bytes, w3.ops) == (w0.bytes, w0.ops)
    assert w3.bound_by == "operations" and w3.bound_ms > w0.bound_ms
