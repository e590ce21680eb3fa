"""The port's hand-written kernels held against their plain PyTorch
versions on an NVIDIA GPU, bitwise.  Every test here needs the card and
skips without one.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from lbt_tpu_torch import convert
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.data.pipeline import device_prefetch
from lbt_tpu_torch.dfxp.keys import base_key, fold_in
from lbt_tpu_torch.dfxp.quantize import EXP_MIN
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.nn.norm import sqrt_f32
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels import conv_fused, gemm, quant
from lbt_tpu_torch.train.optim import momentum_init
from lbt_tpu_torch.train.step import make_eval_step, make_train_step
from lbt_tpu_torch.train.trainer import Trainer

pytest_plugins = ["torch_suite"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


MODES = {"hash": quant.HASH, "hash1": quant.HASH1,
         "threefry": quant.THREEFRY}


def _noise(mode, seed, inner=0):
    """The Noise of ``mode`` (None rounds to nearest) from one seed: the
    hashes' seed, or both threefry key words."""
    if mode is None:
        return None
    return quant.Noise(MODES[mode], seed & 0xFFFFFFFF,
                       (seed * 0x9E3779B9) & 0xFFFFFFFF, inner)


def _same(got, want):
    """K1's outputs (codes, multiplier[, min/max]) equal, dtypes too."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [4, 8, 9, 16, 20])
@pytest.mark.parametrize("mode", [None, "hash", "hash1", "threefry"])
@pytest.mark.parametrize("shape", [(1,), (4097,), (3, 5, 7),
                                   (2, 32, 32, 16)])
def test_k1_matches_plain(dev, bits, mode, shape):
    g = torch.Generator().manual_seed(bits)
    mult = 2.0 ** (bits - 1 - 2)
    x = torch.randn(shape, generator=g) * 2
    # ties at +-0.5 and 2.5 after scaling, and a value past the rail
    x.view(-1)[:4] = (torch.tensor([0.5, -0.5, 2.5, 1e9]) / mult)[:x.numel()]
    x = x.to(dev)
    exp = torch.tensor(2, dtype=torch.int32, device=dev)
    noise = _noise(mode, 0x9E3779B9 + bits)
    before = quant.quantize_codes.launches
    got = quant.quantize_codes(x, bits, exp, noise)
    torch.cuda.synchronize()
    assert quant.quantize_codes.launches == before + 1
    want = quant.quantize_codes_plain(x, bits, exp, noise)
    assert got[0].dtype == quant.code_dtype(bits)
    _same(got, want)


@pytest.mark.parametrize("mkn", [(1, 1, 1), (130, 100, 70), (64, 27, 16),
                                 (128, 64, 10), (513, 33, 17),
                                 (1000, 576, 64), (77, 16, 32), (128, 10, 64),
                                 (200, 63, 16), (2048, 147, 64),
                                 (128, 2048, 1000), (128, 1000, 2048)])
@pytest.mark.parametrize("scaled", [False, True])
def test_k2_matches_plain(dev, mkn, scaled):
    m, k, n = mkn
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    a, b = a.to(dev), b.to(dev)
    inv = torch.tensor([2.0 ** -17], device=dev) if scaled else None
    before = gemm.int8_matmul.launches
    got = gemm.int8_matmul(a, b, inv)
    torch.cuda.synchronize()
    assert gemm.int8_matmul.launches == before + 1
    assert torch.equal(got, gemm.int8_matmul_plain(a, b, inv))


def test_k2_unaligned_operand(dev):
    """A view that starts one byte in takes the byte-gather path."""
    g = torch.Generator().manual_seed(0)
    buf = torch.randint(-128, 128, (65 * 32 + 1,), generator=g,
                        dtype=torch.int8).to(dev)
    a = buf[1:].view(65, 32)
    b = torch.randint(-128, 128, (32, 24), generator=g,
                      dtype=torch.int8).to(dev)
    assert torch.equal(gemm.int8_matmul(a, b), gemm.int8_matmul_plain(a, b))


@pytest.mark.parametrize("bits_x", [8, 9])
@pytest.mark.parametrize("wshape,stride", [((3, 3, 16, 32), 2),
                                           ((1, 1, 16, 32), 2),
                                           ((3, 3, 3, 16), 1)])
def test_qconv2d_card_matches_cpu(dev, bits_x, wshape, stride):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 16, 16, wshape[2], generator=g)
    w = torch.rand(wshape, generator=g) - 0.5
    kw = dict(strides=(stride, stride), padding="SAME", bits_x=bits_x,
              bits_w=8)
    want = qops.qconv2d(x, w, 1, -1, **kw)
    got = qops.qconv2d(x.to(dev), w.to(dev), 1, -1, **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("engine", ["sim", "sim_bf16"])
@pytest.mark.parametrize("wshape,stride", [((3, 3, 16, 32), 2),
                                           ((1, 1, 16, 32), 2),
                                           ((3, 3, 3, 16), 1)])
def test_sim_qconv2d_card_matches_cpu(dev, engine, wshape, stride):
    """The sim engines' conv on the card (cuDNN, TF32 off) and on the
    CPU, stochastic with threefry noise: output and both gradients within
    1e-5 (sim) or one bf16 ulp (sim_bf16) of each other; the operands'
    codes are K1's and the plain version's, equal bitwise."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 16, 16, wshape[2], generator=g)
    w = torch.rand(wshape, generator=g) - 0.5
    kw = dict(strides=(stride, stride), padding="SAME", bits_x=9, bits_w=8,
              bits_g=8, exp_g=-2, engine=engine, stochastic=True,
              key_x=(1, 2), key_w=(3, 4))
    tol = dict(rtol=1e-5, atol=1e-6) if engine == "sim" else dict(
        rtol=2.0 ** -8, atol=1e-6)
    outs, gy = [], None
    for d in ("cpu", dev):
        xd = x.detach().to(d).requires_grad_()
        wd = w.detach().to(d).requires_grad_()
        y = qops.qconv2d(xd, wd, 1, -1, **kw)
        if gy is None:  # one cotangent on the 8-bit grid, for both
            gy = torch.randint(-128, 128, y.shape, generator=g) / 2.0 ** 9
        y.backward(gy.to(d))
        outs.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def test_resnet20_card_matches_cpu(dev):
    cfg = QuantConfig.uniform(8)
    cpu = cifar10_resnet(cfg, 20).init(torch.Generator().manual_seed(0))
    card = cifar10_resnet(cfg, 20).init(
        torch.Generator().manual_seed(0)).to(dev)
    x = torch.from_numpy(
        np.random.default_rng(0).normal(0, 1, (8, 32, 32, 3)).astype(
            np.float32))
    want = cpu.apply(x, Ctx(train=False))
    got = card.apply(x.to(dev), Ctx(train=False)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bits", [8, 9])
@pytest.mark.parametrize("mode", [None, "hash", "threefry"])
@pytest.mark.parametrize("shape", [(1,), (4097,), (3, 5, 7),
                                   (2, 32, 32, 16), (64, 10)])
def test_k1_stats_matches_plain(dev, bits, mode, shape):
    g = torch.Generator().manual_seed(bits + len(shape))
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    noise = _noise(mode, 0x1234567 + bits)
    got = quant.quantize_codes(x, bits, 1, noise, stats=True)
    want = quant.quantize_codes_plain(x, bits, 1, noise, stats=True)
    torch.cuda.synchronize()
    _same(got, want)


# every K1 shape of ResNet-20's serving forward and training step at
# batch 128: activations and cotangents, the head, weights, BN vectors
K1_PATH_SHAPES = [(128, 32, 32, 3), (128, 32, 32, 16), (128, 16, 16, 32),
                  (128, 8, 8, 64), (128, 64), (128, 10), (3, 3, 3, 16),
                  (3, 3, 16, 16), (3, 3, 16, 32), (3, 3, 32, 32),
                  (3, 3, 32, 64), (3, 3, 64, 64), (1, 1, 16, 32),
                  (1, 1, 32, 64), (64, 10), (16,), (32,), (64,), (10,)]
# odd sizes: one element, the vector path's tail (3, 4095, 4097), a prime
K1_ODD_SIZES = [(1,), (3,), (4095,), (4097,), (1000003,)]


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("mode", [None, "hash", "hash1", "threefry"])
@pytest.mark.parametrize("bits", [8, 9])
@pytest.mark.parametrize("shape", K1_PATH_SHAPES + K1_ODD_SIZES)
def test_k1_every_path_shape(dev, shape, bits, mode, stats):
    """Codes, multiplier and min/max bitwise at every path shape and odd
    size, both code widths, every rounding, with and without statistics,
    one launch a call."""
    g = torch.Generator().manual_seed(len(shape) * 31 + shape[0])
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    exp = torch.tensor(1, dtype=torch.int32, device=dev)
    noise = _noise(mode, 0xA5A5F00D ^ shape[0])
    before = quant.quantize_codes.launches
    got = quant.quantize_codes(x, bits, exp, noise, stats)
    torch.cuda.synchronize()
    assert quant.quantize_codes.launches == before + 1
    _same(got, quant.quantize_codes_plain(x, bits, exp, noise, stats))


@pytest.mark.parametrize("mode", ["hash", "hash1", "threefry"])
@pytest.mark.parametrize("bits", [4, 8, 9, 16])
@pytest.mark.parametrize("shape", [(5,), (4097,), (3, 5, 7),
                                   (128, 16, 16, 32), (7, 1000003)])
def test_k1_shared_axis0_matches_plain(dev, shape, bits, mode):
    """A draw of ``shape[1:]`` shared along axis 0 (``noise_shared_axis0``,
    the counter ``i % inner``): codes and min/max bitwise, rows of equal
    inputs rounded alike."""
    g = torch.Generator().manual_seed(len(shape) + bits)
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    x[-1] = x[0]
    inner = int(np.prod(shape[1:]))
    noise = _noise(mode, 0x5EED + bits, inner)
    got = quant.quantize_codes(x, bits, 1, noise, stats=True)
    torch.cuda.synchronize()
    _same(got, quant.quantize_codes_plain(x, bits, 1, noise, stats=True))
    assert torch.equal(got[0][-1], got[0][0])


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("mode", [None, "hash", "threefry"])
def test_k1_misaligned_view(dev, offset, mode):
    """A contiguous view that starts 4-12 bytes past a 16-byte boundary
    takes the scalar path: same codes at the same flat index."""
    g = torch.Generator().manual_seed(offset)
    buf = (torch.randn(300007, generator=g) * 5).to(dev)
    x = buf[offset:]
    assert x.is_contiguous() and x.data_ptr() % 16
    noise = _noise(mode, 77)
    got = quant.quantize_codes(x, 9, 3, noise, stats=True)
    torch.cuda.synchronize()
    _same(got, quant.quantize_codes_plain(x, 9, 3, noise, stats=True))


@pytest.mark.parametrize("bits", [8, 9, 16])
def test_k1_subnormal_inputs_at_exp_min(dev, bits):
    """At the controller's lowest exponent the multiplier is 2**(bits-1+110):
    subnormal inputs land on codes that flush-to-zero would lose."""
    v = torch.tensor([1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
                      5.877e-39, 0.0, -0.0], dtype=torch.float32)
    x = v.repeat(5000)[:39999].contiguous().to(dev)
    assert (x.abs() < 1.1754944e-38).all()
    for noise in (None, _noise("hash", 5), _noise("threefry", 5)):
        got = quant.quantize_codes(x, bits, EXP_MIN, noise, stats=True)
        want = quant.quantize_codes_plain(x, bits, EXP_MIN, noise,
                                          stats=True)
        torch.cuda.synchronize()
        _same(got, want)
        # flushed to zero, min and max would be 0 and the noise alone
        # would decide every stochastic code
        assert got[2][0].item() < 0 < got[2][1].item()


@pytest.mark.parametrize("mode", [None, "hash", "threefry"])
def test_k1_infinite_inputs(dev, mode):
    """+-inf clip to the rails; min / max report them."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(70001, generator=g)
    x[::97] = float("inf")
    x[5::89] = -float("inf")
    x = x.to(dev)
    noise = _noise(mode, 123)
    got = quant.quantize_codes(x, 8, 0, noise, stats=True)
    torch.cuda.synchronize()
    _same(got, quant.quantize_codes_plain(x, 8, 0, noise, stats=True))
    assert got[2].tolist() == [-float("inf"), float("inf")]


def test_k1_exponents_build_the_multiplier(dev):
    """Every exponent from EXP_MIN to bits-1, and the first whose
    multiplier is inf: the kernel's multiplier is the plain version's."""
    x = torch.linspace(-3, 3, 9000, device=dev)
    for bits in (8, 9):
        for e in [*range(EXP_MIN, bits), bits - 1 - 128]:
            exp = torch.tensor([e], dtype=torch.int32, device=dev)
            got = quant.quantize_codes(x, bits, exp)
            _same(got, quant.quantize_codes_plain(x, bits, exp))
            assert got[1].shape == (1,)


NINE = _noise("hash", 9)


def test_k1_graph_replays_reset_the_ticket(dev):
    """100 replays of a captured multi-block K1 with min/max, each on
    fresh data, give the plain version's codes and min/max: the ticket
    counter is back at 0 after every call.  A capture on a stream with no
    eager call (its own scratch, zeroed inside the graph) too."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(128, 16, 16, 32, generator=g).to(dev)
    exp = torch.tensor(2, dtype=torch.int32, device=dev)
    for warm in (True, False):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        if warm:
            with torch.cuda.stream(side):
                quant.quantize_codes(x, 8, exp, NINE, stats=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = quant.quantize_codes(x, 8, exp, NINE, stats=True)
        for i in range(100):
            x.copy_(torch.randn(x.shape, generator=g) * (1 + i % 7))
            graph.replay()
            torch.cuda.synchronize()
            _same(out, quant.quantize_codes_plain(x, 8, exp, NINE, stats=True))
    got = quant.quantize_codes(x, 8, exp, NINE, stats=True)
    _same(got, quant.quantize_codes_plain(x, 8, exp, NINE, stats=True))


def test_k1_two_streams_at_once(dev):
    """Multi-block calls with min/max on two streams at once, each stream
    with its own ticket: every result is the plain version's."""
    g = torch.Generator().manual_seed(1)
    xs = [(torch.randn(128, 32, 32, 16, generator=g) * (i + 1)).to(dev)
          for i in range(2)]
    streams = [torch.cuda.Stream() for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for rep in range(20):
        for i, (x, s) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(s):
                outs[i].append(quant.quantize_codes(
                    x, 9, 1, _noise("threefry", rep), stats=True))
    torch.cuda.synchronize()
    for i, x in enumerate(xs):
        for rep, got in enumerate(outs[i]):
            _same(got, quant.quantize_codes_plain(
                x, 9, 1, _noise("threefry", rep), stats=True))


@pytest.mark.parametrize("mode", ["hash", "hash1", "threefry"])
def test_k1_stochastic_codes_are_unbiased(dev, mode):
    """E[floor(s + u)] = s: over 256 seeds the mean code of each of 4096
    fixed values s (off-grid, inside the rails) lies within 6 standard
    deviations of s, sd <= 1/(2 sqrt(256)) = 1/32 of a code, and the mean
    over all of them within 6 sd of the mean, sd <= 1/(2 sqrt(256 * 4096))
    (rounding errors of distinct elements and seeds taken as independent)."""
    rng = np.random.default_rng(4)
    scaled = rng.uniform(-100, 100, 4096)
    x = torch.from_numpy((scaled / 32).astype(np.float32)).to(dev)
    s = x.double() * 32
    acc = torch.zeros_like(s)
    seeds = rng.integers(0, 2 ** 32, 256)
    for seed in seeds:
        acc += quant.quantize_codes(x, 8, 2, _noise(mode, int(seed)))[0]
    err = acc / len(seeds) - s
    assert err.abs().max().item() < 6 / 32
    assert abs(err.mean().item()) < 6 / (2 * (256 * 4096) ** 0.5)


@pytest.mark.parametrize("mode", ["hash", "threefry"])
def test_fused_stochastic_codes_are_unbiased(dev, mode):
    """#4/#5's stochastic epilogue on the card: over 256 seeds the mean
    code of each conv output lies within 6 sd of y*mult (sd <= 1/32 of a
    code), their mean error within 6 sd of 0 (sd <= 1/(2 sqrt(256 n)))."""
    g = torch.Generator().manual_seed(2)
    xc = torch.randint(-8, 8, (2, 8, 8, 32), generator=g,
                       dtype=torch.int8).to(dev)
    rng = np.random.default_rng(5)
    inv = torch.tensor([1.0 / 64], device=dev)
    mult = torch.tensor([4.0], device=dev)
    for wshape in ((1, 1, 32, 32), (3, 3, 32, 32)):
        wc = torch.randint(-2, 3, wshape, generator=g,
                           dtype=torch.int8).to(dev)
        fused = (conv_fused.conv3x3_fused if wshape[0] == 3
                 else conv_fused.conv1x1_fused)
        pads = qops.conv_pads("SAME", (8, 8), wshape[:2], (1, 1))
        patches = qops.im2col(xc, wshape[:2], (1, 1), pads).double()
        scaled = (patches @ wc.reshape(-1, 32).double()) * (4.0 / 64)
        assert scaled.abs().max().item() < 127
        acc = torch.zeros_like(scaled)
        seeds = rng.integers(0, 2 ** 32, 256)
        for seed in seeds:
            codes = fused(xc, wc, inv, mult, strides=(1, 1), pads=pads,
                          noise=_noise(mode, int(seed)))[0]
            acc += codes.reshape(scaled.shape)
        err = acc / len(seeds) - scaled
        assert err.abs().max().item() < 6 / 32
        assert abs(err.mean().item()) < 6 / (2 * (256 * err.numel()) ** 0.5)


@pytest.mark.parametrize("kmn", [(1, 1, 1), (128, 64, 10), (300, 27, 16),
                                 (2048, 144, 32), (131072, 144, 16),
                                 (70001, 576, 64), (100352, 147, 64),
                                 (128, 2048, 1000), (392, 4608, 512)])
def test_k2_tn_matches_plain(dev, kmn):
    k, m, n = kmn
    g = torch.Generator().manual_seed(k + m + n)
    a = torch.randint(-128, 128, (k, m), generator=g,
                      dtype=torch.int8).to(dev)
    b = torch.randint(-128, 128, (k, n), generator=g,
                      dtype=torch.int8).to(dev)
    before = gemm.int8_matmul_tn.launches
    got = gemm.int8_matmul_tn(a, b)
    torch.cuda.synchronize()
    assert gemm.int8_matmul_tn.launches == before + 1
    assert torch.equal(got, gemm.int8_matmul_tn_plain(a, b))


def test_k2_tn_sums_past_int32(dev):
    """2**17 rows of (-128)(-128) sum to 2**31: int64 holds it."""
    a = torch.full((2 ** 17, 3), -128, dtype=torch.int8, device=dev)
    b = torch.full((2 ** 17, 2), -128, dtype=torch.int8, device=dev)
    assert gemm.int8_matmul_tn(a, b)[0, 0].item() == 2 ** 31


# ResNet-20's conv -> BN shapes, then ResNet-50's at batch 2: (x shape,
# HWIO, stride)
FUSED_SHAPES = [((8, 32, 32, 3), (3, 3, 3, 16), 1),
                ((8, 32, 32, 16), (3, 3, 16, 16), 1),
                ((8, 32, 32, 16), (3, 3, 16, 32), 2),
                ((8, 16, 16, 32), (3, 3, 32, 32), 1),
                ((8, 16, 16, 32), (3, 3, 32, 64), 2),
                ((8, 8, 8, 64), (3, 3, 64, 64), 1),
                ((8, 32, 32, 16), (1, 1, 16, 32), 2),
                ((8, 16, 16, 32), (1, 1, 32, 64), 2),
                ((3, 7, 5, 20), (3, 3, 20, 70), 1),
                ((3, 7, 5, 20), (1, 1, 20, 70), 1),
                # 3x3 past one 1024-K weight panel: K = 1152, 2304, 4608
                ((2, 28, 28, 128), (3, 3, 128, 128), 2),
                ((2, 14, 14, 128), (3, 3, 128, 128), 1),
                ((2, 14, 14, 256), (3, 3, 256, 256), 2),
                ((2, 7, 7, 256), (3, 3, 256, 256), 1),
                ((2, 7, 7, 512), (3, 3, 512, 512), 1),
                # 1x1 at Cin 256-2048, Cout up to 2048; the shortcuts
                ((2, 14, 14, 256), (1, 1, 256, 64), 1),
                # K = 512 at a 64-wide Cout tile: 48 KB of dynamic shared
                # memory, past the default limit with the static part
                ((16, 28, 28, 512), (1, 1, 512, 128), 1),
                ((2, 7, 7, 2048), (1, 1, 2048, 512), 1),
                ((2, 7, 7, 512), (1, 1, 512, 2048), 1),
                ((2, 14, 14, 64), (1, 1, 64, 256), 1),
                ((2, 28, 28, 256), (1, 1, 256, 512), 2),
                ((2, 14, 14, 1024), (1, 1, 1024, 2048), 2)]


@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("xdtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("mode", [None, "hash", "hash1", "threefry",
                                  "hash1 shared", "threefry shared"])
@pytest.mark.parametrize("case", range(len(FUSED_SHAPES)))
def test_conv_fused_matches_plain(dev, case, mode, xdtype, round_bf16):
    """Codes, moments and min/max bitwise, one launch, with and without
    the conv output's rounding to bfloat16 (a bf16 carrier); the noise
    per element or drawn once along axis 0."""
    xshape, wshape, s = FUSED_SHAPES[case]
    g = torch.Generator().manual_seed(case)
    lim = 256 if xdtype == torch.int16 else 128
    xc = torch.randint(-lim, lim, xshape, generator=g, dtype=xdtype).to(dev)
    wc = torch.randint(-128, 128, wshape, generator=g,
                       dtype=torch.int8).to(dev)
    inv = torch.tensor([2.0 ** -16], device=dev)
    mult = torch.tensor([2.0 ** -3], device=dev)
    pads = qops.conv_pads("SAME", xshape[1:3], wshape[:2], (s, s))
    ho, wo = qops.out_hw(xshape[1], xshape[2], wshape[:2], (s, s), pads)
    noise = _noise(mode and mode.split()[0], 0xC0FFEE + case,
                   ho * wo * wshape[3] if mode and mode.endswith("shared")
                   else 0)
    kw = dict(strides=(s, s), pads=pads, noise=noise, round_bf16=round_bf16)
    fused = (conv_fused.conv3x3_fused if wshape[0] == 3
             else conv_fused.conv1x1_fused)
    before = fused.launches
    got = fused(xc, wc, inv, mult, **kw)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    want = conv_fused.conv_fused_plain(xc, wc, inv, mult, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _trained(dev, steps=2, cfg=QuantConfig.uniform(8, noise_mode="hash")):
    model = cifar10_resnet(cfg, 8, weight_decay=2e-4).init(
        torch.Generator().manual_seed(0)).to(dev)
    vel = momentum_init(dict(model.net.named_parameters()))
    step = make_train_step(model, TrainConfig())
    rng = np.random.default_rng(0)
    losses = []
    for i in range(steps):
        x = torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3)).astype(
            np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, 10, (4,))).to(dev)
        losses.append(step(model, vel, x, y, i, 1e-2,
                           base_key(3, cfg.noise_impl))["loss"])
    return convert.to_jax_numpy(model, vel), losses


def test_device_prefetch_to_cuda_keeps_bytes_and_order(dev):
    """50 batches through the pinned side-stream copies arrive in order
    with their bytes, and each step on the consumer's stream reads them
    after their copy."""
    rng = np.random.default_rng(0)
    src = [(rng.normal(0, 1, (64, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, (64,)).astype(np.int32)) for _ in range(50)]
    got = []
    for x, y in device_prefetch(iter(src), device=dev):
        assert x.device.type == "cuda" and y.dtype == torch.int32
        got.append((x * 1.0, y + 0))  # a kernel on the consumer's stream
    assert len(got) == 50
    for (x, y), (gx, gy) in zip(src, got):
        assert np.array_equal(gx.cpu().numpy(), x)
        assert np.array_equal(gy.cpu().numpy(), y)


def test_checkpoint_card_cpu_round_trip(dev, tmp_path):
    """A checkpoint written from the card restores on the CPU, and one
    written there restores on the card, bit for bit."""
    cfg = QuantConfig.uniform(8, noise_mode="hash")
    tc = TrainConfig(checkpoint_dir=str(tmp_path / "a"))
    data = {"train": (np.zeros((4, 32, 32, 3), np.float32),
                      np.zeros(4, np.int32))}
    card = Trainer(cifar10_resnet(cfg, 8), tc, data, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for v in card.velocity.values():
        v.normal_(generator=g)
    card.step, card.epoch = 7, 2
    card.save()
    cpu = Trainer(cifar10_resnet(cfg, 8), tc, data, device="cpu")
    assert cpu.maybe_restore() and cpu.step == 7 and cpu.epoch == 2
    want = {**card.model.net.state_dict(), **card.velocity}
    got = {**cpu.model.net.state_dict(), **cpu.velocity}
    for k, v in want.items():
        assert got[k].device.type == "cpu" and torch.equal(got[k], v.cpu())
    cpu.save(str(tmp_path / "b"))
    back = Trainer(cifar10_resnet(cfg, 8),
                   TrainConfig(checkpoint_dir=str(tmp_path / "b")), data,
                   device=dev)
    assert back.maybe_restore()
    for k, v in {**back.model.net.state_dict(), **back.velocity}.items():
        assert v.device.type == "cuda" and torch.equal(v, want[k])


def test_trainer_keeps_a_card_model_on_the_card(dev):
    """A model built on the card and given to ``Trainer`` with no device
    stays there (the default is the card), and its step and eval launch
    the kernels."""
    cfg = QuantConfig.uniform(8, noise_mode="hash")
    model = cifar10_resnet(cfg, 8).to(dev)
    rng = np.random.default_rng(0)
    data = {"train": (rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32),
                      rng.integers(0, 10, (8,)).astype(np.int32)),
            "test": (rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32),
                     rng.integers(0, 10, (8,)).astype(np.int32))}
    tr = Trainer(model, TrainConfig(batch_size=4, eval_batch_size=4), data)
    assert tr.device.type == "cuda" and model.device.type == "cuda"
    assert all(v.device.type == "cuda" for v in tr.velocity.values())
    quant.quantize_codes.launches = gemm.int8_matmul.launches = 0
    conv_fused.conv3x3_fused.launches = 0
    tr.train_epoch(0)
    assert conv_fused.conv3x3_fused.launches > 0
    n = gemm.int8_matmul.launches
    tr.evaluate()
    assert gemm.int8_matmul.launches > n and quant.quantize_codes.launches


def test_bn_sqrt_card_equals_cpu(dev):
    """BN's root is the same f32 on the card and on the CPU (``torch.sqrt``
    of f32 is not: the CPU's is one ulp off near ties)."""
    v = torch.from_numpy(np.random.default_rng(0).uniform(
        0.01, 1e4, 1_000_000).astype(np.float32))
    v[0] = 75.14901733398438
    assert torch.equal(sqrt_f32(v.to(dev)).cpu(), sqrt_f32(v))


@pytest.mark.parametrize("faithful", [False, True])
def test_eval_step_card_matches_cpu(dev, faithful):
    cfg = QuantConfig.uniform(8, noise_mode="hash", faithful_eval=faithful)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (32, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (32,)))
    out = []
    for d in (torch.device("cpu"), dev):
        model = cifar10_resnet(cfg, 20).init(
            torch.Generator().manual_seed(0)).to(d)
        step = make_eval_step(model, faithful_eval=faithful)
        m = step(model, x.to(d), y.to(d), fold_in(base_key(3), 0xE7A1))
        out.append((m["loss"].item(), m["accuracy"].item()))
    (closs, cacc), (gloss, gacc) = out
    np.testing.assert_allclose(gloss, closs, rtol=1e-5)
    assert gacc == cacc


@pytest.mark.parametrize("cfg", [
    QuantConfig.uniform(8, noise_mode="hash"), QuantConfig.uniform(8),
    QuantConfig.uniform(8, engine="sim", noise_mode="prng"),
    QuantConfig.uniform(8, engine="sim_bf16", noise_mode="prng"),
    QuantConfig.fp32(),
    QuantConfig.uniform(8, engine="int8", noise_mode="prng",
                        noise_impl="unsafe_rbg")],
    ids=["int8-hash", "int8-prng", "sim-prng", "sim_bf16-prng", "fp32",
         "int8-rbg"])
def test_train_step_card_matches_cpu(dev, cfg):
    """Two steps of ResNet-8 on the card and on the CPU, under the int8
    engine with hash, threefry and (unsafe_rbg keys) Philox noise, both
    sim engines and the FP32 arm: exponents equal, losses and floats to 1e-5 (the card's
    reductions and cuDNN's convs sum in another order).  Under ``sim``
    the f32 conv sums of cuDNN and of the CPU are not exact (9-bit codes
    times 8-bit codes over up to 4,096 terms: their rounding, about
    sqrt(n) 2**-24 = 4e-6 of the sum of the terms' magnitudes, which runs
    to 10x the result's), so the floats hold within 1e-4 of the leaf's
    largest magnitude (on an H100 the largest difference was 9e-6 of it)."""
    (cp, cq, cv), closs = _trained(torch.device("cpu"), cfg=cfg)
    (gp, gq, gv), gloss = _trained(dev, cfg=cfg)
    np.testing.assert_allclose([x.item() for x in gloss],
                               [x.item() for x in closs], rtol=1e-5)
    leaf_scaled = cfg.engine == "sim"

    def cmp(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                cmp(a[k], b[k])
        elif a.dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        else:
            atol = (1e-4 * float(np.abs(b).max()) if leaf_scaled
                    else 1e-5)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)

    for a, b in ((gp, cp), (gq, cq), (gv, cv)):
        cmp(a, b)


def test_gated_off_step_makes_no_blocking_call(dev):
    """A ResNet-8 step under the headline's options with its controllers
    gated off (cadence 2, an odd step) makes no blocking CUDA runtime call
    inside its ``lbt/step`` range (the names that portbench's
    ``host_syncs_per_step.train`` counts): the barriers make the hold
    statistic on the card, and the step holds the exponents without
    reading them back, every gradient site of the model.  The first such
    step clamps ``initial_exponent_g=20`` to 7 on the card as on the
    CPU."""
    from torch.profiler import ProfilerActivity, profile

    from lbt_tpu_torch.nn import core
    syncs = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy"}
    cfg = QuantConfig.uniform(8, engine="int8", noise_mode="hash1",
                              fused_bn=True, range_update_every=2,
                              range_update_warmup_steps=0, conv_act_extra=0,
                              act_dtype="bf16", initial_exponent_g=20)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (8,)).astype(np.int64)
    runs, exps = [], []
    for d in (torch.device("cpu"), dev):
        model = cifar10_resnet(cfg, 8).init(
            torch.Generator().manual_seed(0)).to(d)
        vel = momentum_init(dict(model.net.named_parameters()))
        step = make_train_step(model, TrainConfig())
        runs.append(lambda s, model=model, vel=vel, step=step, d=d: step(
            model, vel, torch.from_numpy(x).to(d), torch.from_numpy(y).to(d),
            s, 1e-2, base_key(3)))
        runs[-1](1)
        exps.append({k: int(b) for k, b in model.net.named_buffers()
                     if k.endswith("exp_grad")})
    assert exps[1] == exps[0] and set(exps[0].values()) == {7}
    run = runs[1]
    run(2)
    run(3)
    torch.cuda.synchronize()
    held = core.hold_exponents.held_sites
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(5)
    assert core.hold_exponents.held_sites - held == len(exps[1])
    events = prof.events()
    (span,) = [e for e in events if e.name == "lbt/step"]
    inside = {e.name for e in events
              if span.time_range.start <= e.time_range.start
              <= span.time_range.end}
    assert "cudaLaunchKernel" in inside
    assert not syncs & inside, sorted(syncs & inside)


# the redesigned kernels at the edges of their tiles and pipelines

@pytest.mark.parametrize("m", [1, 17, 131072])
@pytest.mark.parametrize("n", [10, 16, 32, 64])
@pytest.mark.parametrize("k", [27, 144, 576])
def test_k2_tensor_core_shapes(dev, m, n, k):
    """K = 27 (unaligned rows, one k32 step), 144 (not a multiple of the
    64-byte stage) and 576; N = 10 (ragged n8 tile) to 64; M from one
    row to stage 1's 131072: both outputs bitwise."""
    g = torch.Generator().manual_seed(m * n + k)
    a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    a, b = a.to(dev), b.to(dev)
    for inv in (None, torch.tensor([2.0 ** -15], device=dev)):
        got = gemm.int8_matmul(a, b, inv)
        torch.cuda.synchronize()
        assert torch.equal(got, gemm.int8_matmul_plain(a, b, inv))


@pytest.mark.parametrize("k", [2 ** 16 - 1, 2 ** 16, 2 ** 16 + 33])
@pytest.mark.parametrize("mn", [(144, 16), (27, 10), (576, 64), (130, 70)])
def test_k2_tn_chunk_boundaries(dev, k, mn):
    """The X^T.g form's split-K chunks (at most 2**16 rows each) around
    one chunk's end, with the (-128)(-128) extremes in every row; rows
    staged 16 bytes at a time (144, 16, 576, 64), as one flat range (27,
    10) and a word at a time (130, 70), each into the permuted output."""
    m, n = mn
    g = torch.Generator().manual_seed(k + m)
    a = torch.randint(-128, 128, (k, m), generator=g, dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    a[:, 0] = -128
    b[:, 0] = -128
    a, b = a.to(dev), b.to(dev)
    got = gemm.int8_matmul_tn(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, gemm.int8_matmul_tn_plain(a, b))
    assert got[0, 0].item() == k * 2 ** 14


# (x shape, HWIO, stride, padding): the stem (Cin = 3) at strides 1 and 2,
# stride 2 with SAME and explicit padding, a width that is not a multiple
# of the 64-pixel tile
SPLIT9_SHAPES = [((4, 32, 32, 3), (3, 3, 3, 16), 1, "SAME"),
                 ((2, 9, 37, 3), (3, 3, 3, 16), 2, ((0, 1), (1, 1))),
                 ((4, 32, 32, 16), (3, 3, 16, 32), 2, "SAME"),
                 ((4, 32, 32, 16), (3, 3, 16, 32), 2, ((1, 1), (0, 2))),
                 ((2, 9, 37, 16), (3, 3, 16, 16), 1, "SAME"),
                 ((2, 8, 8, 64), (3, 3, 64, 64), 1, "SAME")]


@pytest.mark.parametrize("codes", ["-256", "255", "-1", "mixed"])
@pytest.mark.parametrize("case", range(len(SPLIT9_SHAPES)))
def test_conv_fused_split9_extremes(dev, case, codes):
    """#4 on 9-bit codes at the split-9 extremes (h = -128, 127, -1 with
    l = 0 or 1), against weights at -128 and 127 too, both roundings."""
    xshape, wshape, s, padding = SPLIT9_SHAPES[case]
    g = torch.Generator().manual_seed(case)
    if codes == "mixed":
        pick = torch.tensor([-256, 255, -1, 0, 1], dtype=torch.int16)
        xc = pick[torch.randint(0, 5, xshape, generator=g)]
    else:
        xc = torch.full(xshape, int(codes), dtype=torch.int16)
    wc = torch.randint(-128, 128, wshape, generator=g, dtype=torch.int8)
    wc.view(-1)[:2] = torch.tensor([-128, 127], dtype=torch.int8)
    xc, wc = xc.to(dev), wc.to(dev)
    inv = torch.tensor([2.0 ** -18], device=dev)
    mult = torch.tensor([2.0 ** -1], device=dev)
    pads = (qops.conv_pads(padding, xshape[1:3], wshape[:2], (s, s))
            if padding == "SAME" else padding)
    for noise in (None, _noise("hash", 0xBADC0DE + case),
                  _noise("threefry", 0xBADC0DE + case)):
        kw = dict(strides=(s, s), pads=pads, noise=noise)
        got = conv_fused.conv3x3_fused(xc, wc, inv, mult, **kw)
        torch.cuda.synchronize()
        want = conv_fused.conv_fused_plain(xc, wc, inv, mult, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("xdtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("xshape,wshape", [((128, 32, 32, 16), (1, 1, 16, 32)),
                                           ((128, 16, 16, 32), (1, 1, 32, 64))])
def test_conv1x1_fused_at_the_shortcut_shapes(dev, xshape, wshape, xdtype):
    """#5 at ResNet-20's two stride-2 shortcuts, batch 128."""
    g = torch.Generator().manual_seed(wshape[3])
    lim = 256 if xdtype == torch.int16 else 128
    xc = torch.randint(-lim, lim, xshape, generator=g, dtype=xdtype).to(dev)
    wc = torch.randint(-128, 128, wshape, generator=g,
                       dtype=torch.int8).to(dev)
    inv = torch.tensor([2.0 ** -13], device=dev)
    mult = torch.tensor([2.0 ** -1], device=dev)
    kw = dict(strides=(2, 2), pads=((0, 0), (0, 0)),
              noise=_noise("threefry", 0x51DE))
    before = conv_fused.conv1x1_fused.launches
    got = conv_fused.conv1x1_fused(xc, wc, inv, mult, **kw)
    torch.cuda.synchronize()
    assert conv_fused.conv1x1_fused.launches == before + 1
    want = conv_fused.conv_fused_plain(xc, wc, inv, mult, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_entry_points_default_to_the_card(dev):
    """``Predictor`` and ``Trainer`` given a model built on the CPU and no
    device move it to the card and run there."""
    from lbt_tpu_torch.infer import Predictor
    cfg = QuantConfig.uniform(8, noise_mode="hash")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    p = Predictor(cifar10_resnet(cfg, 8))
    assert p.device == torch.device("cuda", 0)
    assert p(x).device == torch.device("cuda", 0)
    data = {"train": (x, rng.integers(0, 10, (4,)).astype(np.int32)),
            "test": (x, rng.integers(0, 10, (4,)).astype(np.int32))}
    tr = Trainer(cifar10_resnet(cfg, 8),
                 TrainConfig(batch_size=4, eval_batch_size=4), data)
    assert tr.model.device == torch.device("cuda", 0)
    assert all(v.device.type == "cuda" for v in tr.velocity.values())


# the bench headline: ResNet-50 under fused BN and bf16 carriers

def _headline(act_dtype):
    import dataclasses
    return dataclasses.replace(
        QuantConfig.uniform(8, engine="int8", noise_mode="hash1"),
        fused_bn=True, range_update_every=8, act_dtype=act_dtype,
        conv_act_extra=0, range_update_warmup_steps=1)


@pytest.mark.parametrize("act_dtype", ["f32", "bf16"])
def test_headline_resnet50_card_matches_cpu(dev, act_dtype):
    """Three steps of ResNet-50 (32x32, batch 4, steps 1-2 gated off) on
    the card and on the CPU: exponents equal after every step.  f32
    carriers: losses and every float at rtol = atol = 1e-5 (the card's
    f32 reductions run in another order).  bf16 carriers: after step 0
    the loss at rtol 1e-5 and every parameter and velocity leaf within a
    relative L2 distance of 0.1; an f32 ulp from another summation order
    can round to another bfloat16 and flip a stochastic cotangent code,
    and such flips cascade down the net (ROADMAP queue 3, finding 2), so
    later steps are held for their exponents only."""
    from lbt_tpu_torch.models import imagenet_resnet
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3)).astype(
                    np.float32)), torch.from_numpy(rng.integers(0, 10, (4,))))
               for _ in range(3)]
    runs = []
    for d in (torch.device("cpu"), dev):
        model = imagenet_resnet(_headline(act_dtype), 50, num_classes=10,
                                image_size=32, weight_decay=2e-4).init(
                                    torch.Generator().manual_seed(0)).to(d)
        vel = momentum_init(dict(model.net.named_parameters()))
        step = make_train_step(model, TrainConfig())
        states = []
        for i, (x, y) in enumerate(batches):
            loss = step(model, vel, x.to(d), y.to(d), i, 1e-2,
                        base_key(3))["loss"].item()
            states.append((loss, convert.to_jax_numpy(model, vel)))
        runs.append(states)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    for i, ((closs, cpu), (gloss, card)) in enumerate(zip(*runs)):
        assert np.isfinite(gloss)
        for c_tree, g_tree in zip(cpu, card):
            for (path, a), (_, b) in zip(leaves(c_tree), leaves(g_tree)):
                if a.dtype == np.int32:
                    np.testing.assert_array_equal(b, a, err_msg=path)
                elif act_dtype == "f32":
                    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                               err_msg=path)
                elif i == 0 and np.linalg.norm(a) > 0:
                    dist = np.linalg.norm(b - a) / np.linalg.norm(a)
                    assert dist < 0.1, (path, dist)
        if act_dtype == "f32" or i == 0:
            np.testing.assert_allclose(gloss, closs, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool_card_equals_cpu(dev, dtype):
    """MaxPool 3x3/2 SAME on ReLU-like inputs full of ties: forward and
    backward on the card bitwise as on the CPU."""
    from lbt_tpu_torch.nn.layers import MaxPool
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.maximum(rng.integers(-2, 3, (8, 112, 112, 64)),
                                    0).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(0, 1, (8, 56, 56, 64)).astype(
        np.float32)).to(dtype)
    pool = MaxPool(ksize=(3, 3), strides=(2, 2), padding="SAME")
    res = []
    for d in (torch.device("cpu"), dev):
        tx = x.to(d).detach().clone().requires_grad_()
        y = pool(tx, None)
        y.backward(g.to(d))
        res.append((y.detach().cpu(), tx.grad.cpu()))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])


def test_headline_resnet50_serving_card_matches_cpu(dev):
    """A serving forward of ResNet-50 at 64x64 under the headline config
    on the card and on the CPU: logits within rtol = atol = 1e-5 (bf16
    values: equal in practice), equal labels."""
    from lbt_tpu_torch.infer import Predictor
    from lbt_tpu_torch.models import imagenet_resnet
    x = np.random.default_rng(2).normal(0, 1, (8, 64, 64, 3)).astype(
        np.float32)
    outs = []
    for d in ("cpu", "cuda"):
        model = imagenet_resnet(_headline("bf16"), 50, num_classes=100,
                                image_size=64).init(
                                    torch.Generator().manual_seed(4))
        outs.append(Predictor(model, device=d)(x).cpu())
        outs.append(model.apply(torch.from_numpy(x).to(d),
                                Ctx(train=False)).float().cpu())
    assert torch.equal(outs[0], outs[2])
    np.testing.assert_allclose(outs[3].numpy(), outs[1].numpy(), rtol=1e-5,
                               atol=1e-5)


# VGG-16 / CIFAR-100 under int4w-int8a (batch 256), the small models, the
# Dropout mask, the gradient buffer and the deployment path

# #4 at VGG-16's new shapes: the 9-bit stem at M = 262,144 with Cin 3;
# stage 5 at 2x2 spatial size with K = 4,608, the halo over most of the
# tile; stage 4's first conv (Cin 256 -> 512 at 4x4)
VGG_FUSED_SHAPES = [((256, 32, 32, 3), (3, 3, 3, 64)),
                    ((256, 2, 2, 512), (3, 3, 512, 512)),
                    ((256, 4, 4, 256), (3, 3, 256, 512))]


@pytest.mark.parametrize("mode", [None, "hash"])
@pytest.mark.parametrize("case", range(len(VGG_FUSED_SHAPES)))
def test_conv_fused_at_vgg16_shapes(dev, case, mode):
    """#4 at VGG-16's batch-256 shapes, 9-bit input codes and 4-bit
    weight codes ([-8, 7]): codes, moments and min/max bitwise, one
    launch."""
    xshape, wshape = VGG_FUSED_SHAPES[case]
    g = torch.Generator().manual_seed(case)
    xc = torch.randint(-256, 256, xshape, generator=g,
                       dtype=torch.int16).to(dev)
    wc = torch.randint(-8, 8, wshape, generator=g, dtype=torch.int8).to(dev)
    inv = torch.tensor([2.0 ** -10], device=dev)
    mult = torch.tensor([2.0 ** -3], device=dev)
    kw = dict(strides=(1, 1), pads=((1, 1), (1, 1)),
              noise=_noise(mode, 0x1234 + case))
    before = conv_fused.conv3x3_fused.launches
    got = conv_fused.conv3x3_fused(xc, wc, inv, mult, **kw)
    torch.cuda.synchronize()
    assert conv_fused.conv3x3_fused.launches == before + 1
    for a, b in zip(got, conv_fused.conv_fused_plain(xc, wc, inv, mult,
                                                     **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mkn", [(256, 512, 100), (256, 512, 512),
                                 (2, 512, 100), (128, 512, 10)])
def test_k2_at_the_vgg16_heads(dev, mkn):
    """K2's AB form at VGG-16's dense shapes (the 100-way head) and the
    small models' heads, with 4-bit codes: bitwise."""
    m, k, n = mkn
    g = torch.Generator().manual_seed(m + n)
    a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int8)
    inv = torch.tensor([2.0 ** -9])
    got = gemm.int8_matmul(a.to(dev), b.to(dev), inv.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gemm.int8_matmul_plain(a, b, inv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_card_equals_cpu(dev, dtype):
    """The Dropout mask and output on the card bitwise as on the CPU (the
    threefry uniforms in torch ops on either device)."""
    from lbt_tpu_torch.nn.layers import Dropout
    x = torch.randn(256, 512, generator=torch.Generator().manual_seed(5))
    x = x.to(dtype)
    layer = Dropout(keep=0.5)
    layer.uid = 40
    outs = [layer(x.to(d), Ctx(train=True, key=base_key(9))).cpu()
            for d in ("cpu", dev)]
    assert outs[1].dtype == dtype and torch.equal(outs[0], outs[1])


def _int4w():
    import dataclasses
    return dataclasses.replace(
        QuantConfig.uniform(8, engine="int8", noise_mode="hash"), bits_w=4)


@pytest.mark.parametrize("name,cfg,kw", [
    ("VGG16_CIFAR100", _int4w(), {}),
    ("MNIST", QuantConfig.uniform(8), {}),
    ("CIFAR10_Resnet20", QuantConfig.uniform(8, noise_mode="hash"),
     {"gradient_buffer_batch": 4})], ids=["vgg16", "mnist", "resnet20-gb"])
def test_zoo_train_steps_card_match_cpu(dev, name, cfg, kw):
    """Two train steps at batch 4 on the card and on the CPU: VGG-16 under
    int4w-int8a, LeNet under main.py's defaults (prng, dropout), ResNet-20
    with the gradient buffers: exponents equal after every step, losses
    and every float (the buffers included) at rtol = atol = 1e-5.  VGG-16
    is held so after its first step and by its exponents after the
    second: its last stage normalizes 16 values a channel at batch 4,
    where an f32 ulp of another summation order that flips one
    stochastic code moves the normalized values by O(1) (as ResNet-50's
    stage 4 at 32x32, ROADMAP queue 3 finding 1); its kernel route
    equals its plain route on the card bitwise (``chip_smoke.py``, phase
    vgg16)."""
    from lbt_tpu_torch.models import build_model
    runs = []
    for d in (torch.device("cpu"), dev):
        model = build_model(name, cfg, weight_decay=2e-4, **kw).init(
            torch.Generator().manual_seed(0)).to(d)
        shape = (4, *model.input_shape)
        rng = np.random.default_rng(6)
        vel = momentum_init(dict(model.net.named_parameters()))
        step = make_train_step(model, TrainConfig())
        losses, states = [], []
        for i in range(2):
            x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
            y = torch.from_numpy(rng.integers(0, model.num_classes, (4,)))
            losses.append(step(model, vel, x.to(d), y.to(d), i, 1e-2,
                               base_key(3))["loss"].item())
            states.append(convert.to_jax_numpy(model, vel))
        runs.append((losses, states))
    (closs, cpu), (gloss, card) = runs
    n_float = 1 if name == "VGG16_CIFAR100" else 2
    np.testing.assert_allclose(gloss[:n_float], closs[:n_float], rtol=1e-5)

    def cmp(a, b, floats):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                cmp(a[k], b[k], floats)
        elif a.dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        elif floats:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    for i in range(2):
        for a, b in zip(card[i], cpu[i]):
            cmp(a, b, i < n_float)


def test_folded_export_serves_on_the_card_as_on_the_cpu(dev):
    """VGG-16 under int4w-int8a with random BN statistics: the fold, the
    export (nibble-packed weights) and the restored export's logits on
    the card equal the CPU's (the fold's and export's numbers bitwise)."""
    from lbt_tpu_torch import infer
    from lbt_tpu_torch.models import build_model
    from lbt_tpu_torch.nn.norm import Normalization, Rescale
    x = np.random.default_rng(7).normal(0, 1, (8, 32, 32, 3)).astype(
        np.float32)
    outs = []
    for d in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(8)
        model = build_model("VGG16_CIFAR100", _int4w()).init(gen)
        with torch.no_grad():
            for la in model.net.modules():
                if isinstance(la, Normalization):
                    la.mean.normal_(0.0, 0.5, generator=gen)
                    la.var.uniform_(0.5, 2.0, generator=gen)
                elif isinstance(la, Rescale):
                    la.gamma.uniform_(0.5, 1.5, generator=gen)
        folded = infer.fold_batchnorm(model.to(d))
        exported = infer.export_quantized_weights(folded)
        served = infer.Predictor(infer.fold_batchnorm(model),
                                 infer.restore_quantized_weights(exported),
                                 convert.to_jax_numpy(folded)[1], device=d)
        with torch.no_grad():
            logits = served.model.apply(torch.from_numpy(x).to(d),
                                        Ctx(train=False)).cpu()
        outs.append((convert.to_jax_numpy(folded)[:2], exported, logits))
    (ctrees, cexp, clog), (gtrees, gexp, glog) = outs

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    for c, g in zip(ctrees, gtrees):
        for (path, a), (_, b) in zip(flat(c), flat(g)):
            np.testing.assert_array_equal(b, a, err_msg=path)
    for (path, a), (_, b) in zip(flat(cexp), flat(gexp)):
        if isinstance(a, infer.QuantizedLeaf):
            assert a.packed == (a.bits == 4) and b.packed == a.packed
            assert torch.equal(a.exp, b.exp), path
            a, b = a.codes, b.codes
        assert torch.equal(a, b.cpu()), path
    assert torch.equal(clog, glog)


# the input sources (native/*.cc, PIL) on the card's host

def _has_libjpeg() -> bool:
    """g++ finds libjpeg's header and links it: the TFRecord library
    builds."""
    import shutil
    import subprocess
    gxx = shutil.which("g++")
    return gxx is not None and subprocess.run(
        [gxx, "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
        capture_output=True, text=True).returncode == 0


def _source_batches(name, root):
    """Two epochs' worth of batches of 4 at 32 px from one source."""
    import io
    from lbt_tpu_torch.data import imagefolder, tfrecord
    from lbt_tpu_torch.data.native import NativeLoader
    rng = np.random.default_rng(5)
    if name == "native":
        x = rng.normal(0, 1, (12, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, 12).astype(np.int32)
        return list(NativeLoader(x, y, 4, pad=4, flip=True).epoch(0))
    Image = pytest.importorskip("PIL.Image")
    images = [rng.integers(0, 256, (40, 48, 3), np.uint8) for _ in range(10)]
    if name == "tfrecord":
        if not _has_libjpeg():
            pytest.skip("libjpeg's header or library is missing: the "
                        "TFRecord library (native/tfrecord.cc) cannot build")
        path = str(root / "shard.tfrecord")
        with tfrecord.TFRecordWriter(path) as wr:
            for i, im in enumerate(images):
                buf = io.BytesIO()
                Image.fromarray(im).save(buf, format="JPEG")
                wr.write(tfrecord.make_example(buf.getvalue(), i % 3))
        return list(tfrecord.TFRecordDataset(path, 32, train=False)
                    .batches(0, 4))
    for i, im in enumerate(images):
        d = root / f"c{i % 3}"
        d.mkdir(exist_ok=True)
        Image.fromarray(im).save(d / f"{i}.jpeg")
    return list(imagefolder.ImageFolderDataset(str(root), 32, train=False,
                                               workers=2).batches(0, 4))


@pytest.mark.parametrize("name", ["native", "tfrecord", "imagefolder"])
def test_sources_feed_device_prefetch_on_the_card(dev, tmp_path, name):
    """Each source's numpy batches reach the card through
    ``device_prefetch`` unchanged, the ragged last eval batch included."""
    want = _source_batches(name, tmp_path)
    got = list(device_prefetch(iter(want), device=dev))
    assert len(got) == len(want) and len(want[-1][1]) <= 4
    for (xg, yg), (xw, yw) in zip(got, want):
        assert xg.device.type == "cuda" and yg.device.type == "cuda"
        assert torch.equal(xg.cpu(), torch.from_numpy(xw))
        assert torch.equal(yg.cpu(), torch.from_numpy(yw))


def test_device_prefetch_reuses_pinned_blocks(dev):
    """Batches of the headline's size (128 x 224 x 224 x 3 f32, 77 MB)
    through ``device_prefetch``: the pinned host allocator grows by a few
    blocks at first, then hands the same ones out again."""
    x = np.zeros((128, 224, 224, 3), np.float32)
    y = np.zeros((128,), np.int32)
    before = torch.cuda.host_memory_stats().get("num_host_alloc")
    if before is None:
        pytest.skip("this torch reports no pinned-allocator statistics")
    for xb, _ in device_prefetch(((x, y) for _ in range(12)), device=dev):
        xb.add_(1)
    torch.cuda.synchronize()
    grown = torch.cuda.host_memory_stats()["num_host_alloc"] - before
    assert grown <= 8, f"{grown} pinned blocks created for 12 batches"


def test_loss_outside_the_head_gives_nan_without_device_assert(dev):
    """Labels at, past and below the head's width: the loss is NaN, the
    gradient finite and equal to the CPU's, no device assert fires (the
    context stays usable)."""
    from lbt_tpu_torch.nn.model import Model
    model = cifar10_resnet(QuantConfig.uniform(8, noise_mode="hash"), 8)
    assert isinstance(model, Model)
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        0, 2, (6, 10)).astype(np.float32))
    labels = torch.tensor([0, 9, 10, 400, -1, -11])
    out = []
    for d in ("cpu", dev):
        t = logits.to(d, copy=True).requires_grad_()
        loss, acc = model.loss_and_acc(t, labels.to(d))
        loss.backward()
        torch.cuda.synchronize()
        out.append((loss.item(), acc.item(), t.grad.cpu()))
    (lc, ac, gc), (lg, ag, gg) = out
    assert np.isnan(lc) and np.isnan(lg) and ac == ag
    assert torch.isfinite(gg).all()
    torch.testing.assert_close(gg, gc, rtol=1e-6, atol=1e-7)
    assert (torch.ones(4, device=dev) * 2).sum().item() == 8.0


# ---------------------------------------------------------------------------
# data parallelism: the noise counter's offset, the low-bit all-reduce and
# NCCL at world size 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode", ["hash", "hash1", "threefry"])
@pytest.mark.parametrize("shape", [(4097,), (6, 5, 7), (8, 32, 32, 16)])
def test_k1_counter_offset_matches_plain(dev, shape, mode, shared):
    """K1 at a non-zero counter offset (a data-parallel eval rank's rows
    of a global batch; any offset, added before the shared draw's
    modulo) equals its plain version bitwise, and rows ``3..`` drawn at
    offset ``3 * prod(shape[1:])`` equal those rows of the whole draw."""
    inner = math.prod(shape[1:]) if shared else 0
    x = (torch.randn(shape, generator=torch.Generator().manual_seed(1))
         * 2).to(dev)
    for offset in (1, 3 * math.prod(shape[1:]) + 5, 2 ** 31 + 7):
        noise = _noise(mode, 0x51ED + offset, inner)._replace(offset=offset)
        got = quant.quantize_codes(x, 8, 1, noise, stats=True)
        _same(got, quant.quantize_codes_plain(x, 8, 1, noise, stats=True))
    if len(shape) > 1:
        whole = quant.quantize_codes(x, 8, 1, _noise(mode, 9, inner))[0]
        part = x[3:].contiguous()
        noise = _noise(mode, 9, inner)._replace(
            offset=0 if shared else 3 * math.prod(shape[1:]))
        assert torch.equal(quant.quantize_codes(part, 8, 1, noise)[0],
                           whole[3:])


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode", ["hash", "hash1", "threefry"])
@pytest.mark.parametrize("case", range(len(FUSED_SHAPES)))
def test_conv_fused_counter_offset_matches_plain(dev, case, mode, shared):
    """#4 / #5 at a non-zero counter offset (a whole number of draws when
    shared) equal their plain version bitwise."""
    xshape, wshape, s = FUSED_SHAPES[case]
    g = torch.Generator().manual_seed(case)
    xc = torch.randint(-128, 128, xshape, generator=g,
                       dtype=torch.int8).to(dev)
    wc = torch.randint(-128, 128, wshape, generator=g,
                       dtype=torch.int8).to(dev)
    inv = torch.tensor([2.0 ** -16], device=dev)
    mult = torch.tensor([2.0 ** -3], device=dev)
    pads = qops.conv_pads("SAME", xshape[1:3], wshape[:2], (s, s))
    ho, wo = qops.out_hw(xshape[1], xshape[2], wshape[:2], (s, s), pads)
    inner = ho * wo * wshape[3]
    noise = _noise(mode, 0xC0FFEE + case, inner if shared else 0)._replace(
        offset=3 * inner + (0 if shared else 5))
    fused = (conv_fused.conv3x3_fused if wshape[0] == 3
             else conv_fused.conv1x1_fused)
    kw = dict(strides=(s, s), pads=pads, noise=noise)
    got = fused(xc, wc, inv, mult, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, conv_fused.conv_fused_plain(xc, wc, inv, mult,
                                                       **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _lowbit_inputs(dev):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (33,), "c": (3, 3, 16, 16)}
    grads = {k: torch.from_numpy((rng.normal(0, 1, s) * 10.0 ** -i)
                                 .astype(np.float32)).to(dev)
             for i, (k, s) in enumerate(shapes.items())}
    bufs = {k: torch.from_numpy((rng.normal(0, 1e-3, v.shape))
                                .astype(np.float32)).to(dev)
            for k, v in grads.items()}
    return grads, bufs


def _reduce_all(group, grads, bufs):
    """Every transport of the low-bit all-reduce, then one collective of
    each dtype the DP step sends (f32 and int64 sums, f32 max)."""
    from lbt_tpu_torch.parallel import lowbit_allreduce, ring_lowbit_allreduce
    out = {"psum": lowbit_allreduce(grads, bufs, group)}
    for wire in ("int16", "int8"):
        out[wire] = ring_lowbit_allreduce(grads, bufs, group, wire=wire)
    dev = next(iter(grads.values())).device
    out["sums"] = (group.all_reduce(torch.arange(5., device=dev)),
                   group.all_reduce(torch.arange(5, device=dev)),
                   group.all_reduce(torch.arange(5., device=dev), "max"))
    return out


def _flat(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    return [out]


@pytest.fixture
def world_of_one(dev, tmp_path):
    import torch.distributed as dist

    def init(backend):
        kw = ({"device_id": torch.device("cuda", torch.cuda.current_device())}
              if backend == "nccl" else {})
        dist.init_process_group(backend, init_method=f"file://{tmp_path}/s",
                                world_size=1, rank=0, **kw)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def test_lowbit_allreduce_over_gloo_with_cuda_tensors(dev, world_of_one):
    """Over gloo at world size 1, CUDA tensors (staged through host
    memory): every transport returns the quantized leaves on the card,
    bitwise the same as on the CPU."""
    from lbt_tpu_torch.parallel import Group
    world_of_one("gloo")
    group = Group(device=dev)
    grads, bufs = _lowbit_inputs(dev)
    card = _reduce_all(group, grads, bufs)
    cpu = _reduce_all(group, *({k: v.cpu() for k, v in t.items()}
                               for t in (grads, bufs)))
    for a, b in zip(_flat(card), _flat(cpu)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


def test_nccl_world_of_one_refuses_nothing(dev, world_of_one):
    """An NCCL group of world size 1 takes every collective the DP step
    and the low-bit all-reduce make, dtypes included, and gives what a
    gloo group of world size 1 gives, bitwise."""
    import torch.distributed as dist
    from lbt_tpu_torch.parallel import Group
    world_of_one("nccl")
    grads, bufs = _lowbit_inputs(dev)
    nccl = _reduce_all(Group(device=dev), grads, bufs)
    gloo = _reduce_all(Group(dist.new_group(backend="gloo"), device=dev),
                       grads, bufs)
    torch.cuda.synchronize()
    for a, b in zip(_flat(nccl), _flat(gloo)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("row0", [0, 3])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode", ["hash", "hash1", "threefry"])
@pytest.mark.parametrize("shape,n_global,col0", [
    ((3, 3, 256, 128), 256, 128), ((2048, 500), 1000, 500),
    ((1, 1, 512, 33), 130, 97), ((7, 5, 13), 40, 21), ((4097, 1), 3, 2)])
def test_k1_column_window_matches_plain(dev, shape, n_global, col0, mode,
                                        shared, row0):
    """K1 on a tensor-parallel column slice (the window's division an
    element, with the shared draw and a row offset) equals its plain
    version, codes, multiplier and min/max."""
    g = torch.Generator().manual_seed(n_global + col0)
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    full = (*shape[:-1], n_global)
    inner = math.prod(full[1:]) if shared else 0
    noise = _noise(mode, 17, inner)._replace(
        offset=row0 * math.prod(full[1:]), n_global=n_global, col0=col0)
    _same(quant.quantize_codes(x, 8, 1, noise, True),
          quant.quantize_codes_plain(x, 8, 1, noise, True))


@pytest.mark.parametrize("row0", [0, 3])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode", ["hash", "hash1", "threefry"])
@pytest.mark.parametrize("k,cin,cout,n_global,col0,stride", [
    (3, 64, 32, 64, 32, 1), (1, 256, 64, 128, 64, 2),
    (3, 32, 17, 40, 23, 1), (1, 48, 33, 130, 97, 1)])
def test_conv_fused_column_window_matches_plain(dev, k, cin, cout, n_global,
                                                col0, stride, mode, shared,
                                                row0):
    """#4 / #5 on a tensor-parallel slice of the output channels, the
    epilogue's counter at the whole BN input's index (shared draw and row
    offset too), equal their plain version: codes, moments, min/max."""
    from lbt_tpu_torch.ops.im2col import conv_pads, out_hw
    g = torch.Generator().manual_seed(cin + col0)
    xc = torch.randint(-128, 128, (4, 14, 14, cin), generator=g,
                       dtype=torch.int8)
    wc = torch.randint(-128, 128, (k, k, cin, cout), generator=g,
                       dtype=torch.int8)
    pads = conv_pads("SAME", (14, 14), (k, k), (stride, stride))
    ho, wo = out_hw(14, 14, (k, k), (stride, stride), pads)
    inner = ho * wo * n_global if shared else 0
    noise = _noise(mode, 23, inner)._replace(
        offset=row0 * ho * wo * n_global, n_global=n_global, col0=col0)
    inv, mult = torch.tensor([2.0 ** -14]), torch.tensor([2.0 ** -2])
    fn = conv_fused.conv3x3_fused if k == 3 else conv_fused.conv1x1_fused
    kw = dict(strides=(stride, stride), pads=pads, noise=noise)
    got = fn(xc.to(dev), wc.to(dev), inv.to(dev), mult.to(dev), **kw)
    want = conv_fused.conv_fused_plain(xc, wc, inv, mult, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


class _SliceGroup:
    """Model rank ``rank`` of a group of ``world`` run alone: the join
    puts this rank's columns among zeros, and the partial-dx sum hands
    back this rank's partial, which the test adds up itself."""

    def __init__(self, rank, world=2):
        self.rank, self.world = rank, world

    def all_gather(self, t, dim=-1, kind=""):
        return torch.cat([t if r == self.rank else torch.zeros_like(t)
                          for r in range(self.world)], dim)

    def all_reduce(self, t, op="sum", kind=""):
        return t.clone()


def _float_route_slices(device, layer, engine):
    """A Dense (96 -> 70) or a 3x3 conv (16 -> 24 channels) on the float
    route, its ``W`` cut into 2 column slices that run one after the
    other: each slice's output columns and ``dW``, and the sum of the
    two partial ``dx``.  Operands draw threefry noise (the sharded
    weight through its column window); the cotangent is on an 8-bit
    grid, so every contraction sums exactly in f32."""
    from lbt_tpu_torch.parallel.mesh import Shard, column_slice
    g = torch.Generator().manual_seed(7)
    if layer == "dense":
        x = torch.randn(16, 96, generator=g)
        w = torch.randn(96, 70, generator=g) * 0.1
        op, kw = qops.qmatmul, {}
    else:
        x = torch.randn(2, 8, 8, 16, generator=g)
        w = torch.randn(3, 3, 16, 24, generator=g) * 0.1
        op, kw = qops.qconv2d, dict(strides=(1, 1), padding="SAME")
    n = w.shape[-1]
    y_shape = (*x.shape[:-1], n)
    cot = torch.randint(-127, 128, y_shape, generator=g).float() * 2 ** -9
    outs, dws, dx = [], [], 0
    for m in range(2):
        col0, width = column_slice(n, 2, m)
        xs = x.clone().to(device).requires_grad_(True)
        ws = w[..., col0:col0 + width].contiguous().to(device) \
            .requires_grad_(True)
        y = op(xs, ws, 1, 0, bits_x=8, bits_w=8, engine=engine,
               key_x=(1, 2), key_w=(3, 4), stochastic=True,
               shard=Shard(_SliceGroup(m), col0, width, n), **kw)
        (y * cot.to(device)).sum().backward()
        outs.append(y[..., col0:col0 + width].detach().cpu())
        dws.append(ws.grad.cpu())
        dx = dx + xs.grad.cpu()
    return outs, dws, dx


@pytest.mark.parametrize("engine", ["sim", "sim_bf16"])
@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_float_route_column_slices_card_equal_cpu(dev, layer, engine):
    """A sharded Dense and 3x3 Conv2d on the float route, 2 column
    slices run in turn on the card: each slice's output and ``dW``, and
    the two partial ``dx`` summed, equal the same run on the CPU at rtol
    1e-5 (TF32 off)."""
    got = _float_route_slices(dev, layer, engine)
    want = _float_route_slices(torch.device("cpu"), layer, engine)
    for a, b in zip(got[0] + got[1] + [got[2]], want[0] + want[1] + [want[2]]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((128, 28, 28, 512), (1, 1, 512, 128), 1),
    ((128, 56, 56, 64), (3, 3, 64, 64), 1),
    ((128, 56, 56, 128), (3, 3, 128, 128), 2),
    ((128, 2048), (2048, 1000), None)])
def test_bf16_contraction_is_exact_on_the_card(dev, x_shape, w_shape,
                                              stride):
    """``sim_bf16``'s contraction (``qops._BF16Contract``) on the card at
    shapes of configuration A (ResNet-50/224 at batch 128: a 28x28 1x1
    conv, where cuDNN's own bf16 wgrad rounds partial sums, 3x3 convs at
    stride 1 and 2, the head): the output, ``dx`` and ``dW`` equal the
    float64 contraction of the same bf16 values rounded once to bf16,
    bitwise (8-bit codes: every float64 sum is exact)."""
    from lbt_tpu_torch.ops.im2col import conv_pads
    g = torch.Generator(device=dev).manual_seed(11)

    def codes(shape, scale):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).float() * scale
    x, w = codes(x_shape, 2 ** -7), codes(w_shape, 2 ** -9)
    geom = None if stride is None else ((stride, stride), conv_pads(
        "SAME", x_shape[1:3], w_shape[:2], (stride, stride)))
    outs = []
    for exact in (True, False):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        if exact:
            y = qops._BF16Contract.apply(xs, ws, geom, False)
        else:
            a, b = (t.to(torch.bfloat16).double() for t in (xs, ws))
            y = (a @ b if geom is None else
                 qops._float_conv(a, b, *geom)).to(torch.bfloat16)
        if not outs:
            cot = codes(tuple(y.shape), 2 ** -10)
        y.float().backward(cot)
        outs.append((y.detach(), xs.grad, ws.grad))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


# mode 4: an unsafe_rbg key's Philox stream (K1 and #4/#5)

# key data: a seed's, edge words, and a low counter half that carries
# past 2**64 within the first blocks
RBG_KEYS = [(0, 7, 0, 7), (0xDEADBEEF, 0x12345678, 0x9ABCDEF0, 0x0FEDCBA9),
            (0x80000001, 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF)]


def _rbg(key, inner=0, offset=0):
    return quant.Noise(quant.RBG, key[0], key[1], inner, offset,
                       k2=key[2], k3=key[3])


@pytest.mark.parametrize("offset", [0, 4, 1, 4098])
@pytest.mark.parametrize("bits", [4, 8, 9, 16, 20])
@pytest.mark.parametrize("shape", [(1,), (3,), (4097,), (3, 5, 7),
                                   (2, 32, 32, 16), (128, 16, 16, 32)])
def test_k1_rbg_matches_plain(dev, shape, bits, offset):
    """K1 in mode 4 equals its plain version bitwise, with and without
    min/max: odd sizes (the scalar tail), offsets that are multiples of 4
    (one Philox block a float4) and ragged ones (a block an element),
    each key (the last one's counter carries)."""
    g = torch.Generator().manual_seed(bits + offset)
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    for key in RBG_KEYS:
        for stats in (False, True):
            noise = _rbg(key, offset=offset)
            before = quant.quantize_codes.launches_by_mode[quant.RBG]
            got = quant.quantize_codes(x, bits, 1, noise, stats)
            torch.cuda.synchronize()
            assert (quant.quantize_codes.launches_by_mode[quant.RBG]
                    == before + 1)
            _same(got, quant.quantize_codes_plain(x, bits, 1, noise, stats))


@pytest.mark.parametrize("bits", [8, 9])
@pytest.mark.parametrize("shape", [(5,), (4097,), (3, 5, 7), (8, 6, 6, 16)])
def test_k1_rbg_shared_and_misaligned(dev, shape, bits):
    """Mode 4 drawn once along axis 0 (``inner``), and on a view whose
    data does not start 16-byte aligned (the scalar loop)."""
    g = torch.Generator().manual_seed(len(shape))
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    for key in RBG_KEYS:
        noise = _rbg(key, inner=math.prod(shape[1:]))
        _same(quant.quantize_codes(x, bits, 1, noise, True),
              quant.quantize_codes_plain(x, bits, 1, noise, True))
        view = x.view(-1)[1:]
        _same(quant.quantize_codes(view, bits, 1, _rbg(key), True),
              quant.quantize_codes_plain(view, bits, 1, _rbg(key), True))


@pytest.mark.parametrize("row0", [0, 3])
@pytest.mark.parametrize("shape,n_global,col0", [
    ((3, 3, 256, 128), 256, 128), ((2048, 500), 1000, 500),
    ((1, 1, 512, 33), 130, 97), ((7, 5, 13), 40, 21)])
def test_k1_rbg_column_window_matches_plain(dev, shape, n_global, col0,
                                            row0):
    """Mode 4 on a tensor-parallel column slice, with a row offset."""
    g = torch.Generator().manual_seed(n_global + col0)
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    full = (*shape[:-1], n_global)
    noise = _rbg(RBG_KEYS[1], offset=row0 * math.prod(full[1:]))._replace(
        n_global=n_global, col0=col0)
    _same(quant.quantize_codes(x, 8, 1, noise, True),
          quant.quantize_codes_plain(x, 8, 1, noise, True))


def test_k1_rbg_graph_replays(dev):
    """100 replays of a captured mode-4 K1 with min/max, each on fresh
    data, give the plain version's codes and min/max."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(128, 16, 16, 32, generator=g).to(dev)
    exp = torch.tensor(2, dtype=torch.int32, device=dev)
    noise = _rbg(RBG_KEYS[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant.quantize_codes(x, 8, exp, noise, stats=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = quant.quantize_codes(x, 8, exp, noise, stats=True)
    for i in range(100):
        x.copy_(torch.randn(x.shape, generator=g) * (1 + i % 7))
        graph.replay()
        torch.cuda.synchronize()
        _same(out, quant.quantize_codes_plain(x, 8, exp, noise, stats=True))


@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("xdtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("form", ["", "shared", "offset 4", "offset 6"])
@pytest.mark.parametrize("case", range(len(FUSED_SHAPES)))
def test_conv_fused_rbg_matches_plain(dev, case, form, xdtype, round_bf16):
    """#4 / #5 in mode 4 equal their plain version bitwise: codes,
    moments, min/max, one launch; per element (a lane's block serves four
    elements), drawn once along axis 0, and at offsets of a row that are
    and are not multiples of 4 (Cout = 70 rows are not: a block an
    element)."""
    xshape, wshape, s = FUSED_SHAPES[case]
    g = torch.Generator().manual_seed(case)
    lim = 256 if xdtype == torch.int16 else 128
    xc = torch.randint(-lim, lim, xshape, generator=g, dtype=xdtype).to(dev)
    wc = torch.randint(-128, 128, wshape, generator=g,
                       dtype=torch.int8).to(dev)
    inv = torch.tensor([2.0 ** -16], device=dev)
    mult = torch.tensor([2.0 ** -3], device=dev)
    pads = qops.conv_pads("SAME", xshape[1:3], wshape[:2], (s, s))
    ho, wo = qops.out_hw(xshape[1], xshape[2], wshape[:2], (s, s), pads)
    row = ho * wo * wshape[3]
    noise = _rbg(RBG_KEYS[case % len(RBG_KEYS)],
                 inner=row if form == "shared" else 0,
                 offset=int(form.split()[1]) * row if " " in form else 0)
    kw = dict(strides=(s, s), pads=pads, noise=noise, round_bf16=round_bf16)
    fused = (conv_fused.conv3x3_fused if wshape[0] == 3
             else conv_fused.conv1x1_fused)
    before = fused.launches_by_mode[quant.RBG]
    got = fused(xc, wc, inv, mult, **kw)
    torch.cuda.synchronize()
    assert fused.launches_by_mode[quant.RBG] == before + 1
    want = conv_fused.conv_fused_plain(xc, wc, inv, mult, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("row0", [0, 3])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("k,cin,cout,n_global,col0,stride", [
    (3, 64, 32, 64, 32, 1), (1, 256, 64, 128, 64, 2),
    (3, 32, 17, 40, 23, 1), (1, 48, 33, 130, 97, 1)])
def test_conv_fused_rbg_column_window_matches_plain(dev, k, cin, cout,
                                                    n_global, col0, stride,
                                                    shared, row0):
    """#4 / #5 in mode 4 on a slice of the output channels: a window whose
    row width and first column are multiples of 4 (a lane's block serves
    four) and one whose are not (a block an element)."""
    from lbt_tpu_torch.ops.im2col import conv_pads, out_hw
    g = torch.Generator().manual_seed(cin + col0)
    xc = torch.randint(-128, 128, (4, 14, 14, cin), generator=g,
                       dtype=torch.int8)
    wc = torch.randint(-128, 128, (k, k, cin, cout), generator=g,
                       dtype=torch.int8)
    pads = conv_pads("SAME", (14, 14), (k, k), (stride, stride))
    ho, wo = out_hw(14, 14, (k, k), (stride, stride), pads)
    noise = _rbg(RBG_KEYS[2], inner=ho * wo * n_global if shared else 0,
                 offset=row0 * ho * wo * n_global)._replace(
                     n_global=n_global, col0=col0)
    inv, mult = torch.tensor([2.0 ** -14]), torch.tensor([2.0 ** -2])
    fn = conv_fused.conv3x3_fused if k == 3 else conv_fused.conv1x1_fused
    kw = dict(strides=(stride, stride), pads=pads, noise=noise)
    got = fn(xc.to(dev), wc.to(dev), inv.to(dev), mult.to(dev), **kw)
    want = conv_fused.conv_fused_plain(xc, wc, inv, mult, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)

