"""The port's hand-written kernels held against their plain PyTorch
versions on an NVIDIA GPU, bitwise.  Every test here needs the card and
skips without one.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lbt_tpu_torch import convert
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.dfxp.keys import base_key
from lbt_tpu_torch.dfxp.quantize import multiplier
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels import conv_fused, gemm, quant
from lbt_tpu_torch.train.optim import momentum_init
from lbt_tpu_torch.train.step import make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bits", [4, 8, 9, 16])
@pytest.mark.parametrize("mode", [None, "hash", "hash1"])
@pytest.mark.parametrize("shape", [(1,), (4097,), (3, 5, 7),
                                   (2, 32, 32, 16)])
def test_k1_matches_plain(dev, bits, mode, shape):
    g = torch.Generator().manual_seed(bits)
    mult = multiplier(bits, 2)
    x = torch.randn(shape, generator=g) * 2
    # ties at +-0.5 and 2.5 after scaling, and a value past the rail
    x.view(-1)[:4] = (torch.tensor([0.5, -0.5, 2.5, 1e9]) / mult)[:x.numel()]
    x, mult = x.to(dev), mult.to(dev)
    seed = None if mode is None else 0x9E3779B9 + bits
    before = quant.quantize_codes.launches
    got = quant.quantize_codes(x, bits, mult, seed, light=mode == "hash1")
    torch.cuda.synchronize()
    assert quant.quantize_codes.launches == before + 1
    want = quant.quantize_codes_plain(x, bits, mult, seed,
                                      light=mode == "hash1")
    assert got.dtype == want.dtype == quant.code_dtype(bits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mkn", [(1, 1, 1), (130, 100, 70), (64, 27, 16),
                                 (128, 64, 10), (513, 33, 17),
                                 (1000, 576, 64), (77, 16, 32)])
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
@pytest.mark.parametrize("mode", [None, "hash"])
@pytest.mark.parametrize("shape", [(1,), (4097,), (3, 5, 7),
                                   (2, 32, 32, 16), (64, 10)])
def test_k1_stats_matches_plain(dev, bits, mode, shape):
    g = torch.Generator().manual_seed(bits + len(shape))
    x = (torch.randn(shape, generator=g) * 3).to(dev)
    mult = multiplier(bits, 1).to(dev)
    seed = None if mode is None else 0x1234567 + bits
    codes, mm = quant.quantize_codes(x, bits, mult, seed, stats=True)
    want, want_mm = quant.quantize_codes_plain(x, bits, mult, seed,
                                               stats=True)
    torch.cuda.synchronize()
    assert torch.equal(codes, want)
    assert torch.equal(mm, want_mm)


@pytest.mark.parametrize("kmn", [(1, 1, 1), (128, 64, 10), (300, 27, 16),
                                 (2048, 144, 32), (131072, 144, 16),
                                 (70001, 576, 64)])
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


# ResNet-20's conv -> BN shapes: (x shape, HWIO, stride)
FUSED_SHAPES = [((8, 32, 32, 3), (3, 3, 3, 16), 1),
                ((8, 32, 32, 16), (3, 3, 16, 16), 1),
                ((8, 32, 32, 16), (3, 3, 16, 32), 2),
                ((8, 16, 16, 32), (3, 3, 32, 32), 1),
                ((8, 16, 16, 32), (3, 3, 32, 64), 2),
                ((8, 8, 8, 64), (3, 3, 64, 64), 1),
                ((8, 32, 32, 16), (1, 1, 16, 32), 2),
                ((8, 16, 16, 32), (1, 1, 32, 64), 2),
                ((3, 7, 5, 20), (3, 3, 20, 70), 1),
                ((3, 7, 5, 20), (1, 1, 20, 70), 1)]


@pytest.mark.parametrize("xdtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("mode", [None, "hash", "hash1"])
@pytest.mark.parametrize("case", range(len(FUSED_SHAPES)))
def test_conv_fused_matches_plain(dev, case, mode, xdtype):
    xshape, wshape, s = FUSED_SHAPES[case]
    g = torch.Generator().manual_seed(case)
    lim = 256 if xdtype == torch.int16 else 128
    xc = torch.randint(-lim, lim, xshape, generator=g, dtype=xdtype).to(dev)
    wc = torch.randint(-128, 128, wshape, generator=g,
                       dtype=torch.int8).to(dev)
    inv = torch.tensor([2.0 ** -16], device=dev)
    mult = torch.tensor([2.0 ** -3], device=dev)
    pads = qops.conv_pads("SAME", xshape[1:3], wshape[:2], (s, s))
    kw = dict(strides=(s, s), pads=pads, seed=None if mode is None
              else 0xC0FFEE + case, light=mode == "hash1")
    fused = (conv_fused.conv3x3_fused if wshape[0] == 3
             else conv_fused.conv1x1_fused)
    before = fused.launches
    got = fused(xc, wc, inv, mult, **kw)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    want = conv_fused.conv_fused_plain(xc, wc, inv, mult, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _trained(dev, steps=2):
    cfg = QuantConfig.uniform(8, noise_mode="hash")
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
        losses.append(step(model, vel, x, y, i, 1e-2, base_key(3))["loss"])
    return convert.to_jax_numpy(model, vel), losses


def test_train_step_card_matches_cpu(dev):
    """Two steps of ResNet-8 on the card and on the CPU: exponents equal,
    floats to 1e-5 (the card's reductions run in another order)."""
    (cp, cq, cv), closs = _trained(torch.device("cpu"))
    (gp, gq, gv), gloss = _trained(dev)
    np.testing.assert_allclose([x.item() for x in gloss],
                               [x.item() for x in closs], rtol=1e-5)

    def cmp(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                cmp(a[k], b[k])
        elif a.dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    for a, b in ((gp, cp), (gq, cq), (gv, cv)):
        cmp(a, b)
