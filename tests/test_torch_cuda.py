"""The port's hand-written kernels held against their plain PyTorch
versions on an NVIDIA GPU, bitwise.  Every test here needs the card and
skips without one.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lbt_tpu_torch.config import QuantConfig
from lbt_tpu_torch.dfxp.quantize import multiplier
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.nn.core import Ctx
from lbt_tpu_torch.ops import qops
from lbt_tpu_torch.ops.kernels import gemm, quant

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
