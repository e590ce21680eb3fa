"""The port's data path held against lbt_tpu on the CPU: the datasets bit
for bit, the batch order, the augmentation's geometry and statistics
(its draws are the port's own, from the threefry key chain), and the
threaded device prefetch."""

import threading
import time

import numpy as np
import pytest
import torch

from lbt_tpu.data import datasets as jdatasets
from lbt_tpu.data import pipeline as jpipeline
from lbt_tpu_torch.data import datasets
from lbt_tpu_torch.data.pipeline import batch_iterator, device_prefetch
from lbt_tpu_torch.dfxp import keys


def test_load_dataset_matches_lbt_tpu_bitwise():
    want = jdatasets.load_dataset("cifar10", n_train=256, n_test=100)
    got = datasets.load_dataset("cifar10", n_train=256, n_test=100)
    assert got["synthetic"] == want["synthetic"]
    assert got["num_classes"] == want["num_classes"]
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got["train"][0].shape == (256, 32, 32, 3)
    assert datasets.aug_spec("cifar10") == jdatasets.aug_spec("cifar10")
    assert datasets.AUG_SPECS == jdatasets.AUG_SPECS


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (3, 7), (11, 2)])
def test_batch_iterator_order_matches_lbt_tpu(seed, epoch):
    x = np.arange(50, dtype=np.float32).reshape(50, 1)
    y = np.arange(50, dtype=np.int32)
    for kw in ({"seed": seed, "epoch": epoch},
               {"shuffle": False, "drop_remainder": False}):
        got = [b[1].tolist() for b in batch_iterator(x, y, 8, **kw)]
        want = [b[1].tolist() for b in jpipeline.batch_iterator(x, y, 8,
                                                                **kw)]
        assert got == want


PAD = 4


def _candidates(img, pad):
    """Every flip and crop of the zero-padded ``img``: {(flip, oh, ow):
    image}."""
    h, w, _ = img.shape
    out = {}
    for flip in (0, 1):
        src = img[:, ::-1] if flip else img
        xp = np.pad(src, ((pad, pad), (pad, pad), (0, 0)))
        for oh in range(2 * pad + 1):
            for ow in range(2 * pad + 1):
                out[(flip, oh, ow)] = xp[oh:oh + h, ow:ow + w]
    return out


def test_augment_is_a_flip_and_crop_of_the_padded_input():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16, 32, 32, 3)).astype(np.float32)
    key = keys.fold_in(keys.base_key(5), 17)
    got = datasets.make_augment("cifar10")(key, torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == x.dtype
    flip, oh, ow = datasets.augment_draws(key, 16, PAD)
    for i in range(16):
        matches = [k for k, c in _candidates(x[i], PAD).items()
                   if np.array_equal(c, got[i])]
        assert (int(flip[i]), int(oh[i]), int(ow[i])) in matches, i


def test_augment_statistics():
    """~4k draws: the flip share is 0.5 +- 0.03 and every offset in
    0..2*pad occurs on both axes."""
    flips, ohs, ows = [], [], []
    for step in range(32):
        f, oh, ow = datasets.augment_draws(
            keys.fold_in(keys.base_key(0), step), 128, PAD)
        flips.append(f)
        ohs.append(oh)
        ows.append(ow)
    flips, ohs, ows = (np.concatenate(a) for a in (flips, ohs, ows))
    assert flips.size == 4096
    assert set(np.unique(flips)) == {0, 1}
    assert abs(flips.mean() - 0.5) < 0.03
    for off in (ohs, ows):
        counts = np.bincount(off, minlength=2 * PAD + 1)
        assert counts.size == 2 * PAD + 1 and (counts > 0).all()
        # uniform over 9 offsets: 455 expected each
        assert (np.abs(counts - 4096 / 9) < 100).all(), counts


def test_augment_depends_on_seed_and_step_only():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (8, 32, 32, 3)).astype(np.float32))
    aug = datasets.make_augment("cifar10")
    data_key = keys.fold_in(keys.base_key(3), 0xA11CE)
    a = aug(keys.fold_in(data_key, 4), x)
    b = aug(keys.fold_in(data_key, 4), x.clone())
    c = aug(keys.fold_in(data_key, 5), x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert datasets.make_augment("mnist") is None


# ---------------------------------------------------------------------------
# device_prefetch: the cases of tests/test_pipeline.py
# ---------------------------------------------------------------------------


def _batches(n=10):
    for i in range(n):
        yield (np.full((4, 3), i, np.float32), np.full((4,), i, np.int32))


def test_device_prefetch_order_and_content():
    out = list(device_prefetch(_batches()))
    assert len(out) == 10
    for i, (x, y) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert x.dtype == torch.float32 and y.dtype == torch.int32
        assert (x == i).all() and (y == i).all()


def test_device_prefetch_propagates_errors():
    def bad():
        yield (np.zeros((2, 2), np.float32), np.zeros((2,), np.int32))
        raise RuntimeError("loader broke")

    it = device_prefetch(bad())
    next(it)
    with pytest.raises(RuntimeError, match="loader broke"):
        list(it)


def test_device_prefetch_releases_producer_on_abandon():
    """An abandoned generator stops its producer short of the source's
    end, and the thread exits."""
    produced = []
    before = set(threading.enumerate())

    def src():
        for i in range(100):
            produced.append(i)
            yield (np.full((2,), i, np.float32), np.full((2,), i, np.int32))

    it = device_prefetch(src(), size=2)
    next(it)
    it.close()  # GeneratorExit -> finally: stop + drain
    deadline = time.time() + 5.0
    while time.time() < deadline:
        new = [t for t in threading.enumerate()
               if t not in before and t.is_alive()]
        if not new:
            break
        time.sleep(0.05)
    assert not new, "the producer thread is still running"
    assert len(produced) < 100
