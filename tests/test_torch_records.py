"""The port's input sources held against lbt_tpu's on the CPU:

- ``data.native.NativeLoader``, ``data.tfrecord`` (JPEG and raw records,
  train and eval) and ``data.imagefolder`` give lbt_tpu's batches bit for
  bit: the port builds ``native/*.cc`` itself, with the Makefile's flags,
  into ``lbt_tpu_torch/_build``;
- the TFRecord writer's bytes and CRC32C are lbt_tpu's; a record that
  does not decode is skipped and counted;
- the port's Trainer fed by each source (2 steps of ResNet-8 at 32 px)
  against lbt_tpu's, at ``test_torch_trainer``'s tolerances;
- the CLI trains from each source, and keeps ``main.py``'s refusals.

Each test writes its own small data from a seed.  lbt_tpu's libraries are
loaded only inside the tests that compare with them.
"""

import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import lbt_tpu.config as jconfig
from lbt_tpu.models import cifar10_resnet as jax_resnet
from lbt_tpu.train.trainer import Trainer as JTrainer
from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.data import imagefolder, tfrecord
from lbt_tpu_torch.data.build import BUILD_DIR, NATIVE_DIR
from lbt_tpu_torch.data.datasets import aug_spec, load_dataset
from lbt_tpu_torch.data.native import NativeLoader
from lbt_tpu_torch.main import main
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.train.trainer import Trainer
from test_torch_train import _compare_trees, _lsb

pytest_plugins = ["torch_suite"]

WD = 2e-4


def _jtfrecord():
    import lbt_tpu.data.tfrecord as jtfr
    if not jtfr.native_available():
        pytest.skip("lbt_tpu's TFRecord library did not build")
    return jtfr


def _jnative():
    from lbt_tpu.data.native import NativeLoader as JNativeLoader
    if not JNativeLoader.available():
        pytest.skip("lbt_tpu's native loader did not build")
    return JNativeLoader


def _image(rng, h, w, gray=False):
    """Smooth content plus noise, so JPEG decode and resize do real work."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / (5 + k) + yy / (7 + 2 * k) + k)
                     for k in range(3)], -1)
    arr = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
    return arr[..., 0] if gray else arr


def _jpeg(arr, quality=90):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _write_shards(root, n_shards=2, per_shard=9, seed=0, raw=False,
                  n_classes=10, prefix="train"):
    """Shards of images of mixed sizes (24-60 px a side) with labels in
    ``0..n_classes-1``; returns their paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(n_shards):
        p = os.path.join(root, f"{prefix}-{s:02d}.tfrecord")
        with tfrecord.TFRecordWriter(p) as wr:
            for _ in range(per_shard):
                h, w = (int(v) for v in rng.integers(24, 61, 2))
                arr = _image(rng, h, w)
                label = int(rng.integers(0, n_classes))
                wr.write(tfrecord.make_example(arr.tobytes(), label, h, w)
                         if raw else tfrecord.make_example(_jpeg(arr), label))
        paths.append(p)
    return paths


def _write_tree(root, n_classes=3, per_class=(5, 2), seed=0):
    """``root/{train,val}/<class>/`` of JPEG, PNG and grayscale images of
    mixed sizes."""
    rng = np.random.default_rng(seed)
    for split, n in zip(("train", "val"), per_class):
        for c in range(n_classes):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(n):
                h, w = (int(v) for v in rng.integers(24, 61, 2))
                im = Image.fromarray(_image(rng, h, w, gray=(i == 1)))
                ext = ".png" if c == 1 else ".jpeg"
                im.save(os.path.join(d, f"im{i}{ext}"))
    return root


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (xg, yg), (xw, yw) in zip(got, want):
        assert xg.dtype == xw.dtype == np.float32
        assert yg.dtype == yw.dtype == np.int32
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


# ---------------------------------------------------------------------------
# the sources against lbt_tpu's, bitwise
# ---------------------------------------------------------------------------


def test_host_build_lands_in_the_package_build_dir():
    """The port's libraries come from ``native/*.cc`` into ``_build``,
    named by a hash; nothing is written into ``native/``."""
    before = set(os.listdir(NATIVE_DIR))
    NativeLoader(np.zeros((4, 2, 2, 1), np.float32), np.zeros(4, np.int32),
                 2)
    assert tfrecord.tfrecord_library() is not None
    built = sorted(p.name for p in BUILD_DIR.glob("liblbt_*.so"))
    assert any(n.startswith("liblbt_loader-") for n in built), built
    assert any(n.startswith("liblbt_tfrecord-") for n in built), built
    assert set(os.listdir(NATIVE_DIR)) <= before | {
        "liblbt_loader.so", "liblbt_tfrecord.so"}


@pytest.mark.parametrize("seed", [0, 7])
def test_native_loader_matches_lbt_tpu(seed):
    """Two seeds, two epochs, CIFAR's pad-4 crop and flip: every batch."""
    JNativeLoader = _jnative()
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (70, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 70).astype(np.int32)
    got = NativeLoader(x, y, 16, pad=4, flip=True, seed=seed)
    want = JNativeLoader(x, y, 16, pad=4, flip=True, seed=seed)
    for epoch in (0, 1):
        _same_batches(got.epoch(epoch), want.epoch(epoch))


@pytest.mark.parametrize("records", ["jpeg", "raw"])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_tfrecord_batches_match_lbt_tpu(tmp_path, split, records):
    """The Trainer dicts of ``tfrecord_dataset``: their sizes, and every
    batch (train: two epochs, crops and flips, remainder dropped; eval:
    shard order, the ragged last batch kept)."""
    jtfr = _jtfrecord()
    paths = _write_shards(str(tmp_path), raw=records == "raw")
    pattern = os.path.join(str(tmp_path), "train-*.tfrecord")
    kw = dict(image_size=32, seed=3, workers=2, num_classes=10)
    got = tfrecord.tfrecord_dataset(pattern, pattern, **kw)
    want = jtfr.tfrecord_dataset(pattern, pattern, **kw)
    for k in ("n_train", "n_test", "num_classes", "input_shape",
              "synthetic"):
        assert got[k] == want[k], k
    assert got["n_train"] == 2 * 9 == len(paths) * 9
    if split == "train":
        for epoch in (0, 1):
            _same_batches(got["train_iter"](epoch, 4),
                          want["train_iter"](epoch, 4))
    else:
        batches = list(got["test_iter"](4))
        assert [len(y) for _, y in batches] == [4, 4, 4, 4, 2]
        _same_batches(batches, want["test_iter"](4))
    with pytest.raises(ValueError, match="num_classes is required"):
        tfrecord.tfrecord_dataset(pattern, image_size=32)


@pytest.mark.parametrize("split", ["train", "eval"])
def test_imagefolder_batches_match_lbt_tpu(tmp_path, split):
    """``streaming_dataset`` of a tree of JPEG, PNG and grayscale images:
    its classes and sizes, and every batch (train: two epochs; eval: the
    ragged last batch kept)."""
    from lbt_tpu.data import imagefolder as jimagefolder
    root = _write_tree(str(tmp_path))
    kw = dict(image_size=32, seed=5, workers=2)
    args = (os.path.join(root, "train"), os.path.join(root, "val"))
    got = imagefolder.streaming_dataset(*args, **kw)
    want = jimagefolder.streaming_dataset(*args, **kw)
    for k in ("n_train", "n_test", "num_classes", "classes", "input_shape",
              "synthetic"):
        assert got[k] == want[k], k
    if split == "train":
        for epoch in (0, 1):
            _same_batches(got["train_iter"](epoch, 4),
                          want["train_iter"](epoch, 4))
    else:
        batches = list(got["test_iter"](4))
        assert [len(y) for _, y in batches] == [4, 2]
        _same_batches(batches, want["test_iter"](4))


def test_writer_bytes_and_crc_match_lbt_tpu(tmp_path):
    """``crc32c``, ``masked_crc``, ``make_example`` (both image forms,
    other keys) and a written shard, byte for byte; the port reads back
    what it wrote."""
    import lbt_tpu.data.tfrecord as jtfr  # pure Python: no library needed
    rng = np.random.default_rng(0)
    blobs = [b"", b"a", rng.bytes(1000), b"\xff" * 37]
    for b in blobs:
        assert tfrecord.crc32c(b) == jtfr.crc32c(b)
        assert tfrecord.masked_crc(b) == jtfr.masked_crc(b)
    examples = [
        ((blobs[2], 3), {}),
        ((blobs[2], 999), dict(height=10, width=25)),
        ((blobs[3], 0), dict(image_key="img", label_key="cls")),
    ]
    for args, kw in examples:
        assert tfrecord.make_example(*args, **kw) == jtfr.make_example(
            *args, **kw)
    recs = [tfrecord.make_example(*a, **kw) for a, kw in examples]
    for mod, name in ((tfrecord, "port"), (jtfr, "lbt_tpu")):
        with mod.TFRecordWriter(str(tmp_path / name)) as wr:
            for r in recs:
                wr.write(r)
    assert (tmp_path / "port").read_bytes() == (
        tmp_path / "lbt_tpu").read_bytes()
    assert list(tfrecord.read_records(str(tmp_path / "port"))) == recs


def test_corrupt_record_is_skipped_and_counted(tmp_path):
    """A record whose image does not decode is dropped, the rest of the
    shard streams, and ``skipped`` counts it, as in lbt_tpu."""
    jtfr = _jtfrecord()
    good = _write_shards(str(tmp_path), n_shards=1, per_shard=4)[0]
    mixed = str(tmp_path / "mixed.tfrecord")
    with tfrecord.TFRecordWriter(mixed) as wr:
        recs = list(tfrecord.read_records(good))
        for r in recs[:2]:
            wr.write(r)
        wr.write(tfrecord.make_example(b"\xff\xd8notajpeg", 0))
        for r in recs[2:]:
            wr.write(r)
    got = tfrecord.TFRecordDataset([mixed], image_size=16, train=False)
    want = jtfr.TFRecordDataset([mixed], image_size=16, train=False)
    assert len(got) == len(want) == 5
    batches = list(got.batches(0, 8))
    assert [len(y) for _, y in batches] == [4]
    assert got.skipped() == 1
    _same_batches(batches, want.batches(0, 8))
    assert want.skipped() == 1


# ---------------------------------------------------------------------------
# the Trainer on each source against lbt_tpu's
# ---------------------------------------------------------------------------


def _source(name, root, pkg):
    """(dataset dict, Trainer kwargs) of one source from one package."""
    if name == "native":
        data = load_dataset("cifar10", n_train=8, n_test=8)
        return data, dict(native_loader=True, aug_spec=aug_spec("cifar10"))
    if pkg == "lbt_tpu":
        if name == "tfrecord":
            jtfr = _jtfrecord()
            return jtfr.tfrecord_dataset(
                os.path.join(root, "train-*.tfrecord"), image_size=32,
                seed=7, workers=2, num_classes=10), {}
        from lbt_tpu.data import imagefolder as jimagefolder
        return jimagefolder.streaming_dataset(
            os.path.join(root, "train"), image_size=32, seed=7,
            workers=2), {}
    if name == "tfrecord":
        return tfrecord.tfrecord_dataset(
            os.path.join(root, "train-*.tfrecord"), image_size=32, seed=7,
            workers=2, num_classes=10), {}
    return imagefolder.streaming_dataset(
        os.path.join(root, "train"), image_size=32, seed=7, workers=2), {}


@pytest.fixture(scope="module")
def jax_step():
    """lbt_tpu's jitted train step of ResNet-8, compiled once for the
    module (each source's lbt_tpu Trainer takes it)."""
    return {}


@pytest.mark.parametrize("name", ["native", "tfrecord", "imagefolder"])
def test_trainer_on_each_source_matches_lbt_tpu(tmp_path, jax_step, name):
    """2 steps of batch 4 from the same weights and seed, each package
    fed by its own source: exponents bitwise; params and velocity at the
    tolerances of ``test_torch_trainer``'s trajectory test."""
    root = str(tmp_path)
    if name == "tfrecord":
        _write_shards(root, n_shards=2, per_shard=4)
    elif name == "imagefolder":
        _write_tree(root, n_classes=4, per_class=(2, 0))
    jcfg = jconfig.QuantConfig.uniform(8, noise_mode="hash")
    tcfg = tconfig.QuantConfig.uniform(8, noise_mode="hash")
    kw = dict(batch_size=4, n_epoch=1, seed=7, log_every=1,
              weight_decay=WD)
    jdata, jkw = _source(name, root, "lbt_tpu")
    tdata, tkw = _source(name, root, "lbt_tpu_torch")
    jtr = JTrainer(jax_resnet(jcfg, 8, weight_decay=WD),
                   jconfig.TrainConfig(**kw), jdata, **jkw)
    if "step" in jax_step:
        jtr.train_step = jax_step["step"]
    jax_step["step"] = jtr.train_step
    params = jax.tree.map(np.asarray, jtr.params)
    qstate = jax.tree.map(np.asarray, jtr.qstate)
    ttr = Trainer(cifar10_resnet(tcfg, 8, weight_decay=WD),
                  tconfig.TrainConfig(**kw), tdata, device="cpu", **tkw)
    convert.from_jax_numpy(ttr.model, params, qstate)
    jtr.train_epoch(0)
    ttr.train_epoch(0)
    assert ttr.step == jtr.step == 2
    p, q, v = convert.to_jax_numpy(ttr.model, ttr.velocity)
    jq = jax.tree.map(np.asarray, jtr.qstate)

    def lsb_of(path):
        node = jq
        parts = path.strip("/").split("/")
        for part in parts[:-1]:
            node = node[part]
        exps = node.get("exp", {}) if isinstance(node, dict) else {}
        site = {"W": "w", "gamma": "gamma", "beta": "beta"}.get(parts[-1],
                                                                "x")
        return _lsb(8, exps.get(site, 2))

    _compare_trees(q, jq, lambda path: _lsb(8, 2))
    _compare_trees(p, jax.tree.map(np.asarray, jtr.params), lsb_of)
    _compare_trees(v, jax.tree.map(np.asarray, jtr.velocity), lsb_of)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _rows(path):
    return [json.loads(r) for r in open(path).read().splitlines()]


@pytest.mark.parametrize("source", ["tfrecord", "data_dir", "native_loader"])
def test_cli_trains_from_each_source(tmp_path, source):
    """``python -m lbt_tpu_torch.main`` on ResNet-20 from TFRecord shards
    (``--num_classes``), an ImageFolder tree and the native loader: the
    steps of one epoch, finite logged losses, an eval."""
    argv = ["--model", "CIFAR10_Resnet20", "--noise_mode", "hash",
            "--device", "cpu", "--batch_size", "8", "--n_epoch", "1",
            "--log_every", "1", "--exp_path", str(tmp_path / "exp")]
    if source == "tfrecord":
        _write_shards(str(tmp_path), n_shards=2, per_shard=8)
        _write_shards(str(tmp_path), n_shards=1, per_shard=5, seed=1,
                      prefix="val")
        argv += ["--tfrecord_train", str(tmp_path / "train-*.tfrecord"),
                 "--tfrecord_val", str(tmp_path / "val-*.tfrecord"),
                 "--num_classes", "10"]
    elif source == "data_dir":
        _write_tree(str(tmp_path), n_classes=4, per_class=(4, 2))
        argv += ["--data_dir", str(tmp_path)]
    else:
        argv += ["--native_loader", "--n_train", "16", "--n_test", "8"]
    tr = main(argv)
    assert tr.step == 2 and (tr.native is not None) == (
        source == "native_loader")
    rows = _rows(tmp_path / "exp" / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert [r for r in rows if "test/loss" in r]


@pytest.mark.parametrize("argv,msg", [
    (["--tfrecord_train", "x-*"], "--tfrecord_train requires --num_classes"),
    (["--tfrecord_train", "x-*", "--num_classes", "10", "--native_loader"],
     "--native_loader needs in-memory arrays"),
    (["--data_dir", "x", "--native_loader"],
     "--native_loader needs in-memory arrays"),
])
def test_cli_keeps_main_py_data_refusals(tmp_path, argv, msg):
    with pytest.raises(SystemExit, match=msg):
        main(argv + ["--device", "cpu", "--exp_path", str(tmp_path / "e")])
