"""Training loop on one device (PyTorch port of ``lbt_tpu/train/trainer.py``).

One eager train step per batch (``train.step.make_train_step``: forward
with the range controllers, quantized backward, momentum SGD), batches
prefetched to the device, the augmentation on the device, per-epoch
evaluation, periodic checkpoints with exact resume, and JSONL /
TensorBoard metrics.

Randomness comes from ``TrainConfig.seed`` alone.  The weights are
:meth:`Model.init` of ``torch.Generator().manual_seed(seed)``;
``base_key = keys.base_key(seed)`` seeds the stochastic rounding
(``fold_in(base_key, step)`` per train step, ``fold_in(base_key, 0xE7A1)``
for every eval batch, as ``lbt_tpu``); the augmentation draws from
``fold_in(data_key, step)`` with ``data_key = fold_in(fold_in(base_key,
0xA11CE), 1)``; the batch order is ``batch_iterator``'s ``(seed, epoch)``
shuffle.  So a run resumed from a checkpoint takes the steps the
uninterrupted run took.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from lbt_tpu_torch.config import TrainConfig
from lbt_tpu_torch.data.native import NativeLoader
from lbt_tpu_torch.data.pipeline import batch_iterator, device_prefetch
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.train import checkpoint as ckpt
from lbt_tpu_torch.train.optim import momentum_init, piecewise_lr
from lbt_tpu_torch.train.step import make_eval_step, make_train_step
from lbt_tpu_torch.utils.device import resolve_device
from lbt_tpu_torch.utils.logging import MetricsWriter, get_logger
from lbt_tpu_torch.utils.profiling import StepProfiler

# what lbt_tpu folds into its base key for the eval key and for the
# params / data split
EVAL_KEY_FOLD = 0xE7A1
DATA_KEY_FOLD = 0xA11CE


class Trainer:
    """``lbt_tpu``'s Trainer on one ``device``: the card by default
    (raising without one), the CPU only when ``device="cpu"``.
    ``dataset`` holds ``'train'`` / ``'test'`` numpy ``(x, y)`` pairs, or
    ``'train_iter'(epoch, batch_size)`` / ``'test_iter'(batch_size)``
    callables yielding numpy batches.  ``augment`` is ``(key, x) -> x``
    (``data.datasets.make_augment``).  ``native_loader`` takes the train
    batches of the in-memory ``'train'`` arrays from the C++ loader
    (``data.native.NativeLoader``), which also augments them as
    ``aug_spec`` (``{'pad', 'flip'}``, ``data.datasets.aug_spec``) says,
    in place of ``augment``."""

    def __init__(self, model: Model, tc: TrainConfig, dataset: Dict,
                 augment: Optional[Callable] = None, logger=None,
                 logdir: Optional[str] = None, profile_steps: int = 0,
                 native_loader: bool = False,
                 aug_spec: Optional[Dict] = None, device=None):
        if tc.data_parallel or tc.tensor_parallel > 1 or tc.lowbit_allreduce \
                or tc.lowbit_wire is not None:
            raise NotImplementedError(
                "data / tensor parallelism and the low-bit all-reduce are "
                "not ported (ROADMAP queue 1 item 12); the port trains on "
                "one device")
        if tc.scan_steps > 1:
            raise NotImplementedError(
                f"scan_steps={tc.scan_steps}: the scanned K-step block is "
                f"not to be ported (ROADMAP queue 1 item 13); steps run one "
                f"by one")
        self.model = model
        self.tc = tc
        self.dataset = dataset
        self.augment = augment
        self.native = None
        if native_loader:
            # shuffle and augmentation on the loader's host threads, one
            # batch ahead (native/loader.cc)
            spec = aug_spec or {}
            xtr, ytr = dataset["train"]
            self.native = NativeLoader(
                xtr, ytr, tc.batch_size, pad=spec.get("pad", 0),
                flip=spec.get("flip", False), seed=tc.seed)
            self.augment = None
        self.device = resolve_device(device)
        self.logger = logger or get_logger(
            f"{logdir}/experiment.log" if logdir else None)
        self.metrics = MetricsWriter(logdir)
        self.profiler = StepProfiler(
            f"{logdir}/profile" if logdir else None, profile_steps)

        model.init(torch.Generator().manual_seed(tc.seed)).to(self.device)
        self.params = dict(model.net.named_parameters())
        self.velocity = momentum_init(self.params)
        self.base_key = keys.base_key(tc.seed)
        self.data_key = keys.fold_in(
            keys.fold_in(self.base_key, DATA_KEY_FOLD), 1)
        self.train_step = make_train_step(model, tc)
        self.faithful = bool(model.cfg and model.cfg.faithful_eval)
        self.eval_step = make_eval_step(model, faithful_eval=self.faithful)
        self.step = 0
        self.epoch = 0
        # the last epoch's wall seconds (device work included), images
        # and seconds the loop waited on the input
        self.epoch_time = {}

        n_params = sum(p.numel() for p in self.params.values())
        self.logger.info("Model %s: %d params on %s", model.name, n_params,
                         self.device)
        self.logger.info(
            "Trainer: lr %g decay %g @ %s, momentum %g, wd %g, bs %d, "
            "%d epochs", tc.lr, tc.lr_decay_factor,
            list(tc.lr_decay_epochs), tc.momentum, tc.weight_decay,
            tc.batch_size, tc.n_epoch)

    # -- checkpoint ---------------------------------------------------------
    def _state(self):
        return {"model": self.model.net.state_dict(),
                "velocity": self.velocity,
                "epoch": self.epoch, "step": self.step}

    def save(self, directory: Optional[str] = None):
        directory = directory or self.tc.checkpoint_dir
        if not directory:
            return
        ckpt.save_checkpoint(directory, self.step, self._state())
        self.logger.info("Saved checkpoint @ step %d to %s",
                         self.step, directory)

    def maybe_restore(self) -> bool:
        d = self.tc.checkpoint_dir
        if not d:
            return False
        step = ckpt.latest_step(d)
        if step is None:
            return False
        state = ckpt.restore_checkpoint(d, self._state(), step)
        with torch.no_grad():
            for k, t in self.model.net.state_dict().items():
                t.copy_(state["model"][k])
            for k, v in self.velocity.items():
                v.copy_(state["velocity"][k])
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])
        self.logger.info("Resumed from %s @ step %d (epoch %d)",
                         d, step, self.epoch)
        return True

    # -- loops --------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        tc = self.tc
        lr = piecewise_lr(tc.lr, tc.lr_decay_factor, tc.lr_decay_epochs,
                          epoch, tc.warmup_epochs)
        if tc.reset_momentum_on_decay and epoch in tc.lr_decay_epochs:
            # reference quirk: a fresh optimizer at each decay zeroes the
            # momentum slots
            self.velocity = momentum_init(self.params)
            self.logger.info("Reset momentum slots (faithful mode)")

        if self.native is not None:
            src = self.native.epoch(epoch)
        elif "train_iter" in self.dataset:
            src = self.dataset["train_iter"](epoch, tc.batch_size)
        else:
            xtr, ytr = self.dataset["train"]
            src = batch_iterator(xtr, ytr, tc.batch_size, seed=tc.seed,
                                 epoch=epoch)
        batches = device_prefetch(src, device=self.device)
        last = {}
        t0, n_img = time.time(), 0
        first_step_logged = self.step > 0
        # input-stall accounting: host time blocked on the next
        # (prefetched) batch against the epoch's wall time
        stall = 0.0

        def timed(it):
            nonlocal stall
            it = iter(it)
            while True:
                tw = time.time()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                stall += time.time() - tw
                yield batch

        for b, (x, y) in enumerate(timed(batches)):
            if self.augment is not None:
                x = self.augment(keys.fold_in(self.data_key, self.step), x)
            self.profiler.observe(self.step)
            m = self.train_step(self.model, self.velocity, x, y, self.step,
                                lr, self.base_key)
            self.step += 1
            n_img += len(y)
            if not first_step_logged:
                m["loss"].item()
                self.logger.info("first train step (with warm-up) took "
                                 "%.1fs", time.time() - t0)
                first_step_logged = True
            # metrics reach the host only here: a read every step would
            # wait on the device every step
            if (b + 1) % tc.log_every == 0:
                loss, acc = torch.stack(
                    [m["loss"], m["accuracy"]]).cpu().tolist()
                m = {"loss": loss, "accuracy": acc}
                rate = n_img / (time.time() - t0)
                self.logger.info(
                    "epoch %d batch %d loss %.4f acc %.4f (%.0f img/s)",
                    epoch, b + 1, loss, acc, rate)
                self.metrics.write(self.step, m, prefix="train/")
                self.metrics.write_param_means(self.step, self.model)
                last = m
        self.profiler.stop()
        self._sync()
        wall = time.time() - t0
        self.epoch_time = {"seconds": wall, "images": n_img,
                           "stall_seconds": stall}
        if wall > 0 and n_img:
            self.logger.info(
                "epoch %d input stall %.1f%% (%.2fs of %.2fs), %.0f img/s",
                epoch, 100.0 * stall / wall, stall, wall, n_img / wall)
            self.metrics.write(self.step,
                               {"input_stall_frac": stall / wall},
                               prefix="train/")
        return last

    def evaluate(self) -> Dict[str, float]:
        """Mean loss and accuracy over the test set: weighted by each
        batch's count (exact with a ragged final batch), or, under
        ``faithful_eval``, the reference's mean of per-batch means."""
        tc = self.tc
        if "test_iter" in self.dataset:
            batches = self.dataset["test_iter"](tc.eval_batch_size)
        else:
            xte, yte = self.dataset["test"]
            batches = batch_iterator(xte, yte, tc.eval_batch_size,
                                     shuffle=False, drop_remainder=False)
        key = keys.fold_in(self.base_key, EVAL_KEY_FOLD)
        ms = [self.eval_step(self.model, x, y, key)
              for x, y in device_prefetch(batches, device=self.device)]
        if not ms:
            return {"loss": 0.0, "accuracy": 0.0}
        # one host read for the whole set, summed in float64 as lbt_tpu
        values = torch.stack([torch.stack([m["loss"], m["accuracy"]])
                              for m in ms]).cpu().tolist()
        tot = {"loss": 0.0, "accuracy": 0.0}
        n_examples = 0.0
        for (loss, acc), m in zip(values, ms):
            count = float(m["count"])
            w = 1.0 if self.faithful else count
            tot["loss"] += loss * w
            tot["accuracy"] += acc * w
            n_examples += count
        denom = len(ms) if self.faithful else max(n_examples, 1.0)
        return {k: v / denom for k, v in tot.items()}

    def train(self) -> Dict[str, float]:
        self.maybe_restore()
        tc = self.tc
        while self.epoch < tc.n_epoch:
            self.train_epoch(self.epoch)
            ev = self.evaluate()
            self.logger.info("Epoch %d test accuracy %.4f loss %.4f",
                             self.epoch + 1, ev["accuracy"], ev["loss"])
            self.metrics.write(self.step, ev, prefix="test/")
            self.metrics.write_exponents(self.step, self.model)
            self.epoch += 1
            if (tc.checkpoint_dir and tc.checkpoint_every_epochs and
                    self.epoch % tc.checkpoint_every_epochs == 0):
                self.save()
        # the final state, unless the last epoch's checkpoint holds it
        if tc.checkpoint_dir and ckpt.latest_step(tc.checkpoint_dir) \
                != self.step:
            self.save()
        return self.evaluate()
