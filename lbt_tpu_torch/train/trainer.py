"""Training loop (PyTorch port of ``lbt_tpu/train/trainer.py``), on one
device or data parallel over the ranks of ``torch.distributed``.

One eager train step per batch (``train.step.make_train_step``: forward
with the range controllers, quantized backward, momentum SGD), batches
prefetched to the device, the augmentation on the device, per-epoch
evaluation, periodic checkpoints with exact resume, and JSONL /
TensorBoard metrics.  With ``TrainConfig.scan_steps = K > 1`` (and not
data parallel, as in ``lbt_tpu``) an epoch runs in blocks of K steps
(``train.step.make_scan_train_step``): K host batches reach the device as
one copy and the metrics are logged a block at a time; the trajectory is
the eager loop's, bit for bit.

Randomness comes from ``TrainConfig.seed`` alone.  The weights are
:meth:`Model.init` of ``torch.Generator().manual_seed(seed)``;
``base_key = keys.base_key(seed, impl=model.cfg.noise_impl)`` seeds the
stochastic rounding (``fold_in(base_key, step)`` per train step,
``fold_in(base_key, 0xE7A1)`` for every eval batch, as ``lbt_tpu``); the
augmentation draws from ``fold_in(data_key, step)`` with ``data_key =
split(fold_in(base_key, 0xA11CE))[1]``, as ``lbt_tpu`` takes it (its
other half seeds ``lbt_tpu``'s init, which the port does not share); the
batch order is ``batch_iterator``'s ``(seed, epoch)`` shuffle.  So a run resumed from a checkpoint takes the steps the
uninterrupted run took.

Data parallel (``TrainConfig.data_parallel`` in a process group of more
than one rank, ``parallel.multihost.initialize`` first): every rank runs
this loop over the same global batches, reads and decodes only its own
rows of each (``host_batch_slice``), augments them with the global
batch's draws, and steps with ``parallel.dp.make_dp_train_step``; the
low-bit all-reduce's ``ebuf`` joins the checkpoint.  Only rank 0 writes
logs, metrics, traces and checkpoints.  Evaluation pads each eval batch
to a multiple of the world size, each rank evaluates its rows
(``make_masked_eval_step``) and the sums are added over the ranks.

Tensor parallel (``TrainConfig.tensor_parallel = T > 1`` with
``data_parallel``, as in ``lbt_tpu``): the world is a ``data x T`` layout
(``parallel.mesh.make_groups``), each rank holds its model index's
columns of every large weight (``parallel.mesh.shard_model``, after the
whole model's seeded init), and the rows of a global batch, the eval's
padding and every reduction above go by data index: the ``T`` ranks of
one data index feed the same rows.  With one data index (``T`` ranks in
all) the run is not data parallel, as ``lbt_tpu``'s Trainer is not on
``T`` devices: the one-rank steps run on the sharded model, so the run
is the one-process run, bit for bit on the integer route and at f32
tolerance on the float route (``ops/qops.py``).  A checkpoint holds the
whole tensors (gathered over the model group; rank 0 writes them), so it
restores at any ``T`` over as many data indices (one data index: in one
process too).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lbt_tpu_torch.config import TrainConfig
from lbt_tpu_torch.data.native import NativeLoader
from lbt_tpu_torch.data.pipeline import batch_iterator, device_prefetch
from lbt_tpu_torch.dfxp import keys
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.parallel.multihost import host_batch_slice
from lbt_tpu_torch.train import checkpoint as ckpt
from lbt_tpu_torch.train.optim import momentum_init, piecewise_lr
from lbt_tpu_torch.train.step import (make_eval_step, make_masked_eval_step,
                                      make_scan_train_step, make_train_step)
from lbt_tpu_torch.utils.device import resolve_device
from lbt_tpu_torch.utils.logging import (MetricsWriter, get_logger,
                                         null_logger)
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
    in place of ``augment``.

    Under data parallelism (``tc.data_parallel`` and a process group of
    more than one rank) ``group`` is the
    :class:`~lbt_tpu_torch.parallel.multihost.Group` (by default one over
    the whole world) and ``device`` this rank's; the streaming sources
    take ``rows=(start, size)`` and ``augment`` takes ``rows=(row0,
    n_global)`` (``data.datasets.augment_crop_flip``).  With
    ``tc.tensor_parallel > 1`` the Trainer builds its own data and model
    groups over the whole world (``group`` is then not used):
    ``self.tp`` is the model group and ``self.group`` the data group
    (None with one data index)."""

    def __init__(self, model: Model, tc: TrainConfig, dataset: Dict,
                 augment: Optional[Callable] = None, logger=None,
                 logdir: Optional[str] = None, profile_steps: int = 0,
                 native_loader: bool = False,
                 aug_spec: Optional[Dict] = None, device=None, group=None):
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        tp = (max(int(tc.tensor_parallel), 1)
              if tc.data_parallel and world > 1 else 1)
        # data parallel past one data shard, as lbt_tpu's rule
        self.dp = bool(tc.data_parallel) and world // tp > 1
        if world > 1 and not tc.data_parallel:
            raise ValueError(
                "multi-process runs require data_parallel=True (each "
                "process only holds its own batch shard)")
        self.group = self.tp = None
        if tp > 1:
            from lbt_tpu_torch.parallel import mesh
            if world % tp:
                raise ValueError(f"tensor_parallel {tp} does not divide "
                                 f"the {world} ranks")
            data, self.tp = mesh.make_groups(world // tp, tp,
                                             resolve_device(device))
            self.group = data if self.dp else None
        elif self.dp:
            from lbt_tpu_torch.parallel.multihost import Group
            self.group = group if group is not None else Group(device=device)
        if self.dp and tc.batch_size % self.group.world:
            raise ValueError(
                f"batch_size {tc.batch_size} must divide across "
                f"{self.group.world} data shards")
        self.is_main = world == 1 or torch.distributed.get_rank() == 0
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
        if not self.is_main:
            # only rank 0 writes logs, metrics, traces and checkpoints
            logdir = None
            logger = null_logger()
        self.logger = logger or get_logger(
            f"{logdir}/experiment.log" if logdir else None)
        self.metrics = MetricsWriter(logdir)
        self.profiler = StepProfiler(
            f"{logdir}/profile" if logdir else None, profile_steps)

        model.init(torch.Generator().manual_seed(tc.seed)).to(self.device)
        n_params = sum(p.numel() for p in model.net.parameters())
        self.pspecs = None
        if self.tp is not None:
            from lbt_tpu_torch.parallel.mesh import shard_model
            self.pspecs = shard_model(model, self.tp)
        self.params = dict(model.net.named_parameters())
        self.velocity = momentum_init(self.params)
        self.base_key = keys.base_key(
            tc.seed, impl=model.cfg.noise_impl if model.cfg is not None
            else "threefry2x32")
        self.data_key = keys.split(
            keys.fold_in(self.base_key, DATA_KEY_FOLD))[1]
        self.faithful = bool(model.cfg and model.cfg.faithful_eval)
        self.ebuf = None
        if self.dp:
            from lbt_tpu_torch.parallel.dp import make_dp_train_step
            from lbt_tpu_torch.parallel.lowbit import init_error_buffers
            self.train_step = make_dp_train_step(
                model, tc, self.group,
                lowbit_bits=8 if tc.lowbit_allreduce else None,
                lowbit_wire=tc.lowbit_wire, tp=self.tp)
            self.ebuf = init_error_buffers(self.params)
            self.eval_step = make_masked_eval_step(
                model, faithful_eval=self.faithful)
        else:
            self.train_step = make_train_step(model, tc)
            self.eval_step = make_eval_step(model,
                                            faithful_eval=self.faithful)
        # K steps a block off data parallelism; the C++ loader augments
        # on the host, so the block then augments nothing
        self.scan_train_step = None
        if tc.scan_steps > 1 and not self.dp:
            self.scan_train_step = make_scan_train_step(
                model, tc, tc.scan_steps, augment=self.augment)
        self.step = 0
        self.epoch = 0
        # the step of the checkpoint this run wrote or resumed from last
        self._saved_step = None
        # the last epoch's wall seconds (device work included), images
        # and seconds the loop waited on the input
        self.epoch_time = {}

        self.logger.info("Model %s: %d params on %s%s", model.name, n_params,
                         self.device, "" if self.tp is None else
                         f", large weights in {self.tp.world} column "
                         f"slices over a {world // self.tp.world} x "
                         f"{self.tp.world} layout")
        self.logger.info(
            "Trainer: lr %g decay %g @ %s, momentum %g, wd %g, bs %d, "
            "%d epochs", tc.lr, tc.lr_decay_factor,
            list(tc.lr_decay_epochs), tc.momentum, tc.weight_decay,
            tc.batch_size, tc.n_epoch)

    # -- checkpoint ---------------------------------------------------------
    def _specs(self, tensors):
        return {k: self.pspecs.get(k, ()) for k in tensors}

    def _whole(self, tensors: Dict[str, torch.Tensor]):
        """``tensors`` (keyed by parameter or state name) with every
        sharded weight's slices gathered over the model group: a
        collective under tensor parallelism."""
        if self.tp is None:
            return tensors
        from lbt_tpu_torch.parallel.mesh import gather_params
        return gather_params(tensors, self._specs(tensors), self.tp)

    def _mine(self, tensors: Dict[str, torch.Tensor]):
        """This rank's slices of whole ``tensors`` (as :meth:`_whole`)."""
        if self.tp is None:
            return tensors
        from lbt_tpu_torch.parallel.mesh import shard_params
        return shard_params(tensors, self._specs(tensors), self.tp.world,
                            self.tp.rank)

    def _state(self, ebuf=None):
        """The checkpoint's state, whole tensors (a collective under
        tensor parallelism)."""
        state = {"model": self._whole(self.model.net.state_dict()),
                 "velocity": self._whole(self.velocity),
                 "epoch": self.epoch, "step": self.step}
        if self.dp:
            state["ebuf"] = self._whole(self.ebuf if ebuf is None else ebuf)
        return state

    def _saved_ebuf(self) -> Dict[str, torch.Tensor]:
        """The ``ebuf`` a checkpoint holds, as ``lbt_tpu``'s: its ``ebuf``
        is declared replicated while each device holds its own residual,
        and Orbax writes a replicated array from every replica, each the
        slice ``k`` of ``world`` along the first axis that divides by
        ``world`` (replica 0 the whole leaf where none does).  So each
        leaf here is rank ``k``'s slice ``k`` there, put together with one
        all-reduce (the other ranks add zeros); under tensor parallelism
        the ranks are the data group's and the leaves their slices."""
        g = self.group
        mine = {}
        for k, v in self.ebuf.items():
            ax = next((i for i, n in enumerate(v.shape) if n % g.world == 0),
                      None)
            part = torch.zeros_like(v)
            if ax is None:
                if g.rank == 0:
                    part.copy_(v)
            else:
                w = v.shape[ax] // g.world
                part.narrow(ax, g.rank * w, w).copy_(
                    v.narrow(ax, g.rank * w, w))
            mine[k] = part
        return dict(zip(mine, g.all_reduce_each(list(mine.values()))))

    def save(self, directory: Optional[str] = None):
        """Write the checkpoint.  Under data parallelism every rank calls
        this (the saved ``ebuf`` takes a slice from each, see
        :meth:`_saved_ebuf`) and rank 0 writes it."""
        directory = directory or self.tc.checkpoint_dir
        if not directory:
            return
        state = self._state(self._saved_ebuf() if self.dp else None)
        self._saved_step = self.step
        if not self.is_main:
            return
        ckpt.save_checkpoint(directory, self.step, state)
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
            model_sd = self._mine(state["model"])
            for k, t in self.model.net.state_dict().items():
                t.copy_(model_sd[k])
            velocity = self._mine(state["velocity"])
            for k, v in self.velocity.items():
                v.copy_(velocity[k])
            if self.dp and "ebuf" in state:
                ebuf = self._mine(state["ebuf"])
                for k, v in self.ebuf.items():
                    v.copy_(ebuf[k])
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])
        self._saved_step = self.step
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

        if self.scan_train_step is not None:
            return self._train_epoch_scanned(epoch, lr)
        # a data-parallel rank reads, decodes and sends only its rows
        rows = (host_batch_slice(tc.batch_size, self.group) if self.dp
                else None)
        batches = device_prefetch(self._train_source(epoch, rows),
                                  device=self.device)
        aug_rows = {} if rows is None else {"rows": (rows[0],
                                                     tc.batch_size)}
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
                x = self.augment(keys.fold_in(self.data_key, self.step), x,
                                 **aug_rows)
            self.profiler.observe(self.step)
            if self.dp:
                m = self.train_step(self.model, self.velocity, self.ebuf, x,
                                    y, self.step, lr, self.base_key)
            else:
                m = self.train_step(self.model, self.velocity, x, y,
                                    self.step, lr, self.base_key)
            self.step += 1
            n_img += tc.batch_size if self.dp else len(y)
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

    def _train_source(self, epoch: int, rows=None):
        """The epoch's host batches (numpy ``(x, y)``): ``rows`` of each
        global batch, or whole batches."""
        tc = self.tc
        if self.native is not None:
            src = self.native.epoch(epoch)
            if rows is not None:  # the C++ loader yields global batches
                src = ((x[rows[0]:sum(rows)], y[rows[0]:sum(rows)])
                       for x, y in src)
            return src
        if "train_iter" in self.dataset:
            return self.dataset["train_iter"](
                epoch, tc.batch_size, **({"rows": rows} if rows else {}))
        xtr, ytr = self.dataset["train"]
        return batch_iterator(xtr, ytr, tc.batch_size, seed=tc.seed,
                              epoch=epoch, rows=rows)

    def _train_epoch_scanned(self, epoch: int, lr: float) -> Dict[str, float]:
        """``lbt_tpu``'s scanned epoch: K host batches stacked into a
        block, one copy to the device, one call of the K-step block (it
        augments each batch with the eager loop's key); a short last block
        runs its steps one by one through the eager step.  Metrics are
        read a block at a time: once the steps since the last log reach
        ``log_every``, the block's last step's are written at the step
        after it.  No input-stall row, as ``lbt_tpu`` writes none."""
        tc, K = self.tc, self.tc.scan_steps
        it = iter(self._train_source(epoch))

        def blocks():
            while True:
                block = [b for _, b in zip(range(K), it)]
                if not block:
                    return
                yield tuple(np.stack(a) for a in zip(*block))
                if len(block) < K:
                    return

        last = {}
        t0, n_img = time.time(), 0
        first_logged = self.step > 0
        since_log = 0
        for xs, ys in device_prefetch(blocks(), device=self.device):
            k = xs.shape[0]
            if k == K:
                self.profiler.observe(self.step)
                ms = self.scan_train_step(
                    self.model, self.velocity, xs, ys, self.step, lr,
                    self.base_key, self.data_key)
                m = {name: v[-1] for name, v in ms.items()}
                self.step += k
            else:
                for x, y in zip(xs, ys):
                    if self.augment is not None:
                        x = self.augment(
                            keys.fold_in(self.data_key, self.step), x)
                    m = self.train_step(self.model, self.velocity, x, y,
                                        self.step, lr, self.base_key)
                    self.step += 1
            n_img += ys.numel()
            if not first_logged:
                m["loss"].item()
                self.logger.info("first scan block (with warm-up) took "
                                 "%.1fs", time.time() - t0)
                first_logged = True
            since_log += k
            if since_log >= tc.log_every:
                since_log = 0
                loss, acc = torch.stack(
                    [m["loss"], m["accuracy"]]).cpu().tolist()
                m = {"loss": loss, "accuracy": acc}
                self.logger.info(
                    "epoch %d step %d loss %.4f acc %.4f (%.0f img/s)",
                    epoch, self.step, loss, acc,
                    n_img / (time.time() - t0))
                self.metrics.write(self.step, m, prefix="train/")
                self.metrics.write_param_means(self.step, self.model)
                last = m
        self.profiler.stop()
        self._sync()
        self.epoch_time = {"seconds": time.time() - t0, "images": n_img}
        return last

    def evaluate(self) -> Dict[str, float]:
        """Mean loss and accuracy over the test set: weighted by each
        batch's count (exact with a ragged final batch), or, under
        ``faithful_eval``, the reference's mean of per-batch means."""
        if self.dp:
            return self._evaluate_dp()
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

    def _eval_batches(self, rows):
        """``(x, y, n)`` of each eval batch: this rank's ``rows`` of it
        (fewer, or none, in a ragged last batch) and ``n`` the batch's
        true count."""
        tc = self.tc
        if "test_iter" in self.dataset:
            n_left = self.dataset["n_test"]
            src = self.dataset["test_iter"](tc.eval_batch_size, rows=rows)
        else:
            xte, yte = self.dataset["test"]
            n_left = len(xte)
            src = batch_iterator(xte, yte, tc.eval_batch_size,
                                 shuffle=False, drop_remainder=False,
                                 rows=rows)
        for x, y in src:
            n = min(tc.eval_batch_size, n_left)
            n_left -= n
            yield x, y, n

    def _evaluate_dp(self) -> Dict[str, float]:
        """``lbt_tpu``'s ``_evaluate_dp``: each eval batch padded to a
        multiple of the world size, each rank evaluating its rows of it
        at its ``row0`` (where the global batch draws their noise), the
        masked sums added over the ranks in one all-reduce and divided by
        the true count (the exact count-weighted mean, with or without
        ``faithful_eval``, as ``lbt_tpu``).  Under ``faithful_eval`` BN
        takes the moments of the global padded batch, padding rows
        included, so every rank pads its rows with zeros; otherwise no
        row sees another, and a rank evaluates its real rows alone."""
        tc, group = self.tc, self.group
        eb = -(-tc.eval_batch_size // group.world) * group.world
        rows = host_batch_slice(eb, group)
        key = keys.fold_in(self.base_key, EVAL_KEY_FOLD)
        sums, n_examples = [], 0
        for x, y, n in self._eval_batches(rows):
            n_examples += n
            if self.faithful and len(x) < rows[1]:
                pad = rows[1] - len(x)
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:],
                                                x.dtype)])
                y = np.concatenate([y, np.zeros((pad,), y.dtype)])
            if not len(x):
                sums.append(torch.zeros(2, device=self.device))
                continue
            x, y = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for a in (x, y))
            m = self.eval_step(self.model, x, y, n, key, dist=group,
                               row0=rows[0])
            sums.append(torch.stack([m["loss_sum"], m["correct_sum"]]))
        if not sums:
            return {"loss": 0.0, "accuracy": 0.0}
        # one collective for the whole set; summed on the host in float64
        # batch by batch, as lbt_tpu adds its global batch sums
        total = group.all_reduce(torch.stack(sums)).cpu().tolist()
        denom = max(float(n_examples), 1.0)
        return {"loss": sum(v[0] for v in total) / denom,
                "accuracy": sum(v[1] for v in total) / denom}

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
        # the final state, unless the last epoch's checkpoint holds it (the
        # same answer on every rank: a save under DP is a collective)
        if tc.checkpoint_dir and self._saved_step != self.step:
            self.save()
        return self.evaluate()
