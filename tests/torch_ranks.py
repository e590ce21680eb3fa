"""The ranks of the port's data- and tensor-parallel tests: one process
per rank, started by ``tests/test_torch_parallel*.py`` and
``tests/test_torch_tp*.py`` through :func:`start_ranks`; torch and the
port only, never JAX.

    python tests/torch_ranks.py JOBS.pkl RANK WORLD STORE OUT.pkl

The ranks meet over a ``FileStore`` at ``STORE`` (gloo on the CPU, one
intra-op thread each), run the jobs of ``JOBS.pkl`` in order and write
their results to ``OUT.pkl`` with the rank appended.  Each job is a dict
with a ``"kind"`` (the functions below) and its inputs, numpy arrays and
trees in ``lbt_tpu``'s layout.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch_suite  # noqa: F401  (one intra-op thread, here and in ranks)

from lbt_tpu_torch import config as tconfig
from lbt_tpu_torch import convert
from lbt_tpu_torch.models import cifar10_resnet
from lbt_tpu_torch.nn.layers import (AvgPool, Conv2d, Dense, Flatten,
                                    GradientBuffer, ReLU)
from lbt_tpu_torch.nn.model import Model
from lbt_tpu_torch.nn.norm import BatchNorm
from lbt_tpu_torch.parallel import (Group, gather_params,
                                    init_error_buffers, lowbit_allreduce,
                                    make_dp_train_step, make_groups,
                                    param_pspecs, ring_lowbit_allreduce,
                                    shard_model)
from lbt_tpu_torch.train import checkpoint as ckpt
from lbt_tpu_torch.train.optim import momentum_init
from lbt_tpu_torch.train.step import make_masked_eval_step, make_train_step
from lbt_tpu_torch.train.trainer import Trainer

WD = 2e-4
_REPO = str(Path(__file__).resolve().parent.parent)


def rank_env() -> dict:
    """The environment of a rank process: the test process's (one
    intra-op thread, from :mod:`torch_suite`), the repo importable, no
    launcher's variables."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def start_ranks(tmp: Path, jobs: dict, world: int):
    """Start ``world`` rank processes on ``jobs`` (pickled under
    ``tmp``); returns a function that waits for them and gives each
    rank's results."""
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp / "jobs.pkl"), str(r),
         str(world), str(tmp / "store"), str(tmp / "out.pkl")],
        env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]

    def wait(timeout=240):
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
        out = []
        for r in range(world):
            with open(tmp / f"out.pkl.{r}", "rb") as f:
                out.append(pickle.load(f))
        return out

    return wait


WIDTHS = ("bits_w", "bits_a", "bits_b", "bits_g")


def quant_config(bits: int, kw: dict, qc=tconfig.QuantConfig):
    """``qc.uniform(bits, **kw)`` with the widths in ``kw`` (which
    ``uniform`` sets itself) replaced after; ``qc`` is the port's
    ``QuantConfig`` or ``lbt_tpu``'s."""
    kw = dict(kw)
    widths = {k: kw.pop(k) for k in WIDTHS if k in kw}
    return dataclasses.replace(qc.uniform(bits, **kw), **widths)


def build(spec: dict) -> Model:
    """The model of a job: ``{"kind": "resnet8", "cfg": {...}}`` (the
    CIFAR ResNet-8 under ``uniform(spec.get("bits", 8), **cfg)``, a
    width in ``cfg`` replacing uniform's (:func:`quant_config`), weight
    decay 2e-4), ``"bnnet"`` (a conv, a BatchNorm, a Dense on 8x8x3
    inputs), ``"toy"`` (``tests/test_parallel.py``'s two Dense layers) or
    ``"gbnet"`` (the toy with a GradientBuffer of a rank's 4 rows between
    them), initialized from seed 0.  The tensor-parallel twins:
    ``"tp_toy"`` (``tests/test_parallel.py``'s 20-256-128-4 Dense toy,
    its 256 x 128 layer sharded), ``"tp_toy130"`` (the same with a 256 x
    130 layer, uneven over 4) and ``"tp_convtoy"`` (its conv toy, a
    3x3x64x64 conv fused with its BN sharded)."""
    cfg = quant_config(spec.get("bits", 8), spec["cfg"])
    if spec["kind"] == "resnet8":
        model = cifar10_resnet(cfg, 8, weight_decay=WD)
    elif spec["kind"] in ("tp_toy", "tp_toy130"):
        n = 130 if spec["kind"] == "tp_toy130" else 128
        model = Model(spec["kind"], [
            Dense("d1", cfg, 20, 256), ReLU(), Dense("d2", cfg, 256, n),
            ReLU(), Dense("d3", cfg, n, 4)],
            input_shape=(20,), num_classes=4, cfg=cfg)
    elif spec["kind"] == "tp_convtoy":
        model = Model("convtoy", [
            Conv2d("c1", cfg, (3, 3, 3, 64), use_bias=False),
            BatchNorm("bn1", cfg, 64), ReLU(),
            Conv2d("c2", cfg, (3, 3, 64, 64), use_bias=False),
            BatchNorm("bn2", cfg, 64), ReLU(),
            AvgPool(ksize=(8, 8), strides=(8, 8)), Flatten(),
            Dense("fc", cfg, 64, 4)],
            input_shape=(8, 8, 3), num_classes=4, cfg=cfg)
    elif spec["kind"] == "bnnet":
        model = Model("bnnet", [
            Conv2d("c1", cfg, (3, 3, 3, 8), use_bias=False), BatchNorm(
                "bn", cfg, 8), ReLU(), Flatten(), Dense("d", cfg, 512, 4)],
            input_shape=(8, 8, 3), num_classes=4, cfg=cfg)
    else:
        mid = ([GradientBuffer("gb", cfg, (4, 64))]
               if spec["kind"] == "gbnet" else [])
        model = Model(spec["kind"], [Dense("d1", cfg, 20, 64), *mid, ReLU(),
                                     Dense("d2", cfg, 64, 4)],
                      input_shape=(20,), num_classes=4, cfg=cfg)
    return model.init(torch.Generator().manual_seed(0))


def _np(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def collectives(job, group):
    """Every transport of the low-bit all-reduce on this rank's leaves."""
    grads = {k: torch.from_numpy(v) for k, v in
             job["grads"][group.rank].items()}
    bufs = {k: torch.from_numpy(v) for k, v in
            job["bufs"][group.rank].items()}
    out = {}
    for name, (wire, reduce) in job["variants"].items():
        if wire is None:
            g, r = lowbit_allreduce(grads, bufs, group, bits=8,
                                    reduce=reduce)
        else:
            g, r = ring_lowbit_allreduce(grads, bufs, group, bits=8,
                                         wire=wire, reduce=reduce)
        out[name] = (_np(g), _np(r))
    return out


def dp_steps(job, group):
    """A DP step on each of ``job["data"]``'s global batches (this rank's
    rows) from the model's init; the state after each, with the running
    count of statistics collectives."""
    model = build(job["model"])
    init = convert.to_jax_numpy(model)
    vel = momentum_init(dict(model.net.named_parameters()))
    ebuf = init_error_buffers(dict(model.net.named_parameters()))
    step = make_dp_train_step(model, tconfig.TrainConfig(), group,
                              lowbit_bits=job.get("lowbit_bits"),
                              lowbit_wire=job.get("lowbit_wire"))
    per = job["batch"] // group.world
    rows = slice(group.rank * per, (group.rank + 1) * per)
    out = []
    for s, (x, y) in enumerate(job["data"]):
        m = step(model, vel, ebuf, torch.from_numpy(x[rows]),
                 torch.from_numpy(y[rows]), s, job["lr"],
                 np.asarray(job["key"], np.uint32))
        p, q, v, e = convert.to_jax_numpy(model, vel, ebuf)
        out.append({"loss": m["loss"].item(), "acc": m["accuracy"].item(),
                    "params": p, "qstate": q, "velocity": v, "ebuf": e,
                    "stats_calls": group.by_kind.get("stats", [0, 0])[1]})
    return {"init": init, "steps": out}


def sub_layout(data: int, model: int):
    """``(data group, model group)`` of this rank in a ``data x model``
    layout of the world's first ``data * model`` ranks (``mesh.
    make_groups``' order), or ``(None, None)`` outside it; every rank
    calls it."""
    if data * model == dist.get_world_size():
        return make_groups(data, model, "cpu")
    grid = np.arange(data * model).reshape(data, model)
    mine = {}
    for axis, lines in (("model", list(grid)), ("data", list(grid.T))):
        for line in lines:
            pg = dist.new_group([int(r) for r in line])
            if dist.get_rank() in line:
                mine[axis] = pg
    if not mine:
        return None, None
    return (Group(mine["data"], device="cpu"),
            Group(mine["model"], device="cpu"))


def tp_steps(job, group):
    """Train steps on each of ``job["data"]``'s global batches from the
    model's init on a ``job["layout"]`` ``(data, model)`` layout of the
    first ranks (``make_dp_train_step`` with the model cut by
    ``shard_model``), or with ``job["single"]`` the one-rank
    ``make_train_step`` on rank 0; the whole state after each step
    (sharded leaves gathered), and the model group's collectives by
    kind."""
    d, m = job.get("layout", (1, 1))
    data_g, model_g = sub_layout(d, m)
    if data_g is None:
        return None
    model = build(job["model"])
    init = convert.to_jax_numpy(model)
    specs = param_pspecs(init[0])
    tp = None
    if m > 1:
        shard_model(model, model_g)
        tp = model_g
    params = dict(model.net.named_parameters())
    vel, ebuf = momentum_init(params), init_error_buffers(params)
    tc = tconfig.TrainConfig()
    if job.get("single"):
        one = make_train_step(model, tc)

        def step(model, vel, ebuf, *a):
            return one(model, vel, *a)
    else:
        step = make_dp_train_step(model, tc, data_g,
                                  lowbit_bits=job.get("lowbit_bits"),
                                  lowbit_wire=job.get("lowbit_wire"), tp=tp)
    per = job["batch"] // d
    rows = slice(data_g.rank * per, (data_g.rank + 1) * per)
    out = []
    for s, (x, y) in enumerate(job["data"]):
        r = step(model, vel, ebuf, torch.from_numpy(x[rows]),
                 torch.from_numpy(y[rows]), s, job["lr"],
                 np.asarray(job["key"], np.uint32))
        p, q, v, e = convert.to_jax_numpy(model, vel, ebuf)
        if tp is not None:
            p, v, e = (gather_params(t, specs, tp) for t in (p, v, e))
        out.append({"loss": r["loss"].item(), "acc": r["accuracy"].item(),
                    "params": p, "qstate": q, "velocity": v, "ebuf": e})
    return {"init": init, "steps": out, "specs": specs,
            "kinds": None if tp is None else dict(tp.by_kind)}


def masked_eval(job, group):
    """``Trainer._evaluate_dp``'s sums through ``make_masked_eval_step``:
    this rank's rows of each padded eval batch at its ``row0``."""
    model = build(job["model"])
    convert.from_jax_numpy(model, job["params"], job["qstate"])
    step = make_masked_eval_step(model, faithful_eval=job["faithful"])
    x, y, eb = job["x"], job["y"], job["eval_batch"]
    per = -(-eb // group.world)
    sums = []
    for lo in range(0, len(x), eb):
        xb, yb = x[lo:lo + eb], y[lo:lo + eb]
        n = len(xb)
        pad = per * group.world - n
        xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
        yb = np.concatenate([yb, np.zeros((pad,), yb.dtype)])
        r0 = group.rank * per
        m = step(model, torch.from_numpy(xb[r0:r0 + per]),
                 torch.from_numpy(yb[r0:r0 + per]), n,
                 np.asarray(job["key"], np.uint32), dist=group, row0=r0)
        sums.append(torch.stack([m["loss_sum"], m["correct_sum"]]))
    total = group.all_reduce(torch.stack(sums)).tolist()
    return {"loss": sum(v[0] for v in total) / len(x),
            "accuracy": sum(v[1] for v in total) / len(x)}


def trainer(job, group):
    """The port's Trainer on ``job``'s synthetic CIFAR-10 (augmented if
    ``job["augment"]``), ResNet-8 from ``tc.seed``: ``train()`` (with its checkpoints), or
    ``epochs`` epochs then an eval, or only ``maybe_restore()``.  Each
    rank logs under ``logdir`` with ``{rank}`` filled in; the checkpoint
    saves this rank made are counted."""
    from lbt_tpu_torch.data.datasets import load_dataset, make_augment
    data = load_dataset("cifar10", n_train=job["n_train"],
                        n_test=job["n_test"])
    cfg = tconfig.QuantConfig.uniform(8, **job["cfg"])
    tc = tconfig.TrainConfig(data_parallel=True, **job["tc"])
    logdir = job.get("logdir")
    tr = Trainer(cifar10_resnet(cfg, 8, weight_decay=WD), tc, data,
                 augment=make_augment("cifar10") if job.get("augment")
                 else None,
                 logdir=logdir and logdir.format(rank=group.rank),
                 device="cpu", group=group)
    saves = []
    real_save = ckpt.save_checkpoint
    with mock.patch.object(ckpt, "save_checkpoint",
                           lambda *a, **k: (saves.append(a[1]),
                                            real_save(*a, **k))):
        if job.get("restore_only"):
            tr.maybe_restore()
            ev = None
        elif job.get("train"):
            ev = tr.train()
        else:
            for e in range(job["epochs"]):
                tr.train_epoch(e)
            ev = tr.evaluate()
    p, q, v, *e = convert.to_jax_numpy(tr.model, tr.velocity, tr.ebuf)
    e = e[0] if tr.ebuf is not None else None
    # the whole state, as a checkpoint holds it (a collective under
    # tensor parallelism), each rank's own ebuf
    state = {k: {kk: vv.detach().numpy().copy() for kk, vv in t.items()}
             for k, t in tr._state().items() if isinstance(t, dict)}
    tr.metrics.close()
    return {"eval": ev, "params": p, "qstate": q, "velocity": v,
            "ebuf": e, "step": tr.step, "saves": saves, "state": state,
            "scanned": tr.scan_train_step is not None,
            "layout": None if tr.tp is None else (
                None if tr.group is None else tr.group.world, tr.tp.world)}


def main(argv) -> None:
    jobs_path, rank, world, store, out_path = argv
    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    group = Group(device="cpu")
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    kinds = {"collectives": collectives, "dp_steps": dp_steps,
             "masked_eval": masked_eval, "trainer": trainer,
             "tp_steps": tp_steps}
    out = {name: kinds[job["kind"]](job, group)
           for name, job in jobs.items()}
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
