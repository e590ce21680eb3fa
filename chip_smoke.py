#!/usr/bin/env python3
"""Smoke run of lbt_tpu_torch on one NVIDIA GPU: serve and train DFXP-INT8
ResNet-20, under ``noise_impl='unsafe_rbg'`` keys too (XLA's Philox stream
in K1 and #4/#5), the last through the port's Trainer and CLI (main.py's
defaults among its runs), then train and serve the bench headline,
ResNet-50 at 224 px and batch 128, train the bench's baseline leg at the
same size, train ResNet-20 and the headline under the BN memory options
``remat_bn`` and ``bn_residual_q16``, train VGG-16 / CIFAR-100 under
int4w-int8a and serve it folded and exported, train the reference's
small models through the CLI, train the
headline through the CLI from TFRecord shards and an ImageFolder tree of
ImageNet-like JPEGs, ResNet-20 through the C++ loader, with ``--debug_nans``
checked, train data parallel on ``torch.distributed``: two ranks
sharing the card, NCCL at world size 1, the CLI under torchrun, and
train tensor parallel: the headline's large weights in column slices
over two ranks, a 2 x 2 data x model layout, the CLI with
``--tensor_parallel 2``.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--out details.json]

Phases; each raises on failure, and the script then prints
``chip_smoke: FAILED in phase <name>`` with the traceback on stderr (and
the line on stdout) and exits 1, with no result line.

1. device  needs CUDA; prints the card's name and power limit; TF32 off;
           reads the SM count and maximum SM clock for the issue rate
           (4 warp instructions an SM a clock) that bounds the noise's
           integer work.
2. build   builds K1, K2 and kernels #4/#5 (a source a noise kind: none
           and the hashes, threefry, Philox) from the sources in the
           checkout (one nvcc per source, started together, sm_90a, each
           followed in its thread by its IMMA count); prints the seconds
           each took
           and each kernel's registers, shared memory and spills (ptxas
           -v) and, for K2 and #4/#5, its count of IMMA (int8
           tensor-core) instructions in the SASS ("not available"
           without cuobjdump).
3. K1      quantize kernel vs its plain PyTorch version on the card,
           bitwise (codes and the multiplier it builds from the
           exponent), at every quantize shape of the serving path (batch
           128) and at odd sizes (n not a multiple of 4 among them); bits
           8 and 9; deterministic, both counter-hash stochastic modes and
           threefry (``noise_mode='prng'``), threefry and the hash also
           drawn once along axis 0.  Its library yardstick is
           ``torch.quantize_per_tensor(x, 1/mult, 0, qint8)`` for the
           path's 8-bit calls, which must give the same codes; each path
           shape is timed again with threefry noise, beside its bound
           (by operations).
4. K2      int8 GEMM vs its plain version, bitwise, at every GEMM shape
           of the serving path (each conv's im2col product, the head).
           K1 and K2 are timed per shape from CUDA graphs that rotate
           over enough input copies to overflow the L2 cache, so their
           operands come from device memory (see ``device_ms``).
5. serve   CIFAR10_Resnet20 under QuantConfig.uniform(8), random weights
           from a seed, on the card.  A Predictor answers 8 requests of
           128 images with every launch counter reset just before; each
           kernel must have launched.  Logits must match the same weights
           served on the CPU (plain route) at rtol = atol = 1e-5, with
           equal labels.  Times the kernel route against the plain route
           on the card (in turns), each kernel against its plain version
           at the path's shapes, and takes a profiler window that also
           gives each kernel's device time as the serving path runs it.
6. train shapes  one training step of CIFAR10_Resnet20 under
           uniform(8, noise_mode='hash') at batch 128 records every call
           of K1 (with its min/max output), K2 (both forms), #4/#5 and
           the conv backward's dgrad and wgrad.
7. K1-stats, K2-train, fused, conv-bwd  each of those calls' shapes: the
           kernel vs
           its plain version, bitwise (codes, min/max, int64 sums,
           moments; K1 and #4/#5 also with threefry noise), timed as in
           3-4, per training step (K1 and #4/#5 again with threefry in
           place of the hash: the step under main.py's default noise),
           beside each
           call's roofline bound (``ops.kernels.work``: bytes over 3.35
           TB/s or ops over the peak of their type, whichever is larger)
           and one PyTorch call's time on the same inputs where one
           computes the same function: ``torch._int_mm`` for K2 (its X^T.g
           form one call per 2**16-row chunk; shapes it refuses padded to
           the nearest it takes, and the row says so); for #4/#5 cuDNN's
           fp16 channels-last ``conv2d`` of the same codes, the conv alone
           (``conv_lib_ms``); none for the step's K1 calls, stochastic or
           9-bit.  dgrad and wgrad are also held bitwise against the
           im2col route they replaced (K2 over im2col patches of the
           zero-dilated cotangent or of x) and timed beside it
           (``old_ms``), with cuDNN's fp16 dgrad / wgrad alone as the
           library yardstick (``lib_ms``).
8. train   ResNet-20 at batch 128, weights from seed 0, data from a numpy
           seed: 4 steps through the kernels (every launch counter reset
           just before and required to rise) and the same 4 steps through
           the plain versions on the card from the same start, under
           deterministic algorithms: losses finite and equal, parameters,
           velocity, exponents and BN state equal (tolerance 0).  The
           first step's loss must match the CPU route at rtol 1e-5.  Then
           ms per step of both routes in turns and a profiler window, in
           which K1 and #4/#5 must have made one device launch for each
           call of their wrappers (and run no other kernel of theirs);
           device launches a step, beside the count measured before K1
           took the multiplier and the min/max into its one launch.
9. rbg     ``benchmarks/ablate.py:90-91``'s ``rbg-int8``: ResNet-20 at full
           width and depth, batch 512 (its ``--batch``), under
           uniform(8, int8, prng) with ``noise_impl='unsafe_rbg'`` keys:
           K1 and #4/#5 draw XLA's Philox4x32-10 stream (mode 4).  Gate:
           2 steps through the kernels (counters reset just before; K1,
           #4 and #5 each launched, in mode 4 only) equal to the same 2
           through the plain versions in every tensor (tolerance 0); step
           0 at batch 32 on the card and on the CPU: loss at rtol 1e-5,
           every exponent equal.  Then 4 steps beside 4 of ablate's
           ``prng-int8`` (threefry) in turns: median host ms a step; a
           2-step profile of each (busy share, device launches a step,
           each kernel's device ms, one launch a K1 and #4/#5 call).
           Then K1 and #4/#5 at the step's shapes as in 7 (fewer
           repetitions), each stochastic check in modes 0, 3 and 4 and
           at the counter offset ``CHECK_ROW0``, with the bound by mode
           4's instructions and, as a yardstick of the generator alone,
           ``torch.rand`` of as many uniforms on the card's own Philox
           (another stream, nothing quantized), beside each kernel's
           device ms a step in the two legs' profiles (threefry: the
           prng-int8 leg's); and mode 4's offset and column-window forms
           against the plain versions at a data-parallel eval rank's and
           a tensor-parallel rank's shapes.
10. trainer ``python -m lbt_tpu_torch.main``'s ``main`` in-process, the
           user's entry point: ResNet-20 at batch 128, 2560 synthetic
           CIFAR images (20 steps an epoch), 2 epochs with an LR decay at
           1, augmentation on, batch-statistic eval (--faithful_eval), every
           launch counter reset just before (K1, K2's two forms, #4 and #5
           must each launch).  The logged loss must fall and the test
           accuracy pass TRAINER_MIN_ACC.  A second
           directory runs 1 epoch, then 2, resuming: its final parameters,
           buffers and velocity must equal the first run's bit for bit.
           The first run's checkpoint, restored on the CPU, must evaluate
           its first 250 test images as the card does (rtol 1e-5).
           Prints epoch 2's img/s, the input
           stall share, eval ms per batch, checkpoint save / restore ms.
           Then main.py's defaults: the same command line without
           ``--noise_mode`` (``prng``, threefry), 1 epoch, every counter
           reset just before; each kernel launched, K1 and #4/#5 in
           threefry mode.  Then ``--scan_steps 4`` for 10 steps (two
           blocks of 4, then 2 steps one by one; every counter reset just
           before, each kernel launched) beside the same 10 steps without
           it: final states equal bit for bit, train rows at the steps
           ``lbt_tpu`` writes (step 8 at ``--log_every 5``).  Then the
           FP32 arm (``--bits 32``, engine ``sim``): 2 ResNet-20 steps on
           the card and on the CPU, losses equal at rtol 1e-5.
           Logs and metrics stay under experiments/smoke_trainer.
11. resnet50  ``Imagenet_Resnet50`` at full width and depth, 224 px,
           batch 128, weights from a seed, seeded images with labels in
           0..999, under ``bench.py``'s headline (uniform(8, int8, hash1),
           fused BN, controllers every 8th step, bf16 carriers, 8-bit conv
           activations), deterministic algorithms on, TF32 off.  Gate: 2
           steps (controllers on, off) through the kernels, every
           launch counter reset just before and each required to rise,
           equal to the same 2 steps through the plain versions in every
           tensor (tolerance 0); the first loss at batch 8 equal to the CPU
           route's at rtol 1e-5.  Then 8 timed steps at the bench's
           cadence (median ms, img/s, ``max_memory_allocated``), a 2-step
           profile (busy share, device launches a step, one launch a K1
           and #4/#5 call), and every kernel at the step's shapes as in 7
           (calls of a step weighted 1/8 controllers-on, 7/8 off; fewer
           repetitions; K1 and #4/#5 checked in the path's mode at
           offset 0 only; K2's X^T.g library calls once a shape).  Serving: a
           ``Predictor`` at batch 128, K1 and K2 launched, logits and
           labels of the kernel route equal to the plain route's; ms a
           request of both routes.  Prints the phase's seconds.
12. baseline50  ``bench.py:305``'s baseline leg: ``Imagenet_Resnet50``
           at 224 px, batch 128, under uniform(8, engine="sim_bf16",
           noise_mode="prng") (f32 carriers, unfused BN, 9-bit conv
           activations, controllers every step; K1 in threefry mode at
           every site, bf16 contractions through cuDNN / cuBLAS),
           deterministic algorithms on, TF32 off.  Gate: 2 steps through
           the kernels (counters reset just before; every K1 call in
           threefry mode) equal to the same 2 steps through the plain
           versions in every tensor; the first loss at batch 8 equal to
           the CPU route's at rtol 1e-5.  Then 4 timed steps (median ms,
           img/s, ``max_memory_allocated``), a 2-step profile (busy share,
           device launches a step, one launch a K1 call, K1's device ms a
           step) and K1 at every call shape of the step against its bound
           (checked in threefry mode at offset 0 only).
           Then the headline's img/s over this phase's: the port's first
           reading of ``bench.py``'s ``vs_baseline``.
13. remat  the BN memory options ``remat_bn`` and ``bn_residual_q16``
           (deterministic algorithms on).  (a) ResNet-20 at batch 128
           under uniform(8, noise_mode='hash') (f32 carriers, unfused BN,
           where both flags save codes in place of f32 activations and
           q16 rounds the BN input's cotangent to bf16): the flags off,
           then each flag, 2 steps through the kernels (counters reset
           just before, each kernel launched) equal to the plain route's
           in every tensor; remat_bn's state equal to the flags-off
           state and q16's first loss to the flags-off one; the last
           step's host ms and peak memory.  (b) the headline under
           bn_residual_q16, then remat_bn, then with the flags off: 2
           steps through the kernels, each equal in every tensor to phase
           resnet50's gate steps (bf16 carriers, fused BN: neither flag
           changes a bit); the second step's host ms and peak memory.
14. vgg16  configuration V: ``VGG16_CIFAR100`` at full width and depth,
           batch 256, under ``benchmarks/vgg_bench.py``'s ``int4w-int8a``
           (uniform(8, int8, hash) with 4-bit weights: 8-bit biases, BN
           parameters and gradients, 9-bit conv activations, unfused BN,
           controllers every step), weights from a seed, seeded images
           with labels in 0..99, deterministic algorithms on, TF32 off.
           As resnet50: 2 steps through the kernels (counters reset just
           before; K1, K2's two forms and #4 each launched) equal to the
           plain route in every tensor, the first loss at batch 8 equal
           to the CPU's, 8 timed steps, peak memory, a 2-step profile,
           and K1, K2, #4, dgrad and wgrad at V's shapes beside their
           bounds and library calls; the Dropout mask against the CPU's (f32, bf16)
           and its device ms.  Then a ``Trainer`` on V's config trains
           one epoch of 10 steps (counters reset just before, each
           kernel launched, losses finite), and its
           checkpoint is served by ``Predictor.from_checkpoint(...,
           fold_bn=True)``: K1 and K2 launched, logits equal to the folded
           model's plain route bitwise, the export's bytes against f32
           (at most 0.3 of them), the restored export serving the same
           logits; the share of labels the folded and unfolded models
           agree on (recorded, not gated) and ms a request of 128.
15. zoo    ``lbt_tpu_torch.main`` on the card, 4 steps of 128 and an eval
           each, counters reset just before: ``PI_MNIST``, ``MNIST`` and
           ``CIFAR10`` under main.py's defaults (prng, dropout keep 0.5),
           ``CIFAR10_VGG --bits_w 4 --bits_a 8`` and ``CIFAR10_Resnet20
           --gradient_buffer --noise_mode hash``; losses finite, each
           kernel of the path launched (K1 in threefry mode under prng),
           the gradient buffers nonzero.
16. records  first probes ``g++``, libjpeg (``jpeglib.h`` through ``g++
           -E``, ``-ljpeg`` linking) and PIL; a leg whose prerequisite is
           missing does not run, and a line says so.  Writes 1,280
           training and 300 validation images from a seed (short side
           333-500 px, aspect 3/4-4/3, JPEG quality 90, about 100 KB each,
           labels over 1,000 classes) as 4 + 1 TFRecord shards and as an
           ImageFolder tree (one worker process a shard), times each
           source alone at 224 px and batch 128 (img/s beside the CPU
           count), then runs ``lbt_tpu_torch.main`` under the headline's
           flags for 1 epoch (10 steps) and an eval from each, and from
           1,280 in-memory synthetic images (the control): counters
           reset just before and each kernel launched, finite logged
           losses, every eval covering all 300 images in a ragged batch;
           img/s, the input-stall share, median ms between step returns
           beside phase resnet50's ms a step, eval ms, pinned host blocks
           created; then 2 steps on the run's source in a profiler window
           (each kernel's device ms, one launch a K1 and #4/#5 call).  Then
           the trainer phase's ResNet-20 command line with
           ``--native_loader`` (1 epoch; the loss falls), and
           ``--debug_nans``: ResNet-20 (10-way head) from the 1000-class
           tree raises FloatingPointError at step 0, without the flag logs
           NaN losses and finishes; a clean run with it finishes.  The data
           is deleted after.
17. dp     data parallelism (``lbt_tpu_torch.parallel``).  (b) in this
           process: 2 ResNet-20 steps of ``make_dp_train_step`` over an
           NCCL group of world size 1, plain and with the low-bit
           all-reduce's psum transport and both rings, each equal bit for
           bit to the same steps over a gloo group of world size 1 on the
           card.  Then 2 rank processes (``chip_smoke.py --dp-worker``,
           ``parallel.initialize``: gloo, the ranks share the card):
           (a) ResNet-20 under uniform(8, noise_mode='hash'), global batch
           128 (64 a rank), 2 steps through the kernels (counters reset
           just before, each required to rise) equal to the same 2
           through the plain versions and to the other rank in every
           tensor (deterministic algorithms, tolerance 0), the first loss
           against the 2-rank CPU route at rtol 1e-5, then 2 steps with
           each low-bit transport (losses finite, ranks equal); (c) the
           headline (phase resnet50's config) at 2 x 64 with the low-bit
           all-reduce: 3 steps, then 1 timed one: ms a step
           (two ranks sharing one card: not a scaling number), host ms
           and calls a step in collectives, kernel launches a step, each
           rank's peak memory; the ranks' states equal; then the low-bit
           bucket's wires alone (the int32 all-reduce, one int16 and one
           int8 ring hop), host ms.  (d) ``python -m
           torch.distributed.run --nproc_per_node 2 -m lbt_tpu_torch.main
           --data_parallel --lowbit_allreduce`` on ResNet-20, 1 epoch of
           10 steps and an eval of 300 (a padded, ragged batch), then a
           run to 2 epochs that resumes: exit 0, rank 0 alone logging.
           Phases K1-stats and fused also run each stochastic check at a
           non-zero noise counter offset (``CHECK_ROW0``).
18. tp     tensor parallelism (``parallel.mesh``), the ranks sharing the
           card over gloo (``chip_smoke.py --tp-worker``, a data x model
           layout by ``parallel.make_groups``).  (a) the headline (phase
           resnet50's config, batch 128) at tp = 2 in 2 ranks: the
           one-rank step on the model cut by ``shard_model``, phase
           resnet50's 2 gate steps (counters reset just before, K1, K2
           and #4/#5 each required to launch; the calls recorded) equal
           to phase resnet50's one-rank kernel route in every tensor (the
           sharded ones gathered; tolerance 0) and on both ranks; the
           last gate step (controllers off) timed: ms a step a rank, the
           model group's host ms, calls and MB a step by kind (gather:
           the joins; dx: the partial dx sums; stats: the controllers'
           min / max), peak memory, launches a step.  (d) configuration
           A (phase baseline50's config: sim_bf16 + prng, the float
           route) at tp = 2 in 2 ranks, its 46 large weights in column
           slices: phase baseline50's 2 gate steps from its seed, weights
           and batches (K1 required to launch, in threefry mode at every
           call; the calls recorded; the last step timed as (a)'s), the
           ranks' state equal bitwise; against phase baseline50's steps,
           step 0's loss at rtol 1e-5, the exponents after it bitwise and
           every parameter leaf within 0.1 relative L2 after step 0 and
           after the gate.
           (b) ResNet-20 at 2 x 2 in 4 ranks with the low-bit
           all-reduce: 3 steps through the kernels equal
           to the plain route on every rank in every tensor, and (c)
           ``torch.distributed.run --nproc_per_node 2 -m
           lbt_tpu_torch.main --data_parallel --tensor_parallel 2`` on
           ResNet-20, 1 epoch of 10 steps and an eval, then a run to 2
           that resumes; (b) and (c) side by side.  Then each kernel's
           column-window form (K1 at the sharded weights, #4/#5 at the
           sharded convs' BN inputs) at (a)'s shapes against its plain
           version bitwise (rank 0's window and the last rank's, that one
           at the counter offset ``CHECK_ROW0``), and K2 at the shapes a
           one-rank step does not have, timed with bounds and library
           calls as in 7; then K1 in threefry mode at (d)'s windowed
           calls, the same way.

Prints the card, then one JSON line of kernels (launches from the trainer
phase, the threefry rows' from its run of main.py's defaults, the rbg
rows' from phase rbg's counted steps; ms,
plain_ms, bound_ms and library_ms a training step; the same keys under
``resnet50`` for the headline's path, under ``baseline50`` for the
baseline's K1, under ``vgg16`` for V's, and under ``records`` the
launches of each CLI run of phase records, under ``dp`` rank 0's launches
in phase dp, under ``tp`` rank 0's in phase tp leg (a) and the
column-window forms' times, under ``tp_baseline50`` K1's in leg (d)),
then, last, one JSON line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import faulthandler
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

# cuBLAS (the plain versions' float64 GEMMs) is deterministic only with a
# fixed workspace; set before the first CUDA call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parent
BATCH = 128
N_REQUESTS = 8
SEED = 0
TOL = dict(rtol=1e-5, atol=1e-5)
# device launches a training step and a serving request with the Triton K1
# (two launches a call with min/max) and the multiplier built in torch ops
# at every quantize site (PERF.md section 5)
LAUNCHES_BEFORE = {"step": 11343, "request": 1845}


# what phase_device reads on the card: the issue rate the noise's
# instructions are bounded by
CARD = {}

# the noise of a timed or compared call of each mode: fixed key words
# (an unsafe_rbg key's other two beside them)
NOISE_K0, NOISE_K1 = 0x5DEECE66, 0x2545F491
NOISE_K2, NOISE_K3 = 0x9ABCDEF0, 0xFFFFFFFF


def noise_of(quant, mode: int, shape, shared: bool = False,
             row0: int = 0):
    """The :class:`Noise` of ``mode`` (0: None) for a tensor of
    ``shape``, drawn once along axis 0 with ``shared``; ``row0`` places
    its rows in a larger batch's draw (the counter's offset, as a
    data-parallel eval rank draws)."""
    if not mode:
        return None
    inner = math.prod(shape[1:]) if shared else 0
    offset = 0 if shared else row0 * math.prod(shape[1:])
    noise = quant.Noise(mode, NOISE_K0, NOISE_K1, inner, offset)
    if mode == quant.RBG:
        noise = noise._replace(k2=NOISE_K2, k3=NOISE_K3)
    return noise


# the row a compared call's slice starts at in its global batch: every
# stochastic check of K1 and #4/#5 runs again at this counter offset
CHECK_ROW0 = 3


def noise_key(noise) -> tuple:
    """``(mode, shared)`` of a call's noise, as the recorders key it."""
    return (0, False) if noise is None else (noise.mode, noise.inner > 0)


MODE_NAMES = {0: "rn", 1: "hash", 2: "hash1", 3: "threefry", 4: "rbg"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rotating_inputs(args, nbytes: int, max_copies: int = 64) -> list:
    """Device copies of ``args`` (tensors), enough that calls cycling
    over them touch at least four times the L2 cache (``nbytes`` = bytes
    one call reads and writes) before a copy comes round again; at most
    ``max_copies``, so the smallest shapes stay L2-resident."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n = max(1, min(max_copies, math.ceil(4 * l2 / nbytes)))
    return [tuple(a.clone() for a in args) for _ in range(n)]


def eager_ms(fn, sets, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn(*set)`` launched eagerly from the host,
    cycling over the input ``sets``, in ms (CUDA events around the
    calls): device time plus whatever launch gaps the host leaves."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    n = max(reps, len(sets))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, sets, reps: int = 20, replays: int = 5) -> float:
    """Mean device time per call of ``fn(*set)`` in ms: calls cycling
    over the input ``sets`` captured in one CUDA graph and replayed, so
    host launch cost drops out, and (by :func:`rotating_inputs`) the
    operands of each call were last touched four L2 sizes earlier.  The
    warm-up runs on the capturing stream, so per-stream scratch (K1's
    ticket) exists before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    n = max(reps, len(sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(n):
            fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


# calls captured and graph replays of each timing: (kernel, plain,
# library); ``FAST_REPS`` for the ResNet-50 shapes, whose plain versions
# (float64 GEMMs of GB-sized im2cols) take up to a second a call
REPS = ((20, 5), (20, 5), (20, 5))
FAST_REPS = ((10, 3), (1, 1), (4, 2))
# ResNet-50's K2 shapes: the library's X^T.g calls (hundreds of ms at the
# stem) captured and replayed once
R50_K2_REPS = ((10, 3), (1, 1), (1, 1))


def _timings(fn, plain_fn, args, nbytes: int, work=None, lib=None,
             reps=REPS) -> dict:
    """Device ms of ``fn`` and of ``plain_fn``; eager ms of both (not
    with ``FAST_REPS``); ``work``'s bound; ``lib = (fn, args, note)``'s
    device ms."""
    sets = rotating_inputs(args, nbytes)
    out = {"ms": device_ms(fn, sets, *reps[0]),
           "plain_ms": device_ms(plain_fn, sets if reps is REPS
                                 else sets[:1], *reps[1]),
           "input_copies": len(sets)}
    if reps is REPS:
        out.update(eager_ms=eager_ms(fn, sets),
                   plain_eager_ms=eager_ms(plain_fn, sets))
    if work is not None:
        out.update(bytes=work.bytes, ops=work.ops, bytes_ms=work.bytes_ms,
                   ops_ms=work.ops_ms, bound_ms=work.bound_ms,
                   bound_by=work.bound_by)
    if lib is not None:
        lib_fn, lib_args, note = lib
        try:
            out["lib_ms"] = device_ms(lib_fn, rotating_inputs(lib_args,
                                                              nbytes),
                                      *reps[2])
        except RuntimeError as e:  # a yardstick only: say why it is missing
            out["lib_ms"], note = None, f"failed: {str(e)[:160]}"
        out["lib_note"] = note
    return out


def _per_forward(rows) -> dict:
    """Per forward / step: each time key summed over the rows (calls x
    per-call value; None where a row lacks it), the launches, and what
    bounds the sum."""
    out = {}
    for k in ("ms", "plain_ms", "eager_ms", "plain_eager_ms", "bound_ms",
              "lib_ms"):
        vals = [r.get(k) for r in rows]
        out[k] = (None if not rows or any(v is None for v in vals)
                  else sum(r["calls"] * v for r, v in zip(rows, vals)))
    out["launches"] = sum(r["calls"] for r in rows)
    if out["bound_ms"] is not None:
        by_bytes = sum(r["calls"] * r["bytes_ms"] for r in rows)
        by_ops = sum(r["calls"] * r["ops_ms"] for r in rows)
        out["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return out


def _pad_to(t, shape):
    """``t`` zero-padded at the end of each dim to ``shape``."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _int_mm_shape(m: int, k: int, n: int) -> tuple:
    """The nearest shape ``torch._int_mm`` takes: M > 16, K and N
    multiples of 8."""
    return max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8


def lib_gemm(a, b):
    """``(fn, args, note)``: ``torch._int_mm(a, b)`` (int32 out; K2's f32
    scale is not in it), on operands padded where it needs that."""
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = _int_mm_shape(m, k, n)
    note = (None if (mp, kp, np_) == (m, k, n)
            else f"padded to M{mp} K{kp} N{np_}")
    return (torch._int_mm, (_pad_to(a, (mp, kp)), _pad_to(b, (kp, np_))),
            note)


def lib_gemm_tn(a, b, chunk: int):
    """``(fn, args, note)``: ``torch._int_mm(a_c^T, b_c)`` for each
    ``chunk``-row slice of K, as K2's X^T.g form sums them, each A^T
    chunk copied row-major outside the timed call (the layout cuBLASLt's
    int8 path takes); the int64 sum of the chunks is left out."""
    (k, m), n = a.shape, b.shape[1]
    ops, padded = [], False
    for k0 in range(0, k, chunk):
        ac, bc = a[k0:k0 + chunk], b[k0:k0 + chunk]
        mp, kp, np_ = _int_mm_shape(m, ac.shape[0], n)
        padded |= (mp, kp, np_) != (m, ac.shape[0], n)
        ops += [_pad_to(ac, (kp, mp)).t().contiguous(),
                _pad_to(bc, (kp, np_))]
    note = "A^T copied outside the call" + (
        "; padded to the nearest legal shape" if padded else "")

    def fn(*xs):
        return [torch._int_mm(x, y) for x, y in zip(xs[0::2], xs[1::2])]
    return fn, tuple(ops), note


def lib_conv(xc, wc, strides, pads):
    """``(fn, args, note)``: cuDNN's fp16 ``conv2d`` of the same codes,
    channels-last, the conv alone (the DFXP epilogue is not in it);
    asymmetric padding applied to the input outside the call."""
    import torch.nn.functional as F
    x = xc.to(torch.float16).permute(0, 3, 1, 2)
    w = wc.to(torch.float16).permute(3, 0, 1, 2).contiguous().permute(
        0, 3, 1, 2)
    (pt, pb), (pl, pr) = pads
    note = "conv only"
    if (pt, pl) != (pb, pr):
        x = F.pad(x, (pl, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
        pt = pl = 0
        note += "; input padded outside the call"
    return (lambda x, w: F.conv2d(x, w, stride=tuple(strides),
                                  padding=(pt, pl)), (x, w), note)


def phase_device() -> dict:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lbt_tpu_torch.ops.kernels import work
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["issue_per_s"] = work.issue_rate(sms, clock_mhz * 1e6)
    print(f"issue rate for the noise's bounds: {work.ISSUE_LANES_PER_SM} "
          f"lanes x {sms} SMs x {clock_mhz:.0f} MHz (the card's maximum SM "
          f"clock) = {CARD['issue_per_s'] / 1e12:.3f} T instructions/s",
          flush=True)
    return {"nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "sm_count": sms,
            "sm_clock_max_mhz": clock_mhz,
            "issue_per_s": CARD["issue_per_s"],
            "torch": torch.__version__, "cuda": torch.version.cuda}


# (tag, source, its loader): #4/#5's noise kinds in a source each
CUDA_SOURCES = (("k1", "quantize.cu", lambda b: b.quantize_library()),
                ("k2", "int8_gemm.cu", lambda b: b.int8_gemm_library()),
                ("conv_bwd", "conv_bwd.cu", lambda b: b.conv_bwd_library()),
                ("fused", "conv_fused.cu",
                 lambda b: b.conv_fused_library(0)),
                ("fused_threefry", "conv_fused_threefry.cu",
                 lambda b: b.conv_fused_library(1)),
                ("fused_rbg", "conv_fused_rbg.cu",
                 lambda b: b.conv_fused_library(2)))


def phase_build(build) -> dict:
    """nvcc for each CUDA source, all started together, each followed in
    its own thread by the count of IMMA instructions in its SASS for the
    int8 tensor-core kernels (K2, #4/#5); each kernel's ptxas report."""
    def built(tag, src, load):
        t0 = time.perf_counter()
        load(build)
        secs = time.perf_counter() - t0
        imma = None
        if tag != "k1":
            try:
                imma = build.sass_counts(build.build_library(src[:-3],
                                                             [src]))
            except (OSError, subprocess.CalledProcessError) as e:
                print(f"  {src}: cuobjdump failed ({e}); IMMA count not "
                      f"available")
        return secs, imma

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        futures = {src[0]: pool.submit(built, *src) for src in CUDA_SOURCES}
        done = {tag: f.result() for tag, f in futures.items()}
    secs = {tag: v[0] for tag, v in done.items()}
    nvcc_s = time.perf_counter() - t0
    print("build: nvcc " + ", ".join(f"{src} {secs[tag]:.1f} s" for
                                      tag, src, _ in CUDA_SOURCES)
          + f" in parallel, the IMMA counts beside them ({nvcc_s:.1f} s)",
          flush=True)
    kernels, tensor_core = {}, []
    for tag, src, _ in CUDA_SOURCES:
        lib = build.build_library(src[:-3], [src])
        imma = done[tag][1]
        for k, v in sorted(build.ptxas_report(lib).items()):
            v = {**v, "imma": None if imma is None else imma.get(k)}
            kernels[build.short_name(k)] = v
            if tag != "k1":
                tensor_core.append(v["imma"])
            print(f"  {build.short_name(k)}: {v['registers']} registers, "
                  f"{v['smem']} B static smem, spills "
                  f"{v.get('spill_stores')}/{v.get('spill_loads')} B"
                  + ("" if tag == "k1" else ", IMMA " + (
                      "not available" if v["imma"] is None
                      else str(v["imma"]))))
    counted = [v for v in tensor_core if v is not None]
    check(all(counted), "a K2 or #4/#5 kernel has no IMMA instruction")
    check(any("k1_quantize_kernel" in k for k in kernels),
          "ptxas reported no K1 kernel")
    print(f"build: IMMA in each of the {len(counted)} K2 and #4/#5 kernels "
          f"counted ({len(tensor_core) - len(counted)} not available)",
          flush=True)
    return {**{f"{tag}_nvcc_s": v for tag, v in secs.items()},
            "nvcc_s": nvcc_s, "kernels": kernels}


def record_path_calls(model, x, qmod, qops, quant, gemm):
    """Count the (shape, bits) of every K1 call and the (M, K, N, scaled)
    of every K2 call that one forward of ``model`` on ``x`` makes."""
    from lbt_tpu_torch.nn.core import Ctx
    k1, k2 = collections.Counter(), collections.Counter()

    def k1_rec(t, bits, exp, noise=None, stats=False):
        k1[(tuple(t.shape), bits)] += 1
        return quant.quantize_codes(t, bits, exp, noise, stats)

    def k2_rec(a, b, inv=None):
        k2[(a.shape[0], a.shape[1], b.shape[1], inv is not None)] += 1
        return gemm.int8_matmul(a, b, inv)

    with mock.patch.object(qmod, "quantize_codes", k1_rec), \
            mock.patch.object(qops, "int8_matmul", k2_rec), \
            torch.inference_mode():
        model.apply(x, Ctx(train=False, update=False))
    return k1, k2


K1_EXP = 2


def _k1_input(shape, bits, gen):
    """``(x, exp)`` on the card: normal draws with ties and both rails
    after scaling at ``K1_EXP``, which a one-element int32 tensor holds."""
    mult = 2.0 ** (bits - 1 - K1_EXP)
    x = torch.randn(shape, generator=gen) * 2
    ties = torch.tensor([0.5, -0.5, 2.5, -3.5, 1e9, -1e9]) / mult
    n = min(x.numel(), ties.numel())
    x.view(-1)[:n] = ties[:n]
    return x.cuda(), torch.tensor(K1_EXP, dtype=torch.int32, device="cuda")


def _equal_outputs(got, want) -> bool:
    return all(g.dtype == w.dtype and g.shape == w.shape
               and torch.equal(g, w) for g, w in zip(got, want))


def lib_quantize(x, exp, bits):
    """``(fn, args, note)``: ``torch.quantize_per_tensor(x, 1/mult, 0,
    qint8)``, whose codes equal K1's deterministic 8-bit codes (clip then
    round half-to-even is round then clamp at 8 bits), or None where it
    computes another function (9-bit codes)."""
    if bits != 8:
        return None
    scale = 2.0 ** -(bits - 1 - int(exp.item()))
    return (lambda x: torch.quantize_per_tensor(x, scale, 0, torch.qint8),
            (x,), "qint8, scale 1/mult")


def phase_k1(quant, k1_calls) -> dict:
    """K1 at every quantize call of the serving forward and at odd sizes:
    codes and multiplier bitwise against the plain version, rounding to
    nearest and with each noise stream (the hashes and threefry, each
    also drawn once along axis 0); each path shape timed beside its bound
    and, for 8-bit codes, the library's quantize, whose codes must be
    K1's; and again with threefry noise (the rounding of ``noise_mode=
    'prng'``, which no library call computes)."""
    from lbt_tpu_torch.ops.kernels import work
    gen = torch.Generator().manual_seed(SEED + 1)
    shapes = {s for s, _ in k1_calls}
    shapes |= {(1,), (4097,), (3, 5, 7), (BATCH, 32, 32, 16)}
    err, n_cmp = 0.0, 0
    for shape in sorted(shapes):
        for bits in (8, 9):
            x, exp = _k1_input(shape, bits, gen)
            for mode, shared in ((0, False), (1, False), (2, False),
                                 (3, False), (3, True), (1, True)):
                noise = noise_of(quant, mode, shape, shared)
                got = quant.quantize_codes(x, bits, exp, noise)
                want = quant.quantize_codes_plain(x, bits, exp, noise)
                torch.cuda.synchronize()
                err = max(err, _max_err(got[0], want[0]))
                check(_equal_outputs(got, want),
                      f"K1 differs from its plain version at {shape} "
                      f"bits={bits} noise={noise}")
                n_cmp += 1
    rows, tf_rows = [], []
    rate = CARD["issue_per_s"]
    for (shape, bits), count in sorted(k1_calls.items()):
        x, exp = _k1_input(shape, bits, gen)
        code_bytes = torch.empty((), dtype=quant.code_dtype(bits)).element_size()
        lib = lib_quantize(x, exp, bits)
        if lib is not None:
            codes = lib[0](x).int_repr()
            check(torch.equal(codes, quant.quantize_codes(x, bits, exp)[0]),
                  f"torch.quantize_per_tensor's codes differ from K1's at "
                  f"{shape}")
        rows.append({"shape": list(shape), "bits": bits, "calls": count,
                     **_timings(
                         lambda x, e: quant.quantize_codes(x, bits, e),
                         lambda x, e: quant.quantize_codes_plain(x, bits, e),
                         (x, exp), x.numel() * (4 + code_bytes),
                         work.quantize_work(x.numel(), code_bytes, False),
                         lib)})
        tf = noise_of(quant, 3, shape)
        tf_rows.append({"shape": list(shape), "bits": bits, "calls": count,
                        **_timings(
                            lambda x, e: quant.quantize_codes(x, bits, e, tf),
                            lambda x, e: quant.quantize_codes_plain(
                                x, bits, e, tf),
                            (x, exp), x.numel() * (4 + code_bytes),
                            work.quantize_work(x.numel(), code_bytes, False,
                                               3, rate))})
    tot = _print_rows("K1", rows, lambda r: f"{r['shape']} b{r['bits']}",
                      per="forward")
    tf_tot = _print_rows("K1 threefry", tf_rows,
                         lambda r: f"{r['shape']} b{r['bits']}",
                         per="forward")
    lib_rows = [r for r in rows if r.get("lib_ms") is not None]
    lib8 = {"ms": sum(r["calls"] * r["ms"] for r in lib_rows),
            "lib_ms": sum(r["calls"] * r["lib_ms"] for r in lib_rows),
            "calls": sum(r["calls"] for r in lib_rows)}
    print(f"K1: {n_cmp} comparisons bitwise equal; the forward's "
          f"{lib8['calls']} 8-bit calls take {lib8['ms']:.4f} ms, "
          f"torch.quantize_per_tensor {lib8['lib_ms']:.4f} ms on them",
          flush=True)
    return {"max_abs_err": err, "comparisons": n_cmp, **tot,
            "library_8bit": lib8, "shapes": rows,
            "threefry": {**tf_tot, "shapes": tf_rows}}


def phase_k2(gemm, k2_calls) -> dict:
    from lbt_tpu_torch.ops.kernels import work
    gen = torch.Generator().manual_seed(SEED + 2)
    err, rows = 0.0, []
    for (m, k, n, scaled), count in sorted(k2_calls.items()):
        a = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        b = torch.randint(-128, 128, (k, n), generator=gen,
                          dtype=torch.int8).cuda()
        inv = torch.tensor([2.0 ** -15], device="cuda")
        for s in (None, inv):
            got = gemm.int8_matmul(a, b, s)
            want = gemm.int8_matmul_plain(a, b, s)
            torch.cuda.synchronize()
            d = (got.to(torch.float64) - want.to(torch.float64)).abs()
            err = max(err, d.max().item())
            check(torch.equal(got, want),
                  f"K2 differs from its plain version at M={m} K={k} N={n} "
                  f"scaled={s is not None}")
        args = (a, b, inv) if scaled else (a, b)
        nbytes = m * k + k * n + m * n * 4
        row = {"m": m, "k": k, "n": n, "scaled": scaled, "calls": count,
               **_timings(gemm.int8_matmul, gemm.int8_matmul_plain, args,
                          nbytes, work.gemm_work(m, k, n, scaled),
                          lib_gemm(a, b))}
        row["int8_tops"] = 2 * m * k * n / row["ms"] / 1e9
        row["gb_per_s"] = nbytes / row["ms"] / 1e6
        rows.append(row)
    for r in rows:
        print(f"  K2 [{r['m']},{r['k']}]x[{r['k']},{r['n']}] "
              f"{'f32' if r['scaled'] else 'i32'} x{r['calls']}: device "
              f"{r['ms'] * 1e3:.1f} us (plain {r['plain_ms'] * 1e3:.1f}), "
              f"{r['gb_per_s']:.0f} GB/s; {_extras(r)}")
    tot = _per_forward(rows)
    print(f"K2: {len(rows)} path shapes bitwise equal; per forward, device "
          f"{tot['ms']:.4f} ms (plain {tot['plain_ms']:.4f}), launched "
          f"eagerly {tot['eager_ms']:.4f} ms (plain "
          f"{tot['plain_eager_ms']:.4f})", flush=True)
    return {"max_abs_err": err, **tot, "shapes": rows}


@contextlib.contextmanager
def plain_route(qmod, qops, quant, gemm):
    """Send the path through the plain versions of K1, K2 (both forms),
    #4/#5 and the conv backward's dgrad and wgrad on the card (for timing
    and cross-checking the kernel route only)."""
    from lbt_tpu_torch.ops.kernels import conv_bwd, conv_fused
    with mock.patch.object(qmod, "quantize_codes",
                           quant.quantize_codes_plain), \
            mock.patch.object(qops, "int8_matmul", gemm.int8_matmul_plain), \
            mock.patch.object(qops, "int8_matmul_tn",
                              gemm.int8_matmul_tn_plain), \
            mock.patch.object(qops, "conv3x3_fused",
                              conv_fused.conv_fused_plain), \
            mock.patch.object(qops, "conv1x1_fused",
                              conv_fused.conv_fused_plain), \
            mock.patch.object(qops, "int8_conv_dgrad",
                              conv_bwd.int8_conv_dgrad_plain), \
            mock.patch.object(qops, "int8_conv_wgrad",
                              conv_bwd.int8_conv_wgrad_plain):
        yield


def build_resnet20(seed: int):
    """CIFAR10_Resnet20 at uniform(8) with random weights from ``seed``;
    BN running statistics, gamma and beta randomized too, so every BN
    does real work."""
    from lbt_tpu_torch.config import QuantConfig
    from lbt_tpu_torch.models import build_model
    from lbt_tpu_torch.nn.norm import Normalization, Rescale
    gen = torch.Generator().manual_seed(seed)
    model = build_model("CIFAR10_Resnet20", QuantConfig.uniform(8))
    model.init(gen)
    with torch.no_grad():
        for layer in model.net.modules():
            if isinstance(layer, Normalization):
                layer.mean.normal_(0.0, 0.5, generator=gen)
                layer.var.uniform_(0.5, 2.0, generator=gen)
            elif isinstance(layer, Rescale):
                layer.gamma.uniform_(0.5, 1.5, generator=gen)
                layer.beta.normal_(0.0, 0.3, generator=gen)
    return model


def phase_serve(quant, gemm, qmod, qops) -> dict:
    from lbt_tpu_torch.infer import Predictor
    from lbt_tpu_torch.nn.core import Ctx
    ctx = Ctx(train=False, update=False)
    rng = np.random.default_rng(SEED)
    requests = [rng.normal(0, 1, (BATCH, 32, 32, 3)).astype(np.float32)
                for _ in range(N_REQUESTS)]
    card_model = build_resnet20(SEED)
    cpu_model = build_resnet20(SEED)
    predictor = Predictor(card_model, device="cuda")
    predictor(requests[0])  # warm-up, before the counted run
    torch.cuda.synchronize()

    quant.quantize_codes.launches = 0
    gemm.int8_matmul.launches = 0
    labels = [predictor(x).cpu() for x in requests]
    torch.cuda.synchronize()
    launches = {"k1": quant.quantize_codes.launches,
                "k2": gemm.int8_matmul.launches}
    print(f"serve: {N_REQUESTS} requests of {BATCH}; launches {launches}",
          flush=True)
    check(launches["k1"] > 0, "K1 never launched on the serving path")
    check(launches["k2"] > 0, "K2 never launched on the serving path")

    err = 0.0
    with torch.inference_mode():
        for x, lab in zip(requests, labels):
            want = cpu_model.apply(torch.from_numpy(x), ctx)
            got = card_model.apply(torch.from_numpy(x).cuda(), ctx).cpu()
            check(got.shape == (BATCH, 10) and bool(torch.isfinite(got)
                                                    .all()),
                  f"bad logits {tuple(got.shape)}")
            err = max(err, (got - want).abs().max().item())
            check(torch.allclose(got, want, **TOL),
                  f"card logits differ from the CPU route: max abs "
                  f"{(got - want).abs().max().item():.3g}")
            check(torch.equal(lab, want.argmax(-1)),
                  "card labels differ from the CPU route")
            with plain_route(qmod, qops, quant, gemm):
                plain = card_model.apply(torch.from_numpy(x).cuda(), ctx)
            check(torch.equal(plain.cpu(), got),
                  "plain route on the card differs from the kernel route")
    print(f"serve: logits match the CPU route (max abs err {err:.3g})",
          flush=True)

    def timed(route: str):
        before = (quant.quantize_codes.launches, gemm.int8_matmul.launches)
        times = []
        with (plain_route(qmod, qops, quant, gemm) if route == "plain"
              else contextlib.nullcontext()):
            predictor(requests[0])
            torch.cuda.synchronize()
            for x in requests:
                t0 = time.perf_counter()
                predictor(x).cpu()
                times.append((time.perf_counter() - t0) * 1e3)
        after = (quant.quantize_codes.launches, gemm.int8_matmul.launches)
        check((after == before) == (route == "plain"),
              f"{route} route launched kernels {before} -> {after}")
        return times

    samples = {"kernel": [], "plain": []}
    for route in ("plain", "kernel", "kernel", "plain") * 2:
        samples[route] += timed(route)
    med = {r: statistics.median(v) for r, v in samples.items()}
    print(f"serve: median ms per request of {BATCH}: kernel route "
          f"{med['kernel']:.3f}, plain route {med['plain']:.3f}",
          flush=True)
    return {"launches": launches, "logits_max_abs_err": err,
            "ms_per_request": med, "samples_ms": samples,
            "requests": N_REQUESTS, "batch": BATCH}


def phase_profile(predictor, x) -> dict:
    """Device time by kernel over two requests, the device's busy share
    of that window, and K1's and K2's device ms per request as the path
    runs them, on operands the path just wrote (None where the profiler
    saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    predictor(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            predictor(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [{"name": ev.key[:90], "calls": ev.count,
             "device_ms": ev.self_device_time_total / 1e3}
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) if rows else None
    in_path = {k: sum(r["device_ms"] for r in rows if name in r["name"])
               / 2 if rows else None
               for k, name in (("k1", "k1_quantize_kernel"),
                               ("k2", "int8_gemm_kernel"))}
    out = {"wall_ms": wall_ms, "device_ms": busy,
           "busy_share": busy / wall_ms if rows else None,
           "launches_per_request": sum(r["calls"] for r in rows) / 2,
           "kernel_ms_per_request": in_path, "top": rows[:15]}
    print(f"profile: 2 requests, wall {wall_ms:.2f} ms, device kernels "
          f"{busy} ms; per request in the path, K1 {in_path['k1']} ms, "
          f"K2 {in_path['k2']} ms; {out['launches_per_request']} device "
          f"launches a request ({LAUNCHES_BEFORE['request']} before)",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
TRAIN_LR = 1e-2
TRAIN_KEY_SEED = 7


def build_train_model(seed: int, cfg=None):
    """CIFAR10_Resnet20 under uniform(8, noise_mode='hash') (or ``cfg``)
    with the default recipe's weight decay, weights from ``seed``, BN
    state at init."""
    from lbt_tpu_torch.config import QuantConfig, TrainConfig
    from lbt_tpu_torch.models import build_model
    model = build_model("CIFAR10_Resnet20",
                        cfg or QuantConfig.uniform(8, noise_mode="hash"),
                        weight_decay=TrainConfig().weight_decay)
    return model.init(torch.Generator().manual_seed(seed))


def train_batches(n: int) -> list:
    rng = np.random.default_rng(SEED + 10)
    return [(torch.from_numpy(rng.normal(0, 1, (BATCH, 32, 32, 3)).astype(
                np.float32)),
             torch.from_numpy(rng.integers(0, 10, (BATCH,))))
            for _ in range(n)]


def make_trainer(model):
    """``(velocity, run(step_index, batch) -> loss tensor)``."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.dfxp.keys import base_key
    from lbt_tpu_torch.train.optim import momentum_init
    from lbt_tpu_torch.train.step import make_train_step
    step = make_train_step(model, TrainConfig())
    velocity = momentum_init(dict(model.net.named_parameters()))
    dev = model.device

    key = base_key(TRAIN_KEY_SEED, model_impl(model))

    def run(i, batch):
        x, y = batch
        return step(model, velocity, x.to(dev), y.to(dev), i, TRAIN_LR,
                    key)["loss"]
    return velocity, run


def model_impl(model) -> str:
    """The key impl of ``model``'s config (``QuantConfig.noise_impl``)."""
    return "threefry2x32" if model.cfg is None else model.cfg.noise_impl


def train_counters(quant, gemm, fused) -> dict:
    from lbt_tpu_torch.ops.kernels import conv_bwd
    return {"k1": quant.quantize_codes.launches,
            "k2": gemm.int8_matmul.launches,
            "k2_tn": gemm.int8_matmul_tn.launches,
            "conv3x3": fused.conv3x3_fused.launches,
            "conv1x1": fused.conv1x1_fused.launches,
            "dgrad": conv_bwd.int8_conv_dgrad.launches,
            "wgrad": conv_bwd.int8_conv_wgrad.launches}


def mode_counters(quant, fused, mode: int) -> dict:
    """The launches in noise mode ``mode`` of K1, #4 and #5."""
    return {"k1": quant.quantize_codes.launches_by_mode[mode],
            "conv3x3": fused.conv3x3_fused.launches_by_mode[mode],
            "conv1x1": fused.conv1x1_fused.launches_by_mode[mode]}


def threefry_counters(quant, fused) -> dict:
    """The launches in threefry mode of K1, #4 and #5."""
    return mode_counters(quant, fused, quant.THREEFRY)


def reset_counters(quant, gemm, fused) -> None:
    from lbt_tpu_torch.ops.kernels import conv_bwd
    for fn in (quant.quantize_codes, gemm.int8_matmul, gemm.int8_matmul_tn,
               fused.conv3x3_fused, fused.conv1x1_fused,
               conv_bwd.int8_conv_dgrad, conv_bwd.int8_conv_wgrad):
        fn.launches = 0
    for fn in (quant.quantize_codes, fused.conv3x3_fused,
               fused.conv1x1_fused):
        fn.launches_by_mode = [0] * (1 + len(quant.NOISE_MODES))


def record_train_calls(qmod, qops, quant, gemm, fused, model=None,
                       batch=None, steps=((0, 1.0),)):
    """Training steps at batch 128 on the card with every kernel call
    recorded: (shape, bits, noise mode, shared, stats) of K1; (M, K, N,
    scaled) of K2; (K, M, N) of its X^T.g form; (kind, x shape, x dtype,
    W shape, strides, pads, noise mode, shared, round_bf16) of #4/#5
    (noise mode 0 rounds to nearest; shared: drawn once along axis 0);
    (kind, x shape, x dtype, W shape, strides, pads, scaled) of the conv
    backward's dgrad and wgrad.  Each of
    ``steps`` is ``(step index, weight)``: a call counts ``weight`` times,
    so a cadence's gated-on and gated-off steps average into calls a step.
    ResNet-20 and one step of ``train_batches`` unless ``model`` and
    ``batch`` are given."""
    from lbt_tpu_torch.ops.kernels import conv_bwd
    k1, k2, tn, conv, bwd = (collections.Counter() for _ in range(5))
    weight = [1.0]

    def k1_rec(t, bits, exp, noise=None, stats=False):
        k1[(tuple(t.shape), bits, *noise_key(noise), bool(stats))] += \
            weight[0]
        return quant.quantize_codes(t, bits, exp, noise, stats)

    def k2_rec(a, b, inv=None):
        k2[(a.shape[0], a.shape[1], b.shape[1], inv is not None)] += \
            weight[0]
        return gemm.int8_matmul(a, b, inv)

    def tn_rec(a, b):
        tn[(a.shape[0], a.shape[1], b.shape[1])] += weight[0]
        return gemm.int8_matmul_tn(a, b)

    def conv_rec(kind):
        def rec(xc, wc, inv, mult, *, strides, pads, bits_out=8,
                noise=None, round_bf16=False):
            conv[(kind, tuple(xc.shape), str(xc.dtype), tuple(wc.shape),
                  tuple(strides), tuple(pads), *noise_key(noise),
                  bool(round_bf16))] += weight[0]
            return getattr(fused, kind)(xc, wc, inv, mult, strides=strides,
                                        pads=pads, bits_out=bits_out,
                                        noise=noise, round_bf16=round_bf16)
        return rec

    def dgrad_rec(gc, wc, x_hw, strides, pads, inv=None):
        bwd[("dgrad", (gc.shape[0], *x_hw, wc.shape[2]), str(torch.int8),
             tuple(wc.shape), tuple(strides), tuple(map(tuple, pads)),
             inv is not None)] += weight[0]
        return conv_bwd.int8_conv_dgrad(gc, wc, x_hw, strides, pads, inv)

    def wgrad_rec(xc, gc, ksize, strides, pads):
        bwd[("wgrad", tuple(xc.shape), str(xc.dtype),
             (*ksize, xc.shape[3], gc.shape[3]), tuple(strides),
             tuple(map(tuple, pads)), False)] += weight[0]
        return conv_bwd.int8_conv_wgrad(xc, gc, ksize, strides, pads)

    if model is None:
        model = build_train_model(SEED).to("cuda")
        batch = train_batches(1)[0]
    _, run = make_trainer(model)
    with mock.patch.object(qmod, "quantize_codes", k1_rec), \
            mock.patch.object(qops, "int8_matmul", k2_rec), \
            mock.patch.object(qops, "int8_matmul_tn", tn_rec), \
            mock.patch.object(qops, "conv3x3_fused",
                              conv_rec("conv3x3_fused")), \
            mock.patch.object(qops, "conv1x1_fused",
                              conv_rec("conv1x1_fused")), \
            mock.patch.object(qops, "int8_conv_dgrad", dgrad_rec), \
            mock.patch.object(qops, "int8_conv_wgrad", wgrad_rec):
        for i, w in steps:
            weight[0] = w
            run(i, batch)
    torch.cuda.synchronize()
    print(f"train shapes: a step makes {sum(k1.values()):g} K1, "
          f"{sum(k2.values()):g} K2, {sum(tn.values()):g} K2 X^T.g, "
          f"{sum(conv.values()):g} fused conv, "
          f"{sum(bwd.values()):g} dgrad and wgrad calls", flush=True)
    return k1, k2, tn, conv, bwd


def _us(v) -> str:
    return "n/a" if v is None else f"{v * 1e3:.2f} us"


def _extras(r) -> str:
    """Bound and library times of a row, where measured."""
    out = [f"bound {_us(r.get('bound_ms'))} ({r.get('bound_by')})"]
    if "lib_ms" in r:
        out.append(f"library {_us(r['lib_ms'])}"
                   + (f" ({r['lib_note']})" if r.get("lib_note") else ""))
    return ", ".join(out)


def _ms(v) -> str:
    return "n/a" if v is None else f"{v:.4f}"


def _print_rows(tag, rows, label, per="step"):
    for r in rows:
        print(f"  {tag} {label(r)} x{r['calls']:g}: device "
              f"{r['ms'] * 1e3:.2f} us (plain {r['plain_ms'] * 1e3:.1f}); "
              f"{_extras(r)}")
    tot = _per_forward(rows)
    print(f"{tag}: {len(rows)} path shapes bitwise equal; per {per} "
          f"({tot['launches']:g} launches), device {tot['ms']:.4f} ms (plain "
          f"{tot['plain_ms']:.4f}, bound {_ms(tot['bound_ms'])} by "
          f"{tot.get('bound_by')}, library {_ms(tot['lib_ms'])}), launched "
          f"eagerly {_ms(tot['eager_ms'])} ms "
          f"(plain {_ms(tot['plain_eager_ms'])})", flush=True)
    return tot


def _max_err(got, want) -> float:
    d = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return d.max().item() if d.numel() else 0.0


def _checks(mode: int, offsets: bool) -> list:
    """``(noise mode, row0)`` of a call's checks against its plain
    version: round to nearest, the path's mode and threefry, each
    stochastic one at offsets 0 and ``CHECK_ROW0``; without ``offsets``
    the path's mode at 0 alone."""
    if not offsets:
        return [(mode, 0)]
    return [(m, r) for m in sorted({0, mode, 3})
            for r in ((0, CHECK_ROW0) if m else (0,))]


def phase_k1_train(quant, k1_calls, reps=REPS, tag="K1-stats",
                   threefry_twins=False, offsets=True) -> dict:
    """K1 at every quantize call of the training step, with the path's
    rounding mode and its min/max output, bitwise against the plain
    version (codes, multiplier, min/max), and again with threefry noise,
    with ``offsets`` each stochastic call also at a non-zero counter
    offset (a data-parallel eval rank's rows, ``CHECK_ROW0``); timed per
    shape.  ``threefry_twins`` also times each stochastic call with
    threefry noise in place of its hash (``threefry`` in the result: the
    step under ``noise_mode='prng'``).  ``offsets=False`` (the ImageNet
    shapes, where threefry's plain version takes seconds a step) checks
    the path's mode at offset 0 only."""
    from lbt_tpu_torch.ops.kernels import work
    gen = torch.Generator().manual_seed(SEED + 4)
    err, rows, tf_rows = 0.0, [], []
    rate = CARD["issue_per_s"]
    exp = torch.tensor(1, dtype=torch.int32, device="cuda")

    def row(x, bits, mode, shared, stats, count):
        noise = noise_of(quant, mode, x.shape, shared)
        code_bytes = torch.empty((), dtype=quant.code_dtype(bits)) \
            .element_size()
        return {
            "shape": list(x.shape), "bits": bits, "mode": MODE_NAMES[mode],
            "shared": shared, "stats": stats, "calls": count,
            **_timings(
                lambda x, e: quant.quantize_codes(x, bits, e, noise, stats),
                lambda x, e: quant.quantize_codes_plain(x, bits, e, noise,
                                                        stats),
                (x, exp), x.numel() * (4 + code_bytes),
                work.quantize_work(x.numel(), code_bytes, stats, mode, rate),
                reps=reps)}

    for (shape, bits, mode, shared, stats), count in sorted(
            k1_calls.items()):
        x = (torch.randn(shape, generator=gen) * 2).cuda()
        for m, row0 in _checks(mode, offsets):
            noise = noise_of(quant, m, shape, shared, row0)
            if shared and row0:  # any offset, K1 takes it before % inner
                noise = noise._replace(offset=row0 * noise.inner + 5)
            got = quant.quantize_codes(x, bits, exp, noise, True)
            want = quant.quantize_codes_plain(x, bits, exp, noise, True)
            torch.cuda.synchronize()
            err = max(err, max(_max_err(g, w) for g, w in zip(got, want)))
            check(_equal_outputs(got, want),
                  f"K1 (stats) differs from its plain version at "
                  f"{shape} bits={bits} noise={noise}")
        rows.append(row(x, bits, mode, shared, stats, count))
        if threefry_twins and mode:
            tf_rows.append(row(x, bits, 3, shared, stats, count))

    def label(r):
        return (f"{r['shape']} b{r['bits']} {r['mode']}"
                f"{' shared' if r['shared'] else ''}"
                f"{' mm' if r['stats'] else ''}")

    out = {"max_abs_err": err, **_print_rows(tag, rows, label),
           "shapes": rows}
    if tf_rows:
        out["threefry"] = {**_print_rows(f"{tag} threefry", tf_rows, label),
                           "shapes": tf_rows}
    return out


def phase_k2_train(gemm, k2_calls, tn_calls, reps=REPS,
                   tag="K2-train") -> dict:
    """K2's forward form at the step's dx / dense shapes and its X^T.g
    form at every dW shape (split-9 planes, the head), bitwise against
    the plain versions; timed per shape.  The X^T.g form's library time
    is one ``torch._int_mm`` per 2**16-row chunk (hundreds of ms a call
    at ResNet-50's stem: ``R50_K2_REPS`` times it once a shape)."""
    from lbt_tpu_torch.ops.kernels import work
    gen = torch.Generator().manual_seed(SEED + 5)
    err, rows = 0.0, []
    inv = torch.tensor([2.0 ** -15], device="cuda")
    for (m, k, n, scaled), count in sorted(k2_calls.items()):
        a = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        b = torch.randint(-128, 128, (k, n), generator=gen,
                          dtype=torch.int8).cuda()
        args = (a, b, inv) if scaled else (a, b)
        got, want = gemm.int8_matmul(*args), gemm.int8_matmul_plain(*args)
        torch.cuda.synchronize()
        err = max(err, _max_err(got, want))
        check(torch.equal(got, want),
              f"K2 differs from its plain version at M={m} K={k} N={n}")
        rows.append({"form": "AB", "m": m, "k": k, "n": n, "calls": count,
                     **_timings(gemm.int8_matmul, gemm.int8_matmul_plain,
                                args, m * k + k * n + m * n * 4,
                                work.gemm_work(m, k, n, scaled),
                                lib_gemm(a, b), reps)})
    for (k, m, n), count in sorted(tn_calls.items()):
        a = torch.randint(-128, 128, (k, m), generator=gen,
                          dtype=torch.int8).cuda()
        b = torch.randint(-128, 128, (k, n), generator=gen,
                          dtype=torch.int8).cuda()
        got, want = gemm.int8_matmul_tn(a, b), gemm.int8_matmul_tn_plain(a, b)
        torch.cuda.synchronize()
        err = max(err, _max_err(got, want))
        check(torch.equal(got, want), f"K2 X^T.g differs from its plain "
              f"version at K={k} M={m} N={n}")
        rows.append({"form": "ATB", "m": m, "k": k, "n": n, "calls": count,
                     **_timings(gemm.int8_matmul_tn,
                                gemm.int8_matmul_tn_plain, (a, b),
                                k * (m + n) + m * n * 8,
                                work.gemm_tn_work(k, m, n),
                                lib_gemm_tn(a, b, gemm.K_CHUNK), reps)})
    tot = _print_rows(tag, rows, lambda r: f"{r['form']} M{r['m']} "
                      f"K{r['k']} N{r['n']}")
    forms = {f: _per_forward([r for r in rows if r["form"] == f])
             for f in ("AB", "ATB")}
    for f, t in forms.items():
        print(f"{tag} {f}: per step ({t['launches']:g} launches) device "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, bound "
              f"{_ms(t['bound_ms'])} ({t.get('bound_by')}), library "
              f"{_ms(t['lib_ms'])}",
              flush=True)
    return {"max_abs_err": err, **tot, "forms": forms, "shapes": rows}


def phase_fused(fused, conv_calls, reps=REPS, threefry_twins=False,
                offsets=True) -> dict:
    """#4 and #5 at every conv -> BN shape of the step (batch 128):
    codes (deterministic, stochastic with the path's noise, and with
    threefry noise, each stochastic call also at the counter offset of
    rows ``CHECK_ROW0..``; with ``offsets=False`` the path's mode at
    offset 0 only), moments and min/max equal to the plain version's;
    timed per shape, and with ``threefry_twins`` again with threefry noise
    in place of the path's hash (``threefry`` in each kind's result)."""
    from lbt_tpu_torch.ops.im2col import out_hw
    from lbt_tpu_torch.ops.kernels import quant, work
    gen = torch.Generator().manual_seed(SEED + 6)
    rate = CARD["issue_per_s"]
    out = {}
    for kind in ("conv3x3_fused", "conv1x1_fused"):
        if not any(key[0] == kind for key in conv_calls):
            continue  # a path without this kind (VGG-16: no 1x1 conv)
        err, rows, tf_rows = 0.0, [], []
        fn = getattr(fused, kind)
        for key, count in sorted(conv_calls.items()):
            (k, xshape, xdtype, wshape, strides, pads, mode, shared,
             rbf) = key
            if k != kind:
                continue
            lim = 256 if xdtype == str(torch.int16) else 128
            dtype = torch.int16 if lim == 256 else torch.int8
            xc = torch.randint(-lim, lim, xshape, generator=gen,
                               dtype=dtype).cuda()
            wc = torch.randint(-128, 128, wshape, generator=gen,
                               dtype=torch.int8).cuda()
            inv = torch.tensor([2.0 ** -14], device="cuda")
            mult = torch.tensor([2.0 ** -2], device="cuda")
            yshape = (xshape[0], *out_hw(xshape[1], xshape[2], wshape[:2],
                                         strides, pads), wshape[3])
            for m, row0 in _checks(mode, offsets):
                kw = dict(strides=strides, pads=pads, round_bf16=rbf,
                          noise=noise_of(quant, m, yshape, shared, row0))
                if shared and row0:  # a whole number of shared draws
                    kw["noise"] = kw["noise"]._replace(
                        offset=row0 * kw["noise"].inner)
                got = fn(xc, wc, inv, mult, **kw)
                want = fused.conv_fused_plain(xc, wc, inv, mult, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    err = max(err, _max_err(g, w))
                    check(g.dtype == w.dtype and torch.equal(g, w),
                          f"{kind} differs from its plain version at "
                          f"x {xshape} w {wshape} noise={kw['noise']}")
            nbytes = xc.numel() * xc.element_size() + math.prod(yshape)

            def row(m):
                kw = dict(strides=strides, pads=pads, round_bf16=rbf,
                          noise=noise_of(quant, m, yshape, shared))
                return {"x": list(xshape), "x_dtype": xdtype,
                        "w": list(wshape), "strides": list(strides),
                        "mode": MODE_NAMES[m], "calls": count,
                        **_timings(lambda x, w: fn(x, w, inv, mult, **kw),
                                   lambda x, w: fused.conv_fused_plain(
                                       x, w, inv, mult, **kw),
                                   (xc, wc), nbytes,
                                   work.conv_fused_work(
                                       xshape, xc.element_size(), wshape,
                                       strides, pads, m, rate),
                                   lib_conv(xc, wc, strides, pads), reps)}
            rows.append(row(mode))
            if threefry_twins and mode:
                tf_rows.append(row(3))
        for r in rows + tf_rows:
            macs = math.prod(r["w"]) * r["x"][0] * r["x"][1] * r["x"][2] / (
                r["strides"][0] * r["strides"][1])
            r["int_tops"] = 2 * macs / r["ms"] / 1e9

        def label(r):
            return f"x{r['x']} w{r['w']} s{r['strides'][0]} {r['mode']}"

        # lib_ms here is cuDNN's conv alone (lib_note "conv only")
        out[kind] = {"max_abs_err": err, **_print_rows(kind, rows, label),
                     "shapes": rows}
        if tf_rows:
            out[kind]["threefry"] = {
                **_print_rows(f"{kind} threefry", tf_rows, label),
                "shapes": tf_rows}
    return out


def lib_conv_bwd(xc, wc, gc, strides, pads):
    """``((dgrad fn, args), (wgrad fn, args), note)``: cuDNN's fp16 dgrad
    and wgrad of the same codes, channels-last, alone (a yardstick: the
    port never calls them), with the symmetric padding of the same output
    size; ``None`` for both where no symmetric padding gives it."""
    import torch.nn.functional as F
    pad = tuple(max(p) for p in pads)

    def nchw(t):
        return t.half().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    x16, w16, g16 = nchw(xc), nchw(wc.permute(3, 0, 1, 2)), nchw(gc)
    if F.conv2d(x16[:1], w16, stride=strides,
                padding=pad).shape[2:] != gc.shape[1:3]:
        return None, None, "no symmetric padding gives the output size"
    return ((lambda g, w: torch.nn.grad.conv2d_input(
                x16.shape, w, g, strides, pad), (g16, w16)),
            (lambda x, g: torch.nn.grad.conv2d_weight(
                x, w16.shape, g, strides, pad), (x16, g16)),
            "cuDNN fp16 alone")


def phase_conv_bwd(qops, bwd_calls, reps=REPS, tag="conv-bwd") -> dict:
    """dgrad and wgrad at every conv backward call of the step that takes
    them: each kernel bitwise against its plain version and against the
    im2col route it replaced (``qops._im2col_dgrad`` / ``_im2col_wgrad``:
    K2 over im2col patches of the zero-dilated cotangent or of ``x``),
    dgrad with and without its scale, wgrad with the path's int8 or 9-bit
    codes; timed per shape as in 7, beside the bound, the plain version,
    the im2col route (``old_ms``) and cuDNN's fp16 dgrad / wgrad alone
    (``lib_ms``)."""
    from lbt_tpu_torch.ops.im2col import out_hw
    from lbt_tpu_torch.ops.kernels import conv_bwd, work
    gen = torch.Generator().manual_seed(SEED + 9)
    out = {}
    for kind in ("dgrad", "wgrad"):
        err, rows = 0.0, []
        for key, count in sorted(bwd_calls.items()):
            k, xshape, xdtype, wshape, strides, pads, scaled = key
            if k != kind:
                continue
            kh, kw, cin, cout = wshape
            lim = 256 if xdtype == str(torch.int16) else 128
            xc = torch.randint(-lim, lim, xshape, generator=gen,
                               dtype=torch.int16 if lim == 256
                               else torch.int8).cuda()
            wc = torch.randint(-128, 128, wshape, generator=gen,
                               dtype=torch.int8).cuda()
            gc = torch.randint(-128, 128, (
                xshape[0], *out_hw(xshape[1], xshape[2], (kh, kw), strides,
                                   pads), cout), generator=gen,
                dtype=torch.int8).cuda()
            inv = torch.tensor([2.0 ** -13], device="cuda")
            dgrad_lib, wgrad_lib, note = lib_conv_bwd(xc, wc, gc, strides,
                                                      pads)
            if kind == "dgrad":
                def fn(g, w, inv=inv if scaled else None):
                    return conv_bwd.int8_conv_dgrad(g, w, xshape[1:3],
                                                    strides, pads, inv)

                def plain(g, w, inv=inv if scaled else None):
                    return conv_bwd.int8_conv_dgrad_plain(
                        g, w, xshape[1:3], strides, pads, inv)

                def old(g, w, inv=inv if scaled else None):
                    return qops._im2col_dgrad(g, w, xshape[1:3], strides,
                                              pads, inv)
                args, lib = (gc, wc), dgrad_lib
                w_ = work.conv_dgrad_work(gc.shape, wshape, xshape[1:3],
                                          strides, pads, scaled)
                # the im2col route's patches, written and read back
                patches = xshape[0] * xshape[1] * xshape[2] * kh * kw * cout
                for s in (inv, None):
                    got = fn(gc, wc, s)
                    for want in (plain(gc, wc, s), old(gc, wc, s)):
                        torch.cuda.synchronize()
                        err = max(err, _max_err(got, want))
                        check(got.dtype == want.dtype
                              and torch.equal(got, want),
                              f"dgrad differs from its plain version or "
                              f"the im2col route at x {xshape} w {wshape} "
                              f"s{strides} scaled={s is not None}")
            else:
                def fn(x, g):
                    return conv_bwd.int8_conv_wgrad(x, g, (kh, kw), strides,
                                                    pads)

                def plain(x, g):
                    return conv_bwd.int8_conv_wgrad_plain(x, g, (kh, kw),
                                                          strides, pads)

                def old(x, g):
                    return qops._im2col_wgrad(x, g, (kh, kw), strides, pads)
                args, lib = (xc, gc), wgrad_lib
                w_ = work.conv_wgrad_work(xshape, xc.element_size(),
                                          gc.shape, (kh, kw), strides, pads)
                patches = gc.numel() // cout * kh * kw * cin
                got = fn(xc, gc)
                for want in (plain(xc, gc), old(xc, gc)):
                    torch.cuda.synchronize()
                    err = max(err, _max_err(got, want))
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"wgrad differs from its plain version or the "
                          f"im2col route at x {xshape} {xdtype} w {wshape} "
                          f"s{strides}")
            del got, want
            row = {"x": list(xshape), "x_dtype": xdtype, "w": list(wshape),
                   "strides": list(strides), "pads": [list(p) for p in pads],
                   "scaled": scaled, "calls": count,
                   **_timings(fn, plain, args, w_.bytes, w_,
                              None if lib is None else (*lib, note), reps)}
            if lib is None:
                row.update(lib_ms=None, lib_note=note)
            row["old_ms"] = device_ms(
                old, rotating_inputs(args, w_.bytes + 2 * patches),
                *reps[0])
            rows.append(row)
            torch.cuda.empty_cache()

        def label(r):
            return (f"x{r['x']} {r['x_dtype'][6:]} w{r['w']} "
                    f"s{r['strides'][0]}")
        tot = _print_rows(f"{tag} {kind}", rows, label)
        tot["old_ms"] = sum(r["calls"] * r["old_ms"] for r in rows)
        print(f"{tag} {kind}: per step {tot['ms']:.4f} ms against the "
              f"im2col route's {tot['old_ms']:.4f} for the same calls",
              flush=True)
        out[kind] = {"max_abs_err": err, **tot, "shapes": rows}
    return out


def _state(model, velocity) -> dict:
    out = {f"net.{k}": v.detach().clone()
           for k, v in model.net.state_dict().items()}
    out.update({f"velocity.{k}": v.clone() for k, v in velocity.items()})
    return out


def _kernel_device_ms(rows, n_steps) -> dict:
    names = {"k1": ("k1_quantize_kernel",),
             "k2": ("int8_gemm_kernel", "int8_gemm_tn_kernel"),
             "conv3x3": ("conv_fused_kernel<3", "conv_fused_kernelILi3"),
             "conv1x1": ("conv_fused_kernel<1", "conv_fused_kernelILi1"),
             "dgrad": ("conv_dgrad_kernel",), "wgrad": ("conv_wgrad_kernel",)}
    return {k: sum(r["device_ms"] for r in rows
                   if any(n in r["name"] for n in ns)) / n_steps
            for k, ns in names.items()}


def one_launch_a_call(rows, calls, required=("k1", "conv3x3", "conv1x1")
                      ) -> None:
    """K1 and #4/#5 in a profiler window: as many ``k1_quantize_kernel``
    and ``conv_fused_kernel`` launches of each kind as calls of its
    wrapper, and no second kernel of theirs (the old designs'
    ``_minmax_kernel`` and ``minmax_decode_kernel``); each kind in
    ``required`` called at least once.  Fails where the profiler saw no
    device time, which would leave it unmeasured."""
    check(bool(rows), "the train profile saw no device kernels: the "
          "launches a call of K1 and #4/#5 cannot be counted")
    got = {kind: sum(r["calls"] for r in rows
                     if any(n in r["name"] for n in names))
           for kind, names in (("k1", ("k1_quantize_kernel",)),
                               ("conv3x3", ("conv_fused_kernel<3",
                                            "conv_fused_kernelILi3")),
                               ("conv1x1", ("conv_fused_kernel<1",
                                            "conv_fused_kernelILi1")))}
    extra = [r["name"] for r in rows
             if "minmax_decode" in r["name"] or "_minmax_kernel" in r["name"]]
    for kind, n in got.items():
        check(n == calls[kind] and (n > 0 or kind not in required)
              and not extra,
              f"{kind}: {n} kernel launches for {calls[kind]} calls "
              f"(other kernels: {extra})")
    print(f"K1 and fused: one device launch a call ({got['k1']} K1, "
          f"{got['conv3x3']} #4 and {got['conv1x1']} #5 launches for as "
          f"many wrapper calls)", flush=True)


def _profile_steps(run, batches, first_step: int) -> dict:
    """Device time by kernel over two steps, the device's busy share,
    device launches a step and each kernel's device ms a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, b in enumerate(batches[:2]):
            run(first_step + i, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [{"name": ev.key[:120], "calls": ev.count,
             "device_ms": ev.self_device_time_total / 1e3}
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) if rows else None
    return {"wall_ms": wall_ms, "device_ms": busy,
            "busy_share": busy / wall_ms if rows else None,
            "launches_per_step": sum(r["calls"] for r in rows) / 2,
            "kernel_ms_per_step": _kernel_device_ms(rows, 2) if rows
            else None, "top": rows[:20], "rows": rows}


def phase_train(qmod, qops, quant, gemm, fused) -> dict:
    torch.use_deterministic_algorithms(True)
    try:
        return _phase_train(qmod, qops, quant, gemm, fused)
    finally:
        torch.use_deterministic_algorithms(False)


def _phase_train(qmod, qops, quant, gemm, fused) -> dict:
    batches = train_batches(TRAIN_STEPS)
    card = build_train_model(SEED).to("cuda")
    plain = build_train_model(SEED).to("cuda")
    card_vel, card_run = make_trainer(card)
    plain_vel, plain_run = make_trainer(plain)

    reset_counters(quant, gemm, fused)
    losses = [card_run(i, b) for i, b in enumerate(batches)]
    torch.cuda.synchronize()
    launches = train_counters(quant, gemm, fused)
    print(f"train: {TRAIN_STEPS} steps of {BATCH} through the kernels; "
          f"launches {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"{k} never launched on the training path")
    losses = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")

    with plain_route(qmod, qops, quant, gemm):
        plain_losses = [plain_run(i, b).item()
                        for i, b in enumerate(batches)]
    torch.cuda.synchronize()
    check(train_counters(quant, gemm, fused) == launches,
          "the plain route launched a kernel")
    check(plain_losses == losses,
          f"losses differ: kernels {losses}, plain {plain_losses}")
    got, want = _state(card, card_vel), _state(plain, plain_vel)
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    check(not diff, f"kernel and plain routes differ in {diff[:5]} "
          f"({len(diff)} tensors)")
    n_exp = sum(1 for k in got if k.rsplit(".", 1)[-1].startswith("exp_"))
    print(f"train: losses {losses}; kernel and plain routes equal in all "
          f"{len(got)} tensors ({n_exp} exponents; tolerance 0)",
          flush=True)

    cpu = build_train_model(SEED)
    _, cpu_run = make_trainer(cpu)
    cpu_loss = cpu_run(0, batches[0]).item()
    check(math.isclose(cpu_loss, losses[0], rel_tol=1e-5),
          f"first-step loss {losses[0]} differs from the CPU route's "
          f"{cpu_loss}")
    print(f"train: first-step loss matches the CPU route ({cpu_loss})",
          flush=True)

    # host cost of one step's site keys (every uid x site, two numpy calls)
    from lbt_tpu_torch.dfxp import keys
    t0 = time.perf_counter()
    for i in range(50):
        keys.site_keys(keys.fold_in(keys.base_key(TRAIN_KEY_SEED), i),
                       card.num_layers(), 5)
    site_keys_us = (time.perf_counter() - t0) / 50 * 1e6
    print(f"train: host time of one step's site-key table "
          f"({card.num_layers()} uids x 5 sites) {site_keys_us:.1f} us",
          flush=True)

    samples = {"kernel": [], "plain": []}
    step_no = {"kernel": TRAIN_STEPS, "plain": TRAIN_STEPS}
    for route in ("plain", "kernel", "kernel", "plain") * 2:
        run = card_run if route == "kernel" else plain_run
        with (plain_route(qmod, qops, quant, gemm) if route == "plain"
              else contextlib.nullcontext()):
            for b in batches[:2]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(step_no[route], b)
                torch.cuda.synchronize()
                samples[route].append((time.perf_counter() - t0) * 1e3)
                step_no[route] += 1
    med = {r: statistics.median(v) for r, v in samples.items()}
    print(f"train: median ms per step of {BATCH}: kernel route "
          f"{med['kernel']:.3f}, plain route {med['plain']:.3f}",
          flush=True)

    before = train_counters(quant, gemm, fused)
    prof_out = _profile_steps(card_run, batches, step_no["kernel"])
    calls = {k: v - before[k] for k, v in
             train_counters(quant, gemm, fused).items()}
    one_launch_a_call(prof_out.pop("rows"), calls)
    wall_ms, busy = prof_out["wall_ms"], prof_out["device_ms"]
    in_path = prof_out["kernel_ms_per_step"]
    print(f"train profile: 2 steps, wall {wall_ms:.2f} ms, device kernels "
          f"{busy} ms (busy share {prof_out['busy_share']}); per step in "
          f"the path {in_path}; {prof_out['launches_per_step']} device "
          f"launches a step ({LAUNCHES_BEFORE['step']} before)", flush=True)
    return {"launches": launches, "losses": losses,
            "plain_losses": plain_losses, "cpu_first_loss": cpu_loss,
            "ms_per_step": med, "samples_ms": samples,
            "site_keys_us": site_keys_us,
            "profile": prof_out, "steps": TRAIN_STEPS, "batch": BATCH}


# ---------------------------------------------------------------------------
# rbg: noise_impl='unsafe_rbg', XLA's Philox stream in K1 and #4/#5
# ---------------------------------------------------------------------------

RBG_BATCH = 512          # benchmarks/ablate.py:104's --batch
RBG_GATE_STEPS = 2       # kernel route vs plain route, bitwise
RBG_TIMED_STEPS = 4      # each of rbg-int8 and prng-int8, in turns
RBG_CPU_BATCH = 32       # step 0 against the CPU route


def rbg_config(impl: str = "unsafe_rbg"):
    """``benchmarks/ablate.py:90-91``'s ``rbg-int8``: ``uniform(8,
    engine='int8', noise_mode='prng', noise_impl='unsafe_rbg')``; with
    ``impl='threefry2x32'`` its ``prng-int8`` (``:84``)."""
    from lbt_tpu_torch.config import QuantConfig
    return QuantConfig.uniform(8, engine="int8", noise_mode="prng",
                               noise_impl=impl)


def build_rbg(seed: int, impl: str = "unsafe_rbg"):
    """CIFAR10_Resnet20 at full width and depth under :func:`rbg_config`,
    weights from ``seed``, the default recipe's weight decay."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.models import build_model
    return build_model("CIFAR10_Resnet20", rbg_config(impl),
                       weight_decay=TrainConfig().weight_decay).init(
                           torch.Generator().manual_seed(seed))


def rbg_batches(n: int) -> list:
    rng = np.random.default_rng(SEED + 13)
    return [(torch.from_numpy(rng.normal(0, 1, (RBG_BATCH, 32, 32, 3))
                              .astype(np.float32)),
             torch.from_numpy(rng.integers(0, 10, (RBG_BATCH,))))
            for _ in range(n)]


def phase_rbg(qmod, qops, quant, gemm, fused) -> dict:
    """``rbg-int8`` on the card: ResNet-20 at batch 512, gated, timed in
    turns with ``prng-int8`` and profiled; then K1 and #4/#5 in mode 4 at
    the step's shapes against their plain versions, bounds and
    ``torch.rand`` of the same count, beside their device ms in both
    legs' profiles; then their counter-offset and column-window forms."""
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        out = _rbg_train(qmod, qops, quant, gemm, fused)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    out["k1"] = phase_k1_train(quant, out.pop("k1_calls"), FAST_REPS,
                               "RBG K1")
    out["fused"] = phase_fused(fused, out.pop("conv_calls"), FAST_REPS)
    in_step = {name: out[name]["profile"]["kernel_ms_per_step"]
               for name in ("rbg", "prng")}
    _rbg_yardstick(out["k1"], lambda r: math.prod(r["shape"]), in_step,
                   "k1")
    for kind, res in out["fused"].items():
        _rbg_yardstick(res, lambda r: (r["x"][0] * r["x"][1] * r["x"][2]
                                       // (r["strides"][0]
                                           * r["strides"][1])
                                       * r["w"][3]), in_step,
                       kind.split("_")[0])
    out["forms"] = _rbg_forms(quant, fused)
    out["seconds"] = time.perf_counter() - t0
    print(f"rbg: phase took {out['seconds']:.1f} s", flush=True)
    return out


def _rbg_yardstick(res, count, in_step, kind) -> None:
    """Beside a kernel's rows a step: ``rng_ms``, ``torch.rand`` of each
    call's count of uniforms on the card's own Philox generator (another
    stream, nothing quantized), replayed from a CUDA graph; and the
    kernel's device ms a step in the two legs' profiles (``in_step``):
    ``profile_ms`` under rbg-int8, ``threefry_ms`` under prng-int8, the
    same calls in threefry mode."""
    for r in res["shapes"]:
        n = count(r)
        r["rng_ms"] = device_ms(lambda n=n: torch.rand(n, device="cuda"),
                                [()], *FAST_REPS[0])
    res["rng_ms"] = sum(r["calls"] * r["rng_ms"] for r in res["shapes"])
    res["profile_ms"] = in_step["rbg"][kind]
    res["threefry_ms"] = in_step["prng"][kind]
    print(f"RBG {kind}: a step {res['ms']:.4f} ms in mode 4 replayed out of "
          f"L2 (bound {res['bound_ms']:.4f} by {res['bound_by']}), "
          f"torch.rand of the same counts {res['rng_ms']:.4f}; in the "
          f"steps' profiles {res['profile_ms']:.4f} in mode 4 and "
          f"{res['threefry_ms']:.4f} in threefry mode", flush=True)


def _rbg_train(qmod, qops, quant, gemm, fused) -> dict:
    batches = rbg_batches(RBG_GATE_STEPS)
    probe = build_rbg(SEED).to("cuda")
    k1, _, _, conv, _ = record_train_calls(qmod, qops, quant, gemm, fused,
                                        probe, batches[0])
    del probe

    card = build_rbg(SEED).to("cuda")
    card_vel, card_run = make_trainer(card)
    reset_counters(quant, gemm, fused)
    losses = [card_run(i, b).item() for i, b in enumerate(batches)]
    torch.cuda.synchronize()
    launches = train_counters(quant, gemm, fused)
    rbg = mode_counters(quant, fused, quant.RBG)
    others = [mode_counters(quant, fused, m) for m in quant.NOISE_MODES
              if m != quant.RBG]
    print(f"rbg train: {RBG_GATE_STEPS} steps of {RBG_BATCH} through the "
          f"kernels; launches {launches}, in mode 4 {rbg}", flush=True)
    for k in ("k1", "k2", "k2_tn", "conv3x3", "conv1x1"):
        check(launches[k] > 0, f"rbg: {k} never launched")
    for k in ("k1", "conv3x3", "conv1x1"):
        check(rbg[k] > 0 and all(o[k] == 0 for o in others),
              f"rbg: {k} launched in mode 4 {rbg[k]} times, in other "
              f"noise modes {[o[k] for o in others]}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")

    plain = build_rbg(SEED).to("cuda")
    plain_vel, plain_run = make_trainer(plain)
    with plain_route(qmod, qops, quant, gemm):
        plain_losses = [plain_run(i, b).item()
                        for i, b in enumerate(batches)]
    torch.cuda.synchronize()
    check(train_counters(quant, gemm, fused) == launches,
          "the plain route launched a kernel")
    check(plain_losses == losses,
          f"rbg: losses differ: kernels {losses}, plain {plain_losses}")
    got, want = _state(card, card_vel), _state(plain, plain_vel)
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    check(not diff, f"rbg: the kernel and plain routes differ in "
          f"{diff[:5]} ({len(diff)} tensors)")
    print(f"rbg train: losses {losses}; kernel and plain routes equal in "
          f"all {len(got)} tensors (tolerance 0)", flush=True)
    del plain, plain_vel, plain_run, got, want

    small = [(batches[0][0][:RBG_CPU_BATCH], batches[0][1][:RBG_CPU_BATCH])]
    first = {}
    for route, dev in (("card", "cuda"), ("cpu", "cpu")):
        model = build_rbg(SEED).to(dev)
        _, run = make_trainer(model)
        first[route] = (run(0, small[0]).item(), _exponents(model))
    check(math.isclose(first["card"][0], first["cpu"][0], rel_tol=1e-5)
          and first["card"][1] == first["cpu"][1],
          f"rbg: step 0 at batch {RBG_CPU_BATCH}: card loss "
          f"{first['card'][0]}, CPU {first['cpu'][0]}; exponents equal "
          f"{first['card'][1] == first['cpu'][1]}")
    print(f"rbg train: step 0 at batch {RBG_CPU_BATCH} on the card and on "
          f"the CPU: losses {first['card'][0]} / {first['cpu'][0]}, all "
          f"{len(first['cpu'][1])} exponents equal", flush=True)

    # host cost of one step's site keys under the unsafe_rbg key: one
    # Philox fold of the step, xored into the cached uid x site table
    from lbt_tpu_torch.dfxp import keys
    t1 = time.perf_counter()
    for i in range(50):
        keys.site_keys(keys.fold_in(keys.base_key(TRAIN_KEY_SEED,
                                                  "unsafe_rbg"), i),
                       card.num_layers(), 5)
    site_keys_us = (time.perf_counter() - t1) / 50 * 1e6
    print(f"rbg train: host time of one step's site-key table "
          f"({card.num_layers()} uids x 5 sites) {site_keys_us:.1f} us",
          flush=True)

    # rbg-int8 (the gated model, on from its last step) and prng-int8
    # (threefry), one step each in turns: host ms, then a profile each
    legs = {"rbg": {"run": card_run, "step": RBG_GATE_STEPS},
            "prng": {"run": make_trainer(
                build_rbg(SEED, "threefry2x32").to("cuda"))[1], "step": 0}}
    legs["prng"]["run"](0, batches[0])  # its first call's set-up
    legs["prng"]["step"] = 1
    times = {k: [] for k in legs}
    for name in ("rbg", "prng", "prng", "rbg") * (RBG_TIMED_STEPS // 2):
        leg = legs[name]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        leg["run"](leg["step"], batches[leg["step"] % len(batches)])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t1) * 1e3)
        leg["step"] += 1
    out = {"launches": launches, "mode4_launches": rbg, "losses": losses,
           "plain_losses": plain_losses, "first_loss_card": first["card"][0],
           "first_loss_cpu": first["cpu"][0], "k1_calls": k1,
           "conv_calls": conv, "batch": RBG_BATCH,
           "site_keys_us": site_keys_us}
    for name, leg in legs.items():
        med = statistics.median(times[name])
        before = train_counters(quant, gemm, fused)
        prof = _profile_steps(leg["run"], batches, leg["step"])
        calls = {k: v - before[k] for k, v in
                 train_counters(quant, gemm, fused).items()}
        one_launch_a_call(prof.pop("rows"), calls)
        out[name] = {"ms_per_step": med, "samples_ms": times[name],
                     "img_per_s": RBG_BATCH / med * 1e3, "profile": prof}
        print(f"rbg {name}-int8: median {med:.3f} ms a step of {RBG_BATCH}"
              f" ({RBG_BATCH / med * 1e3:.1f} img/s) over "
              f"{len(times[name])} steps in turns; profile: wall "
              f"{prof['wall_ms']:.2f} ms for 2 steps, device "
              f"{prof['device_ms']} ms (busy share {prof['busy_share']}), "
              f"kernels a step {prof['kernel_ms_per_step']}, "
              f"{prof['launches_per_step']} device launches a step",
              flush=True)
    return out


def _rbg_forms(quant, fused) -> dict:
    """Mode 4's counter-offset and column-window forms against their plain
    versions: a data-parallel eval rank's rows ``CHECK_ROW0..`` of a
    stage-1 BN input (K1 and #4: an offset that is a multiple of 4, a
    block serving four) and of the logits (K1: 30, a block an element);
    a tensor-parallel rank's slice: K1 at the last rank's half of
    stage 3's 3x3 weight (a block an element) and #4 / #5 at half of
    stage 3's output channels (a lane's block serving four)."""
    from lbt_tpu_torch.ops.im2col import conv_pads, out_hw
    gen = torch.Generator().manual_seed(SEED + 14)
    exp = torch.tensor(1, dtype=torch.int32, device="cuda")
    err, n = 0.0, 0

    def k1(shape, noise):
        nonlocal err, n
        x = (torch.randn(shape, generator=gen) * 2).cuda()
        got = quant.quantize_codes(x, 8, exp, noise, True)
        want = quant.quantize_codes_plain(x, 8, exp, noise, True)
        err = max(err, max(_max_err(g, w) for g, w in zip(got, want)))
        check(_equal_outputs(got, want), f"rbg: K1 differs from its plain "
              f"version at {shape} noise={noise}")
        n += 1

    def conv(kind, xshape, wshape, stride, noise_of_y):
        nonlocal err, n
        xc = torch.randint(-256, 256, xshape, generator=gen,
                           dtype=torch.int16).cuda()
        wc = torch.randint(-128, 128, wshape, generator=gen,
                           dtype=torch.int8).cuda()
        pads = conv_pads("SAME", xshape[1:3], wshape[:2], (stride,) * 2)
        ho, wo = out_hw(xshape[1], xshape[2], wshape[:2], (stride,) * 2,
                        pads)
        kw = dict(strides=(stride, stride), pads=pads,
                  noise=noise_of_y((xshape[0], ho, wo)))
        inv = torch.tensor([2.0 ** -14], device="cuda")
        mult = torch.tensor([2.0 ** -2], device="cuda")
        got = getattr(fused, kind)(xc, wc, inv, mult, **kw)
        want = fused.conv_fused_plain(xc, wc, inv, mult, **kw)
        for g, w in zip(got, want):
            err = max(err, _max_err(g, w))
            check(g.dtype == w.dtype and torch.equal(g, w), f"rbg: {kind} "
                  f"differs from its plain version at x {xshape} w "
                  f"{wshape} noise={kw['noise']}")
        n += 1

    rows = RBG_BATCH // 2
    k1((rows, 32, 32, 16),
       noise_of(quant, quant.RBG, (rows, 32, 32, 16), False, CHECK_ROW0))
    k1((rows, 10), noise_of(quant, quant.RBG, (rows, 10), False, CHECK_ROW0))
    conv("conv3x3_fused", (rows, 32, 32, 16), (3, 3, 16, 16), 1,
         lambda y: noise_of(quant, quant.RBG, (*y, 16), False, CHECK_ROW0))
    k1((3, 3, 64, 32),
       noise_of(quant, quant.RBG, (3, 3, 64, 64))._replace(n_global=64,
                                                            col0=32))
    for kind, xshape, wshape, stride in (
            ("conv3x3_fused", (RBG_BATCH, 8, 8, 64), (3, 3, 64, 32), 1),
            ("conv1x1_fused", (RBG_BATCH, 16, 16, 32), (1, 1, 32, 32), 2)):
        conv(kind, xshape, wshape, stride,
             lambda y: noise_of(quant, quant.RBG, (*y, 64))._replace(
                 n_global=64, col0=32))
    print(f"rbg forms: {n} offset and column-window calls of K1 and #4/#5 "
          f"in mode 4 equal their plain versions", flush=True)
    return {"max_abs_err": err, "calls": n}


# ---------------------------------------------------------------------------
# trainer: the port's entry point, python -m lbt_tpu_torch.main
# ---------------------------------------------------------------------------

# --faithful_eval: after 40 steps the BN running statistics lag the batch
# statistics (4% of the way from their init at --bn_momentum 0.999, 5-10%
# low in variance even at 0.9), and this net scores chance on them (0.092
# on the CPU at 0.999 and at 0.9).  Batch-statistic eval shows the learning.
TRAINER_ARGV = ["--model", "CIFAR10_Resnet20", "--bits", "8",
                "--noise_mode", "hash", "--batch_size", "128",
                "--n_train", "2560", "--n_test", "1000",
                "--lr_decay_epochs", "1", "--checkpoint_every", "1",
                "--log_every", "5", "--faithful_eval"]
# test accuracy after 2 epochs must exceed this (chance is 0.1); the same
# command line with --device cpu reached 0.274 after epoch 1 and 0.348
# after epoch 2
TRAINER_MIN_ACC = 0.25
# test images the final checkpoint re-evaluates on the CPU and the card
TRAINER_CPU_EVAL = 250
TRAINER_DIR = REPO / "experiments" / "smoke_trainer"


def _rows(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _trainer_state(trainer) -> dict:
    return {**{f"net.{k}": v for k, v in
               trainer.model.net.state_dict().items()},
            **{f"velocity.{k}": v for k, v in trainer.velocity.items()}}


def _sync_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_trainer(quant, gemm, fused, card: str, device: str = "cuda"
                  ) -> dict:
    """``lbt_tpu_torch.main.main`` at the full width and depth of
    ResNet-20, batch 128, 20 steps an epoch, augmentation on: 2 epochs
    (every launch counter reset just before; K1, K2's two forms, #4 and #5
    must each have launched), then 1 epoch and a resumed second in another
    directory, which must end bit for bit where the first run ended.  The
    logged loss must fall and the test accuracy pass TRAINER_MIN_ACC; the
    final checkpoint, loaded on the CPU, must evaluate as on the card at
    rtol 1e-5."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.main import main as train_main
    from lbt_tpu_torch.models import build_model
    from lbt_tpu_torch.train.trainer import Trainer
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    argv = TRAINER_ARGV + ["--device", device]

    reset_counters(quant, gemm, fused)
    run, run_ms = _sync_ms(lambda: train_main(
        argv + ["--n_epoch", "2", "--exp_path", str(TRAINER_DIR / "a")]))
    launches = train_counters(quant, gemm, fused)
    print(f"trainer: 2 epochs of 20 steps through lbt_tpu_torch.main in "
          f"{run_ms / 1e3:.1f} s; launches {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"{k} never launched on the trainer's path")

    rows = _rows(TRAINER_DIR / "a" / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    accs = [r["test/accuracy"] for r in rows if "test/accuracy" in r]
    stalls = [r["train/input_stall_frac"] for r in rows
              if "train/input_stall_frac" in r]
    check(len(losses) == 8 and all(math.isfinite(x) for x in losses),
          f"logged losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(len(accs) == 2 and accs[-1] > TRAINER_MIN_ACC,
          f"test accuracy {accs} after 2 epochs, bound {TRAINER_MIN_ACC}")
    epoch2 = run.epoch_time
    img_s = epoch2["images"] / epoch2["seconds"]

    final, eval_ms = _sync_ms(run.evaluate)
    n_eval_batches = math.ceil(len(run.dataset["test"][1]) /
                               run.tc.eval_batch_size)
    _, save_ms = _sync_ms(lambda: run.save(str(TRAINER_DIR / "timing")))
    quiet = logging.getLogger("chip_smoke.trainer")
    probe = Trainer(build_model("CIFAR10_Resnet20", run.model.cfg),
                    TrainConfig(checkpoint_dir=str(TRAINER_DIR / "timing")),
                    {}, logger=quiet, device=device)
    restored, restore_ms = _sync_ms(probe.maybe_restore)
    check(restored and probe.step == run.step, "timing restore failed")

    train_main(argv + ["--n_epoch", "1", "--exp_path",
                       str(TRAINER_DIR / "b")])
    resumed = train_main(argv + ["--n_epoch", "2", "--exp_path",
                                 str(TRAINER_DIR / "b")])
    log = (TRAINER_DIR / "b" / "experiment.log").read_text()
    check("Resumed from" in log and "@ step 20 (epoch 1)" in log,
          "the second run of b did not resume at step 20")
    got, want = _trainer_state(resumed), _trainer_state(run)
    check(set(got) == set(want), "resumed state has other tensors")
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    check(not diff, f"the resumed run differs from the uninterrupted one "
          f"in {diff[:5]} ({len(diff)} of {len(want)} tensors)")
    print(f"trainer: 1 epoch + resumed epoch equal the uninterrupted run "
          f"in all {len(want)} tensors (tolerance 0)", flush=True)

    # the CPU re-evaluates the first TRAINER_CPU_EVAL test images, and the
    # card the same ones
    subset = {**run.dataset, "test": tuple(
        a[:TRAINER_CPU_EVAL] for a in run.dataset["test"])}
    run.dataset = subset
    card_subset = run.evaluate()
    cpu = Trainer(build_model("CIFAR10_Resnet20", run.model.cfg),
                  TrainConfig(checkpoint_dir=str(TRAINER_DIR / "a" / "ckpt")),
                  subset, logger=quiet, device="cpu")
    check(cpu.maybe_restore() and cpu.step == run.step,
          "the card's checkpoint did not restore on the CPU")
    t0 = time.perf_counter()
    cpu_final = cpu.evaluate()
    cpu_eval_ms = (time.perf_counter() - t0) * 1e3
    for k in ("loss", "accuracy"):
        check(math.isclose(cpu_final[k], card_subset[k], rel_tol=1e-5),
              f"CPU re-evaluation {cpu_final} differs from the card's "
              f"{card_subset}")
    print(f"trainer: the card's final checkpoint evaluates the first "
          f"{TRAINER_CPU_EVAL} test images on the CPU "
          f"({cpu_eval_ms / 1e3:.1f} s) as on the card: card {card_subset}, "
          f"CPU {cpu_final}", flush=True)
    for d in ("a/ckpt", "b/ckpt", "timing"):
        shutil.rmtree(TRAINER_DIR / d, ignore_errors=True)

    scanned = _trainer_scanned(quant, gemm, fused, argv)
    defaults = _trainer_defaults(quant, gemm, fused, device)
    fp32 = _trainer_fp32(device)
    out = {"launches": launches, "losses": losses, "test_accuracy": accs,
           "scanned": scanned, "defaults": defaults, "fp32": fp32,
           "final_eval": final, "card_subset_eval": card_subset,
           "cpu_subset_eval": cpu_final,
           "epoch2": epoch2, "epoch2_img_per_s": img_s,
           "input_stall_frac": stalls, "eval_ms_per_batch":
           eval_ms / n_eval_batches, "eval_batch": run.tc.eval_batch_size,
           "checkpoint_save_ms": save_ms, "checkpoint_restore_ms": restore_ms,
           "run_s": run_ms / 1e3, "card": card}
    print(f"trainer: epoch 2 {img_s:.1f} img/s, input stall "
          f"{100 * stalls[-1]:.2f}% of the epoch, eval "
          f"{out['eval_ms_per_batch']:.1f} ms per batch of "
          f"{run.tc.eval_batch_size}, checkpoint save {save_ms:.1f} ms, "
          f"restore {restore_ms:.1f} ms ({card})", flush=True)
    return out


# the scanned CLI run: 10 steps of 128 in blocks of 4 (two blocks, then 2
# steps one by one); lbt_tpu logs a block's last step once log_every (5)
# steps have passed since the last log: after step 8 alone
SCAN_ARGV = ["--n_train", "1280", "--n_epoch", "1"]
SCAN_STEPS = 4
SCAN_LOGGED = [8]


def _trainer_scanned(quant, gemm, fused, argv) -> dict:
    """The trainer's command line for 10 steps with ``--scan_steps 4``
    (every launch counter reset just before; each kernel must launch)
    and without it: the two runs' final states (their checkpoints) equal
    bit for bit, the scanned run's train rows at ``SCAN_LOGGED``."""
    from lbt_tpu_torch.main import main as train_main
    runs, run_s, launches = {}, {}, {}
    for name, flags in (("eager", []),
                        ("scanned", ["--scan_steps", str(SCAN_STEPS)])):
        shutil.rmtree(TRAINER_DIR / name, ignore_errors=True)
        reset_counters(quant, gemm, fused)
        runs[name], ms = _sync_ms(lambda: train_main(
            argv + SCAN_ARGV + flags + ["--exp_path",
                                        str(TRAINER_DIR / name)]))
        launches[name] = train_counters(quant, gemm, fused)
        run_s[name] = ms / 1e3
    eager, scanned = runs["eager"], runs["scanned"]
    for k, v in launches["scanned"].items():
        check(v > 0, f"{k} never launched on the scanned trainer's path")
    check(scanned.scan_train_step is not None and eager.step == scanned.step
          == 10, f"scanned run: {scanned.step} steps, eager {eager.step}")
    got, want = _trainer_state(scanned), _trainer_state(eager)
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    check(set(got) == set(want) and not diff,
          f"the scanned run differs from the eager one in {diff[:5]} "
          f"({len(diff)} of {len(want)} tensors)")
    rows = _rows(TRAINER_DIR / "scanned" / "metrics.jsonl")
    steps = [r["step"] for r in rows if "train/loss" in r]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    check(steps == SCAN_LOGGED and all(math.isfinite(v) for v in losses),
          f"the scanned run logged train rows at steps {steps} "
          f"({losses}), lbt_tpu at {SCAN_LOGGED}")
    check(not any("train/input_stall_frac" in r for r in rows),
          "the scanned run wrote an input-stall row")
    print(f"trainer --scan_steps {SCAN_STEPS}: 10 steps in "
          f"{run_s['scanned']:.1f} s (eager {run_s['eager']:.1f} s), state "
          f"equal to the eager run's in all {len(want)} tensors, train "
          f"rows at steps {steps}; launches {launches['scanned']}",
          flush=True)
    for name in runs:
        shutil.rmtree(TRAINER_DIR / name / "ckpt", ignore_errors=True)
    return {"launches": launches["scanned"],
            "eager_launches": launches["eager"], "run_s": run_s["scanned"],
            "eager_run_s": run_s["eager"], "logged_steps": steps,
            "losses": losses}


def _trainer_defaults(quant, gemm, fused, device: str) -> dict:
    """The trainer's command line without ``--noise_mode``: main.py's
    default ``prng`` noise, ResNet-20 under the int8 engine (main.py's
    defaults but for the run's size), 1 epoch, every launch counter reset
    just before; K1, K2's two forms, #4 and #5 must each have launched,
    K1 and #4/#5 in threefry mode."""
    from lbt_tpu_torch.main import main as train_main
    argv = [a for a in TRAINER_ARGV if a not in ("--noise_mode", "hash")]
    check(len(argv) == len(TRAINER_ARGV) - 2, "TRAINER_ARGV changed shape")
    reset_counters(quant, gemm, fused)
    run, run_ms = _sync_ms(lambda: train_main(
        argv + ["--device", device, "--n_epoch", "1", "--exp_path",
                str(TRAINER_DIR / "defaults")]))
    launches = train_counters(quant, gemm, fused)
    threefry = threefry_counters(quant, fused)
    check(run.model.cfg.noise_mode == "prng", "the run's noise is not prng")
    for k, v in {**launches, **threefry}.items():
        check(v > 0, f"{k} never launched on the defaults' path")
    rows = _rows(TRAINER_DIR / "defaults" / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    check(losses and all(math.isfinite(x) for x in losses),
          f"logged losses {losses}")
    epoch = run.epoch_time
    img_s = epoch["images"] / epoch["seconds"]
    print(f"trainer defaults (no --noise_mode: prng, threefry): 1 epoch in "
          f"{run_ms / 1e3:.1f} s, {img_s:.1f} img/s, losses {losses}; "
          f"launches {launches}, in threefry mode {threefry}", flush=True)
    shutil.rmtree(TRAINER_DIR / "defaults" / "ckpt", ignore_errors=True)
    return {"launches": launches, "threefry_launches": threefry,
            "losses": losses, "img_per_s": img_s, "run_s": run_ms / 1e3}


FP32_STEPS = 2


def _trainer_fp32(device: str) -> dict:
    """``--bits 32`` (the FP32 arm: QuantConfig.fp32(), engine 'sim'),
    ResNet-20 at batch 128: ``FP32_STEPS`` steps on ``device`` and on the
    CPU from the same weights and batches; each loss equal at rtol
    1e-5."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.main import build_parser, quant_config
    from lbt_tpu_torch.models import build_model
    cfg = quant_config(build_parser().parse_args(["--bits", "32"]))
    check(cfg.engine == "sim" and cfg.bits_w == 32, f"--bits 32 gave {cfg}")
    batches = train_batches(FP32_STEPS)
    losses = {}
    for where in (device, "cpu"):
        model = build_model("CIFAR10_Resnet20", cfg,
                            weight_decay=TrainConfig().weight_decay)
        model = model.init(torch.Generator().manual_seed(SEED)).to(where)
        run = make_trainer(model)[1]
        losses[where] = [run(i, b).item() for i, b in enumerate(batches)]
    for a, b in zip(losses[device], losses["cpu"]):
        check(math.isfinite(a) and math.isclose(a, b, rel_tol=1e-5),
              f"--bits 32 losses: {device} {losses[device]}, CPU "
              f"{losses['cpu']}")
    print(f"trainer --bits 32 (fp32, sim): {FP32_STEPS} steps, losses on "
          f"{device} {losses[device]}, CPU {losses['cpu']}", flush=True)
    return {"losses": losses[device], "cpu_losses": losses["cpu"]}


# ---------------------------------------------------------------------------
# resnet50: the bench headline, ResNet-50 / 224 at batch 128
# ---------------------------------------------------------------------------

R50_IMAGE = 224
R50_CLASSES = 1000
R50_GATE_STEPS = 2      # kernel route vs plain route, bitwise
R50_TIMED_STEPS = 8     # at the bench's cadence, after the gate's steps
R50_CPU_BATCH = 8       # the first loss against the CPU route
R50_REQUESTS = 4


def r50_config():
    """``bench.py``'s headline: uniform(8, int8, hash1) with fused BN,
    controllers every 8th step, bf16 carriers, 8-bit conv activations;
    ``range_update_warmup_steps=0`` so the gate's steps run both cadence
    branches (step 0 on, 1-2 off)."""
    from lbt_tpu_torch.config import QuantConfig
    return dataclasses.replace(
        QuantConfig.uniform(8, engine="int8", noise_mode="hash1"),
        fused_bn=True, range_update_every=8, act_dtype="bf16",
        conv_act_extra=0, range_update_warmup_steps=0)


def build_resnet50(seed: int, serve: bool = False, cfg=None):
    """``Imagenet_Resnet50`` at full width and depth under the headline
    config (or ``cfg``), weights from ``seed``, the default recipe's
    weight decay; for serving, BN running statistics, gamma and beta
    randomized."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.models import build_model
    from lbt_tpu_torch.nn.norm import FusedBatchNorm
    gen = torch.Generator().manual_seed(seed)
    model = build_model("Imagenet_Resnet50", cfg or r50_config(),
                        num_classes=R50_CLASSES, image_size=R50_IMAGE,
                        weight_decay=TrainConfig().weight_decay).init(gen)
    if serve:
        with torch.no_grad():
            for layer in model.net.modules():
                if isinstance(layer, FusedBatchNorm):
                    layer.mean.normal_(0.0, 0.5, generator=gen)
                    layer.var.uniform_(0.5, 2.0, generator=gen)
                    layer.gamma.uniform_(0.5, 1.5, generator=gen)
                    layer.beta.normal_(0.0, 0.3, generator=gen)
    return model


def r50_batches(n: int) -> list:
    """``n`` seeded batches of 128 224x224x3 images, labels in 0..999."""
    rng = np.random.default_rng(SEED + 50)
    return [(torch.from_numpy(rng.standard_normal(
                (BATCH, R50_IMAGE, R50_IMAGE, 3), dtype=np.float32)),
             torch.from_numpy(rng.integers(0, R50_CLASSES, (BATCH,))))
            for _ in range(n)]


def phase_resnet50(qmod, qops, quant, gemm, fused) -> dict:
    """The bench headline on the card: train (gate, time, profile, the
    kernels at its shapes), then serve."""
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        out = _r50_train(qmod, qops, quant, gemm, fused)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    for tag, fn, args in (
            ("k1", phase_k1_train, (quant, out.pop("k1_calls"), FAST_REPS,
                                    "R50 K1", False, False)),
            ("k2", phase_k2_train, (gemm, out.pop("k2_calls"),
                                    out.pop("tn_calls"), R50_K2_REPS,
                                    "R50 K2")),
            ("fused", phase_fused, (fused, out.pop("conv_calls"),
                                    FAST_REPS, False, False)),
            ("conv_bwd", phase_conv_bwd, (qops, out.pop("bwd_calls"),
                                          FAST_REPS, "R50 conv-bwd"))):
        out[tag] = fn(*args)
    out["serve"] = _r50_serve(qmod, qops, quant, gemm)
    out["seconds"] = time.perf_counter() - t0
    print(f"resnet50: phase took {out['seconds']:.1f} s", flush=True)
    return out


def _r50_train(qmod, qops, quant, gemm, fused) -> dict:
    def launched(launches, threefry):
        for k, v in launches.items():
            check(v > 0, f"{k} never launched on ResNet-50's training path")

    # the calls of a step at the bench's cadence: one step in 8 with the
    # controllers on (step 0), seven with them off (step 1)
    return train_leg("resnet50", build_resnet50, R50_GATE_STEPS,
                     R50_TIMED_STEPS, (qmod, qops, quant, gemm, fused),
                     launched, ((0, 1 / 8), (1, 7 / 8)),
                     ("k1", "conv3x3", "conv1x1"), digest=True)


def train_leg(tag, build, gate_steps, timed_steps, modules, launched,
              record_steps, required, batches=None, digest=False,
              snapshot=False) -> dict:
    """One training leg from ``build``'s model on ``batches`` (default
    ``gate_steps`` of ResNet-50's, 224 px at batch 128): its kernel calls
    recorded (``record_steps``), ``gate_steps`` steps through the kernels
    (every counter reset just before; ``launched(launches,
    threefry_launches)`` checks them) equal to the same steps through the
    plain versions in every tensor, the first loss at batch
    ``R50_CPU_BATCH`` equal to the CPU route's at rtol 1e-5,
    ``timed_steps`` timed steps with the peak memory, and a 2-step profile
    (one launch a K1 and #4/#5 call; the kinds in ``required`` called).
    ``digest``: the result holds the kernel route's state after the gate
    (``gate_digest``), which phase tp's layout must reproduce;
    ``snapshot``: it holds the exponents and parameters after step 0 and
    after the gate (``gate_state``, host copies), which phase tp's leg
    (d) is held against."""
    qmod, qops, quant, gemm, fused = modules
    batches = batches or r50_batches(gate_steps)
    n_batch, image = batches[0][0].shape[0], batches[0][0].shape[1]
    probe = build(SEED).to("cuda")
    k1, k2, tn, conv, bwd = record_train_calls(
        qmod, qops, quant, gemm, fused, probe, batches[0],
        steps=record_steps)
    del probe

    card = build(SEED).to("cuda")
    card_vel, card_run = make_trainer(card)
    reset_counters(quant, gemm, fused)
    losses = []
    for i, b in enumerate(batches):
        losses.append(card_run(i, b).item())
        if snapshot and i == 0:
            exps0, params0 = _exponents(card), _host_params(card)
    torch.cuda.synchronize()
    launches = train_counters(quant, gemm, fused)
    threefry = threefry_counters(quant, fused)
    print(f"{tag} train: {gate_steps} steps of {n_batch} at {image} px "
          f"through the kernels; launches {launches}, in threefry mode "
          f"{threefry}", flush=True)
    launched(launches, threefry)
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")

    plain = build(SEED).to("cuda")
    plain_vel, plain_run = make_trainer(plain)
    with plain_route(qmod, qops, quant, gemm):
        plain_losses = [plain_run(i, b).item()
                        for i, b in enumerate(batches)]
    torch.cuda.synchronize()
    check(train_counters(quant, gemm, fused) == launches,
          "the plain route launched a kernel")
    check(plain_losses == losses,
          f"losses differ: kernels {losses}, plain {plain_losses}")
    got, want = _state(card, card_vel), _state(plain, plain_vel)
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    check(not diff, f"{tag}: the kernel and plain routes differ in "
          f"{diff[:5]} ({len(diff)} tensors)")
    print(f"{tag} train: losses {losses}; kernel and plain routes equal "
          f"in all {len(got)} tensors (tolerance 0)", flush=True)
    gate_digest = _digest(card, card_vel) if digest else None
    gate_state = {"exps": [exps0, _exponents(card)],
                  "params": [params0, _host_params(card)]} \
        if snapshot else None
    del plain, plain_vel, plain_run, got, want

    small = (batches[0][0][:R50_CPU_BATCH], batches[0][1][:R50_CPU_BATCH])
    card_first = first_loss(build(SEED).to("cuda"), small)
    cpu_first = first_loss(build(SEED), small)
    check(math.isclose(card_first, cpu_first, rel_tol=1e-5),
          f"first loss at batch {R50_CPU_BATCH}: card {card_first}, CPU "
          f"{cpu_first}")
    print(f"{tag} train: first loss at batch {R50_CPU_BATCH} on the card "
          f"{card_first}, CPU route {cpu_first}", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what is allocated when the timed steps start: this leg's model and
    # velocity, and whatever earlier phases still hold
    held = torch.cuda.memory_allocated()
    times, step = [], gate_steps
    for i in range(timed_steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        card_run(step, batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        step += 1
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    print(f"{tag} train: median {med:.3f} ms a step of {n_batch} over "
          f"{timed_steps} steps (steps {gate_steps}-{step - 1}), "
          f"{n_batch / med * 1e3:.1f} img/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f} GiB allocated "
          f"before the steps)", flush=True)

    before = train_counters(quant, gemm, fused)
    prof = _profile_steps(card_run, batches, step)
    calls = {k: v - before[k] for k, v in
             train_counters(quant, gemm, fused).items()}
    one_launch_a_call(prof.pop("rows"), calls, required)
    print(f"{tag} profile: 2 steps, wall {prof['wall_ms']:.2f} ms, "
          f"device kernels {prof['device_ms']} ms (busy share "
          f"{prof['busy_share']}); per step {prof['kernel_ms_per_step']}; "
          f"{prof['launches_per_step']} device launches a step", flush=True)
    return {"launches": launches, "threefry_launches": threefry,
            "losses": losses, "plain_losses": plain_losses,
            "first_loss_card": card_first, "first_loss_cpu": cpu_first,
            "ms_per_step": med, "img_per_s": n_batch / med * 1e3,
            "samples_ms": times, "max_memory_allocated": peak,
            "memory_allocated_before": held,
            "profile": prof, "k1_calls": k1, "k2_calls": k2,
            "tn_calls": tn, "conv_calls": conv, "bwd_calls": bwd,
            **({"gate_digest": gate_digest} if digest else {}),
            **({"gate_state": gate_state} if snapshot else {})}


def _exponents(model) -> dict:
    """Every exponent buffer of ``model``, as ints."""
    return {k: int(v) for k, v in model.net.named_buffers()
            if k.rsplit(".", 1)[-1].startswith("exp_")}


def _host_params(model, specs=None, tp=None) -> dict:
    """Host copies of ``model``'s parameters (with ``tp``, its slices
    gathered over the model group: a collective)."""
    params = dict(model.net.named_parameters())
    if tp is not None:
        from lbt_tpu_torch.parallel.mesh import gather_params
        params = gather_params(params, specs, tp)
    return {k: v.detach().cpu().clone() for k, v in params.items()}


def _r50_serve(qmod, qops, quant, gemm) -> dict:
    """``Predictor`` at batch 128, ResNet-50 with random weights and BN
    statistics: K1 and K2 launch (counts reset just before), logits of
    the kernel route equal the plain route's bitwise, labels too; ms a
    request of both routes in turns."""
    from lbt_tpu_torch.infer import Predictor
    from lbt_tpu_torch.nn.core import Ctx
    rng = np.random.default_rng(SEED + 51)
    requests = [rng.standard_normal((BATCH, R50_IMAGE, R50_IMAGE, 3),
                                    dtype=np.float32)
                for _ in range(R50_REQUESTS)]
    model = build_resnet50(SEED + 1, serve=True)
    predictor = Predictor(model, device="cuda")
    predictor(requests[0])
    torch.cuda.synchronize()
    quant.quantize_codes.launches = gemm.int8_matmul.launches = 0
    labels = [predictor(x).cpu() for x in requests]
    launches = {"k1": quant.quantize_codes.launches,
                "k2": gemm.int8_matmul.launches}
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"ResNet-50 serving launched {launches}")
    ctx = Ctx(train=False, update=False)
    with torch.inference_mode():
        for x, lab in zip(requests, labels):
            x = torch.from_numpy(x).cuda()
            got = model.apply(x, ctx)
            with plain_route(qmod, qops, quant, gemm):
                want = model.apply(x, ctx)
            check(got.shape == (BATCH, R50_CLASSES)
                  and bool(torch.isfinite(got.float()).all()),
                  f"bad ResNet-50 logits {tuple(got.shape)}")
            check(torch.equal(got, want), "ResNet-50 serving: kernel and "
                  "plain routes give other logits")
            check(torch.equal(lab, want.argmax(-1).cpu()),
                  "ResNet-50 serving: labels differ from the plain route")
    samples = {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        with (plain_route(qmod, qops, quant, gemm) if route == "plain"
              else contextlib.nullcontext()):
            for x in requests[:2]:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                predictor(x).cpu()
                samples[route].append((time.perf_counter() - t1) * 1e3)
    med = {r: statistics.median(v) for r, v in samples.items()}
    print(f"resnet50 serve: {R50_REQUESTS} requests of {BATCH}, launches "
          f"{launches}; logits and labels equal to the plain route; median "
          f"ms a request: kernel route {med['kernel']:.3f}, plain route "
          f"{med['plain']:.3f}", flush=True)
    return {"launches": launches, "ms_per_request": med,
            "samples_ms": samples}


# ---------------------------------------------------------------------------
# baseline50: bench.py's baseline leg, ResNet-50 / 224 at batch 128 under
# sim_bf16 with prng noise
# ---------------------------------------------------------------------------

B50_GATE_STEPS = 2      # kernel route vs plain route, bitwise
B50_TIMED_STEPS = 4
# phase baseline50's state after its gate (host copies), for phase tp's
# leg (d); kept out of the report
B50_GATE = {}


def b50_config():
    """``bench.py:305``'s baseline: ``uniform(8, engine="sim_bf16",
    noise_mode="prng")``: f32 carriers, unfused BN, 9-bit conv
    activations, the controllers every step; K1 in threefry mode at every
    site, the contractions in bf16 through cuDNN / cuBLAS."""
    from lbt_tpu_torch.config import QuantConfig
    return QuantConfig.uniform(8, engine="sim_bf16", noise_mode="prng")


def build_baseline50(seed: int, cfg=None):
    """``Imagenet_Resnet50`` at full width and depth under the baseline
    config (or ``cfg``), weights from ``seed``, the default recipe's
    weight decay."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.models import build_model
    return build_model("Imagenet_Resnet50", cfg or b50_config(),
                       num_classes=R50_CLASSES, image_size=R50_IMAGE,
                       weight_decay=TrainConfig().weight_decay).init(
                           torch.Generator().manual_seed(seed))


def first_loss(model, batch) -> float:
    """The loss of step 0's forward on ``batch``: the train step's
    context and key, no backward."""
    from lbt_tpu_torch.dfxp.keys import base_key, fold_in
    from lbt_tpu_torch.nn.core import Ctx
    x, y = (t.to(model.device) for t in batch)
    ctx = Ctx(train=True, key=fold_in(base_key(TRAIN_KEY_SEED,
                                               model_impl(model)), 0),
              update=True, sinks=model.make_sinks(),
              n_uids=model.num_layers())
    with torch.no_grad():
        return model.loss_and_acc(model.apply(x, ctx), y)[0].item()


def phase_baseline50(qmod, qops, quant, gemm, fused) -> dict:
    """The bench's baseline leg on the card: gate, time, profile, then K1
    at its step's shapes against its bound."""
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        out = _b50_train(qmod, qops, quant, gemm, fused)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    out["k1"] = phase_k1_train(quant, out.pop("k1_calls"), FAST_REPS,
                               "B50 K1", offsets=False)
    k1_dev = out["profile"]["kernel_ms_per_step"]["k1"]
    print(f"baseline50: K1 {k1_dev:.3f} ms of device time a step in the "
          f"profile ({out['k1']['ms']:.3f} replayed out of L2) against a "
          f"bound of {out['k1']['bound_ms']:.3f} ms by "
          f"{out['k1']['bound_by']}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"baseline50: phase took {out['seconds']:.1f} s", flush=True)
    return out


def _b50_train(qmod, qops, quant, gemm, fused) -> dict:
    def launched(launches, threefry):
        check(launches["k1"] > 0 and threefry["k1"] == launches["k1"],
              "K1 did not launch in threefry mode at every call of the "
              "baseline's path")

    out = train_leg("baseline50", build_baseline50, B50_GATE_STEPS,
                    B50_TIMED_STEPS, (qmod, qops, quant, gemm, fused),
                    launched, ((0, 1.0),), ("k1",), snapshot=True)
    B50_GATE.update(out.pop("gate_state"), losses=out["losses"])
    for k in ("k2_calls", "tn_calls", "conv_calls", "bwd_calls"):
        check(not out.pop(k), f"the baseline's path made {k}")
    return out


# ---------------------------------------------------------------------------
# remat: the BN memory options remat_bn and bn_residual_q16
# ---------------------------------------------------------------------------

REMAT_GATE_STEPS = 2    # each flag: kernel route vs plain route, bitwise
REMAT_FLAGS = ("off", "remat_bn", "bn_residual_q16")


def _flagged(cfg, flag: str):
    return cfg if flag == "off" else dataclasses.replace(cfg, **{flag: True})


def _remat_steps(model, batches, quant, gemm, fused) -> dict:
    """``batches`` steps of ``model`` through the kernels, every counter
    reset just before: the losses, the launches, the state after, and
    the last step's host ms and peak memory (``max_memory_allocated``,
    and above what was allocated when it started)."""
    vel, run = make_trainer(model)
    reset_counters(quant, gemm, fused)
    losses = []
    for i, b in enumerate(batches):
        if i == len(batches) - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
        losses.append(run(i, b).item())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return {"losses": losses, "launches": train_counters(quant, gemm, fused),
            "state": _state(model, vel), "host_ms": ms, "peak": peak,
            "peak_above_held": peak - held}


def phase_remat(qmod, qops, quant, gemm, fused, r50) -> dict:
    """``remat_bn`` and ``bn_residual_q16`` on the card.  (a) ResNet-20 at
    batch 128 under uniform(8, noise_mode='hash') (f32 carriers, unfused
    BN: both flags change what the BN layers save, q16 the backward's
    numbers): flags off, then each flag, ``REMAT_GATE_STEPS`` steps
    through the kernels (counters reset just before, each kernel
    launched) equal to the plain route's in every tensor; the state after
    remat_bn's steps equal to the flags-off state, and q16's first loss
    equal to the flags-off one (its forward is unchanged); host ms and
    peak memory of the last step.  (b) the headline (``r50``: phase
    resnet50's result) under bn_residual_q16, then remat_bn, then the
    flags off: 2 steps through the kernels, each run's state equal to
    phase resnet50's gate steps (bf16 carriers and fused BN: neither flag
    changes a bit); the peak memory of each run's second step."""
    from lbt_tpu_torch.config import QuantConfig
    t0 = time.perf_counter()
    out = {"resnet20": {}, "resnet50": {}}
    base = QuantConfig.uniform(8, noise_mode="hash")
    batches = train_batches(REMAT_GATE_STEPS)
    torch.use_deterministic_algorithms(True)
    try:
        for flag in REMAT_FLAGS:
            cfg = _flagged(base, flag)
            run = _remat_steps(build_train_model(SEED, cfg).to("cuda"),
                               batches, quant, gemm, fused)
            for k, v in run["launches"].items():
                check(v > 0, f"remat {flag}: {k} never launched")
            plain = build_train_model(SEED, cfg).to("cuda")
            plain_vel, plain_run = make_trainer(plain)
            with plain_route(qmod, qops, quant, gemm):
                plain_losses = [plain_run(i, b).item()
                                for i, b in enumerate(batches)]
            check(train_counters(quant, gemm, fused) == run["launches"],
                  f"remat {flag}: the plain route launched a kernel")
            want = _state(plain, plain_vel)
            diff = [k for k in want if not torch.equal(run["state"][k],
                                                       want[k])]
            check(plain_losses == run["losses"] and not diff,
                  f"remat {flag}: the kernel and plain routes differ in "
                  f"the losses {run['losses']} / {plain_losses} or in "
                  f"{diff[:5]} ({len(diff)} tensors)")
            del plain, plain_vel, plain_run, want
            out["resnet20"][flag] = run
            print(f"remat resnet20 {flag}: {REMAT_GATE_STEPS} steps of "
                  f"{BATCH}, kernel route == plain route in all "
                  f"{len(run['state'])} tensors; losses {run['losses']}; "
                  f"launches {run['launches']}; last step "
                  f"{run['host_ms']:.3f} ms, peak "
                  f"{run['peak'] / 2 ** 30:.4f} GiB "
                  f"({run['peak_above_held'] / 2 ** 30:.4f} above the "
                  f"allocated)", flush=True)
        r20 = out["resnet20"]
        off, remat = r20["off"]["state"], r20["remat_bn"]["state"]
        diff = [k for k in off if not torch.equal(off[k], remat[k])]
        check(not diff, f"remat_bn's steps differ from the flags-off "
              f"steps in {diff[:5]} ({len(diff)} tensors)")
        check(r20["bn_residual_q16"]["losses"][0] == r20["off"]["losses"][0],
              f"bn_residual_q16's first loss "
              f"{r20['bn_residual_q16']['losses'][0]} differs from the "
              f"flags-off one {r20['off']['losses'][0]}")
        q16 = r20["bn_residual_q16"]["state"]
        out["resnet20"]["q16_tensors_moved"] = sum(
            not torch.equal(off[k], q16[k]) for k in off)
        print(f"remat resnet20: remat_bn's state == the flags-off state in "
              f"all {len(off)} tensors; bn_residual_q16's first loss == "
              f"the flags-off one, {out['resnet20']['q16_tensors_moved']} "
              f"tensors moved after {REMAT_GATE_STEPS} steps", flush=True)
        for run in r20.values():
            if isinstance(run, dict):
                run.pop("state")
        del off, remat, q16

        r50_batches_ = r50_batches(REMAT_GATE_STEPS)
        # the flags-off run last: a difference in peak memory that the
        # allocator's state after the earlier runs makes shows there
        for flag in ("bn_residual_q16", "remat_bn", "off"):
            model = build_resnet50(SEED, cfg=_flagged(r50_config(), flag))
            run = _remat_steps(model.to("cuda"), r50_batches_, quant, gemm,
                               fused)
            del model
            for k, v in run["launches"].items():
                check(v > 0, f"remat resnet50 {flag}: {k} never launched")
            digest = _sha256s(run.pop("state"))
            diff = [k for k in r50["gate_digest"]
                    if digest.get(k) != r50["gate_digest"][k]]
            check(not diff, f"remat resnet50 {flag}: the state differs "
                  f"from phase resnet50's gate steps in {diff[:5]} "
                  f"({len(diff)} tensors)")
            out["resnet50"][flag] = run
            print(f"remat resnet50 {flag}: {REMAT_GATE_STEPS} steps == "
                  f"phase resnet50's in all {len(digest)} tensors; "
                  f"launches {run['launches']}; second step "
                  f"{run['host_ms']:.3f} ms, peak "
                  f"{run['peak'] / 2 ** 30:.4f} GiB "
                  f"({run['peak_above_held'] / 2 ** 30:.4f} above the "
                  f"allocated; phase resnet50's timed steps "
                  f"{r50['max_memory_allocated'] / 2 ** 30:.4f} GiB)",
                  flush=True)
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    out["seconds"] = time.perf_counter() - t0
    print(f"remat: phase took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# vgg16: configuration V, VGG-16 / CIFAR-100 at batch 256 under int4w-int8a
# ---------------------------------------------------------------------------

V_BATCH = 256
V_CLASSES = 100
V_GATE_STEPS = 2        # kernel route vs plain route, bitwise
V_TIMED_STEPS = 8
V_REQUESTS = 4          # serving requests of BATCH (128) images
V_DIR = REPO / "experiments" / "smoke_vgg16"
V_TRAIN_STEPS = 10      # the Trainer's run: 1 epoch of 10 steps of 256


def v_config():
    """``benchmarks/vgg_bench.py``'s ``int4w-int8a``: uniform(8, int8,
    hash) with 4-bit weights; 8-bit biases, BN parameters and gradients,
    9-bit conv activations, unfused BN, controllers every step."""
    from lbt_tpu_torch.config import QuantConfig
    return dataclasses.replace(
        QuantConfig.uniform(8, engine="int8", noise_mode="hash"), bits_w=4)


def build_vgg16(seed: int):
    """``VGG16_CIFAR100`` at full width and depth under V's config,
    weights from ``seed``, the default recipe's weight decay, dropout at
    keep 0.5."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.models import build_model
    return build_model("VGG16_CIFAR100", v_config(),
                       weight_decay=TrainConfig().weight_decay).init(
                           torch.Generator().manual_seed(seed))


def v_batches(n: int) -> list:
    """``n`` seeded batches of 32x32x3 images, labels in 0..99."""
    rng = np.random.default_rng(SEED + 16)
    return [(torch.from_numpy(rng.standard_normal((V_BATCH, 32, 32, 3),
                                                  dtype=np.float32)),
             torch.from_numpy(rng.integers(0, V_CLASSES, (V_BATCH,))))
            for _ in range(n)]


def phase_vgg16(qmod, qops, quant, gemm, fused) -> dict:
    """Configuration V on the card: train (gate, time, profile, the
    kernels at its shapes, the Dropout mask), then a Trainer on its config,
    whose checkpoint is folded, exported, restored and served."""
    t0 = time.perf_counter()

    def launched(launches, threefry):
        for k in ("k1", "k2", "k2_tn", "conv3x3", "dgrad", "wgrad"):
            check(launches[k] > 0, f"{k} never launched on VGG-16's "
                  f"training path")

    torch.use_deterministic_algorithms(True)
    try:
        out = train_leg("vgg16", build_vgg16, V_GATE_STEPS, V_TIMED_STEPS,
                        (qmod, qops, quant, gemm, fused), launched,
                        ((0, 1.0),), ("k1", "conv3x3"),
                        batches=v_batches(V_GATE_STEPS))
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    out["k1"] = phase_k1_train(quant, out.pop("k1_calls"), FAST_REPS, "V K1")
    out["k2"] = phase_k2_train(gemm, out.pop("k2_calls"),
                               out.pop("tn_calls"), R50_K2_REPS, "V K2")
    out["fused"] = phase_fused(fused, out.pop("conv_calls"), FAST_REPS)
    out["conv_bwd"] = phase_conv_bwd(qops, out.pop("bwd_calls"), FAST_REPS,
                                     "V conv-bwd")
    out["dropout"] = _v_dropout()
    torch.cuda.empty_cache()
    out["deploy"] = _v_deploy(qmod, qops, quant, gemm, fused)
    out["seconds"] = time.perf_counter() - t0
    print(f"vgg16: phase took {out['seconds']:.1f} s", flush=True)
    return out


def _v_dropout() -> dict:
    """V's Dropout mask (its two layers: 256 x 512 each) drawn on the card
    by the plain threefry in torch ops: equal to the CPU's bitwise in f32
    and bf16 carriers, its device ms a layer (graph replays, f32)."""
    from lbt_tpu_torch.dfxp.keys import base_key
    from lbt_tpu_torch.nn.core import Ctx
    from lbt_tpu_torch.nn.layers import Dropout
    layer = Dropout(keep=0.5)
    layer.uid = 43
    ctx = Ctx(train=True, key=base_key(TRAIN_KEY_SEED))
    x = torch.randn(V_BATCH, 512, generator=torch.Generator().manual_seed(3))
    for dtype in (torch.float32, torch.bfloat16):
        got = layer(x.to(dtype).cuda(), ctx)
        check(got.dtype == dtype and torch.equal(got.cpu(),
                                                  layer(x.to(dtype), ctx)),
              f"the Dropout mask on the card differs from the CPU's "
              f"({dtype})")
    ms = device_ms(lambda t: layer(t, ctx), [(x.cuda(),)])
    print(f"vgg16 dropout: masks of {V_BATCH}x512 equal to the CPU's (f32, "
          f"bf16); {ms * 1e3:.1f} us of device time a layer (plain threefry "
          f"in torch ops), 2 layers a step", flush=True)
    return {"ms_per_layer": ms, "layers_per_step": 2}


def _v_deploy(qmod, qops, quant, gemm, fused) -> dict:
    """V trained by a ``Trainer`` on its config (10 steps of 256 on
    CIFAR-100-shaped data, augmentation on, counters reset just before,
    each kernel of the path launched, loss finite),
    then its checkpoint served: ``Predictor.from_checkpoint(fold_bn=True)``
    through the kernels (K1, K2 launched) with logits equal to the folded
    model's plain route bitwise; the export's size against f32; the
    restored export served with the same logits; the share of labels the
    folded and unfolded models agree on (recorded); ms a request of 128."""
    from lbt_tpu_torch import convert, infer
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.data.datasets import load_dataset, make_augment
    from lbt_tpu_torch.nn.core import Ctx
    from lbt_tpu_torch.train.trainer import Trainer
    shutil.rmtree(V_DIR, ignore_errors=True)
    tc = TrainConfig(batch_size=V_BATCH, n_epoch=1, log_every=5,
                     checkpoint_dir=str(V_DIR / "ckpt"))
    run = Trainer(build_vgg16(SEED), tc,
                  load_dataset("cifar100", n_train=V_TRAIN_STEPS * V_BATCH,
                               n_test=512),
                  augment=make_augment("cifar100"),
                  logdir=str(V_DIR), device="cuda")
    reset_counters(quant, gemm, fused)
    _, run_ms = _sync_ms(run.train)
    run.metrics.close()
    launches = train_counters(quant, gemm, fused)
    check(run.step == V_TRAIN_STEPS, f"V's Trainer took {run.step} steps")
    for k in ("k1", "k2", "k2_tn", "conv3x3", "dgrad", "wgrad"):
        check(launches[k] > 0, f"{k} never launched in V's Trainer run")
    rows = _rows(V_DIR / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    check(losses and all(math.isfinite(x) for x in losses),
          f"V's logged losses {losses}")
    epoch = run.epoch_time
    img_s = epoch["images"] / epoch["seconds"]
    print(f"vgg16 trainer: 1 epoch of {run.step} steps through "
          f"Trainer.train in {run_ms / 1e3:.1f} s, {img_s:.1f} img/s; "
          f"losses {losses}; launches {launches}", flush=True)

    ckpt_dir = V_DIR / "ckpt"
    folded = infer.Predictor.from_checkpoint(build_vgg16(SEED + 1), ckpt_dir,
                                             fold_bn=True, device="cuda")
    unfolded = infer.Predictor.from_checkpoint(build_vgg16(SEED + 1),
                                               ckpt_dir, device="cuda")
    rng = np.random.default_rng(SEED + 17)
    requests = [rng.standard_normal((BATCH, 32, 32, 3), dtype=np.float32)
                for _ in range(V_REQUESTS)]
    folded(requests[0])
    torch.cuda.synchronize()
    quant.quantize_codes.launches = gemm.int8_matmul.launches = 0
    labels = [folded(x).cpu() for x in requests]
    serve_launches = {"k1": quant.quantize_codes.launches,
                      "k2": gemm.int8_matmul.launches}
    check(serve_launches["k1"] > 0 and serve_launches["k2"] > 0,
          f"V's folded serving launched {serve_launches}")

    exported = infer.export_quantized_weights(folded.model)
    qb, fb = infer.exported_nbytes(exported)
    check(qb < 0.3 * fb, f"the export holds {qb} bytes against {fb} as f32")
    served = infer.Predictor(infer.fold_batchnorm(build_vgg16(SEED + 1)),
                             infer.restore_quantized_weights(exported),
                             convert.to_jax_numpy(folded.model)[1],
                             device="cuda")
    ctx = Ctx(train=False, update=False)
    agree = []
    with torch.inference_mode():
        for x, lab in zip(requests, labels):
            x = torch.from_numpy(x).cuda()
            got = folded.model.apply(x, ctx)
            with plain_route(qmod, qops, quant, gemm):
                want = folded.model.apply(x, ctx)
            check(got.shape == (BATCH, V_CLASSES)
                  and bool(torch.isfinite(got).all()),
                  f"bad folded VGG-16 logits {tuple(got.shape)}")
            check(torch.equal(got, want), "V's folded serving: kernel and "
                  "plain routes give other logits")
            check(torch.equal(lab, want.argmax(-1).cpu()),
                  "V's folded serving: labels differ from the plain route")
            check(torch.equal(served.model.apply(x, ctx), got),
                  "the restored export serves other logits")
            agree.append((unfolded(x).cpu() == lab).float().mean().item())
    agreement = statistics.mean(agree)

    samples = {"folded": [], "unfolded": []}
    for route in ("folded", "unfolded", "unfolded", "folded"):
        pred = folded if route == "folded" else unfolded
        for x in requests[:2]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred(x).cpu()
            samples[route].append((time.perf_counter() - t1) * 1e3)
    med = {r: statistics.median(v) for r, v in samples.items()}
    print(f"vgg16 serve: Predictor.from_checkpoint(fold_bn=True) on the "
          f"Trainer's checkpoint, {V_REQUESTS} requests of {BATCH}, launches "
          f"{serve_launches}; logits equal to the folded plain route and "
          f"to the restored export's; export {qb} bytes against {fb} as "
          f"f32 ({fb / qb:.2f}x smaller); folded and unfolded labels agree "
          f"on {agreement:.4f}; median ms a request: folded "
          f"{med['folded']:.3f}, unfolded {med['unfolded']:.3f}", flush=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"trainer_launches": launches, "trainer_losses": losses,
            "trainer_img_per_s": img_s, "trainer_run_s": run_ms / 1e3,
            "serve_launches": serve_launches, "exported_bytes": qb,
            "f32_bytes": fb, "label_agreement": agreement,
            "ms_per_request": med, "samples_ms": samples}


# ---------------------------------------------------------------------------
# zoo: the reference's small models and the gradient buffer through the CLI
# ---------------------------------------------------------------------------

ZOO_ARGV = ["--batch_size", "128", "--n_train", "512", "--n_test", "256",
            "--n_epoch", "1", "--log_every", "2", "--checkpoint_every", "1"]
# (model, flags, kernels of its path): main.py's defaults (prng noise,
# dropout keep 0.5) for the three small models
ZOO_RUNS = (
    ("PI_MNIST", [], ("k1", "k2", "k2_tn")),
    ("MNIST", [], ("k1", "k2", "k2_tn")),
    ("CIFAR10", [], ("k1", "k2", "k2_tn")),
    ("CIFAR10_VGG", ["--bits_w", "4", "--bits_a", "8"],
     ("k1", "k2", "k2_tn")),
    ("CIFAR10_Resnet20", ["--gradient_buffer", "--noise_mode", "hash"],
     ("k1", "k2", "k2_tn", "conv3x3", "conv1x1")),
)
ZOO_DIR = REPO / "experiments" / "smoke_zoo"


def phase_zoo(quant, gemm, fused) -> dict:
    """Each of ``ZOO_RUNS`` through ``lbt_tpu_torch.main`` on the card, 4
    steps of 128 and an eval, every counter reset just before: the loss
    finite, each kernel of the path launched (K1 in threefry mode under
    ``prng``); the gradient-buffer run's buffers nonzero."""
    from lbt_tpu_torch.main import main as train_main
    from lbt_tpu_torch.nn.layers import GradientBuffer
    t0 = time.perf_counter()
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    out = {}
    for name, flags, kernels in ZOO_RUNS:
        reset_counters(quant, gemm, fused)
        run, run_ms = _sync_ms(lambda: train_main(
            ["--model", name] + flags + ZOO_ARGV
            + ["--device", "cuda", "--exp_path", str(ZOO_DIR / name)]))
        launches = train_counters(quant, gemm, fused)
        threefry = threefry_counters(quant, fused)
        for k in kernels:
            check(launches[k] > 0, f"{k} never launched in the {name} run")
        if run.model.cfg.noise_mode == "prng":
            check(threefry["k1"] > 0, f"{name}: K1 never in threefry mode")
        rows = _rows(ZOO_DIR / name / "metrics.jsonl")
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        test = [r["test/loss"] for r in rows if "test/loss" in r]
        check(losses and test and all(math.isfinite(x)
                                      for x in losses + test),
              f"{name}: losses {losses}, test {test}")
        bufs = [la.buffer for la in run.model.net.modules()
                if isinstance(la, GradientBuffer)]
        check(len(bufs) == (2 if "--gradient_buffer" in flags else 0)
              and all(b.abs().sum().item() > 0 for b in bufs),
              f"{name}: gradient buffers {[b.abs().sum() for b in bufs]}")
        out[name] = {"launches": launches, "threefry_launches": threefry,
                     "losses": losses, "test_loss": test, "run_s":
                     run_ms / 1e3, "step": run.step,
                     "gradient_buffers": len(bufs)}
        print(f"zoo {name} {' '.join(flags)}: {run.step} steps of 128 in "
              f"{run_ms / 1e3:.1f} s through lbt_tpu_torch.main, losses "
              f"{losses}, test loss {test}; launches {launches}, in "
              f"threefry mode {threefry}"
              + (f"; {len(bufs)} gradient buffers nonzero" if bufs else ""),
              flush=True)
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"zoo: phase took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase records: the headline fed from TFRecord shards and an ImageFolder
# tree, the native loader, --debug_nans
# ---------------------------------------------------------------------------

R_TRAIN, R_VAL = 1280, 300   # 10 steps of 128; a ragged eval batch
R_SHARDS = 4
R_DIR = REPO / "experiments" / "smoke_records"
# bench.py's headline through main.py's flags
R_HEADLINE = ["--model", "Imagenet_Resnet50", "--batch_size", "128",
              "--engine", "int8", "--noise_mode", "hash1", "--fused_bn",
              "--range_update_every", "8", "--act_dtype", "bf16",
              "--conv_act_extra", "0"]
R_RUN = ["--n_epoch", "1", "--log_every", "5", "--device", "cuda"]
R_IMAGEFOLDER_WORKERS = 8


def _lerp(a: np.ndarray, n: int, axis: int) -> np.ndarray:
    """``a``, a grid of points 8 px apart along ``axis``, linearly
    interpolated at ``n`` pixels."""
    pos = np.arange(n, dtype=np.float32) / 8
    i0 = pos.astype(np.intp)
    f = (pos - i0).reshape([-1 if k == axis else 1 for k in range(a.ndim)])
    return np.take(a, i0, axis) * (1 - f) + np.take(a, i0 + 1, axis) * f


def records_image(i: int) -> np.ndarray:
    """Image ``i`` of the records corpus, from its own seed: ImageNet's
    shapes (short side 333-500 px, aspect 3/4-4/3), a random field on an
    8-px grid, interpolated, plus uniform noise, so that a JPEG of it at
    quality 90 runs about 65-145 KB, as ImageNet's files do."""
    rng = np.random.default_rng([SEED, 9, i])
    short = int(rng.integers(333, 501))
    aspect = float(np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3))))
    h, w = ((short, round(short * aspect)) if aspect >= 1
            else (round(short / aspect), short))
    grid = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3)).astype(
        np.float32)
    base = _lerp(_lerp(grid, h, 0), w, 1)
    noise = rng.integers(-20, 21, (h, w, 3), dtype=np.int16)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def write_records_part(part: dict) -> dict:
    """Worker of :func:`write_records`: the images ``part["indices"]``
    with their labels, as JPEG files in the ImageFolder tree (with PIL)
    and as one TFRecord shard (JPEG records, or raw uint8 records without
    PIL), as ``part`` asks."""
    import io
    from lbt_tpu_torch.data.tfrecord import TFRecordWriter, make_example
    writer = TFRecordWriter(part["shard"]) if part["shard"] else None
    nbytes = 0
    try:
        for i, label in zip(part["indices"], part["labels"]):
            arr = records_image(i)
            if part["pil"]:
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG", quality=90)
                data = buf.getvalue()
                nbytes += len(data)
                if part["tree"]:
                    Path(part["tree"], f"n{label:04d}",
                         f"{i:05d}.jpeg").write_bytes(data)
                record = make_example(data, label)
            else:
                record = make_example(arr.tobytes(), label, *arr.shape[:2])
            if writer is not None:
                writer.write(record)
    finally:
        if writer is not None:
            writer.close()
    return {"images": len(part["indices"]), "jpeg_bytes": nbytes}


def write_records(legs: dict) -> dict:
    """The corpus of phase records under ``R_DIR``, from the seed: R_TRAIN
    training images (labels over the head's classes) as R_SHARDS TFRecord
    shards and as ``tree/train/<class>/``, R_VAL validation images as one
    shard and ``tree/val/<class>/``; every class directory exists in both
    trees, so the two give the shards' labels.  One worker process a
    shard, started together."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    rng = np.random.default_rng(SEED + 9)
    labels = rng.integers(0, R50_CLASSES, R_TRAIN + R_VAL)
    tree = R_DIR / "tree"
    if legs["imagefolder"]:
        for split in ("train", "val"):
            for c in range(R50_CLASSES):
                (tree / split / f"n{c:04d}").mkdir(parents=True)
    bounds = np.linspace(0, R_TRAIN, R_SHARDS + 1).astype(int)
    spans = [("train", f"train-{s:02d}-of-{R_SHARDS:02d}", bounds[s],
              bounds[s + 1]) for s in range(R_SHARDS)]
    spans.append(("val", "val-00-of-01", R_TRAIN, R_TRAIN + R_VAL))
    parts = [{"indices": list(range(lo, hi)),
              "labels": [int(v) for v in labels[lo:hi]],
              "shard": (str(R_DIR / f"{name}.tfrecord") if legs["tfrecord"]
                        else None),
              "tree": str(tree / split) if legs["imagefolder"] else None,
              "pil": legs["pil"]} for split, name, lo, hi in spans]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            len(parts), mp_context=multiprocessing.get_context("spawn")
            ) as pool:
        done = list(pool.map(write_records_part, parts))
    seconds = time.perf_counter() - t0
    n = sum(d["images"] for d in done)
    jpeg = sum(d["jpeg_bytes"] for d in done)
    out = {"images": n, "seconds": seconds, "classes": R50_CLASSES,
           "jpeg_kb_mean": jpeg / n / 1e3 if jpeg else None,
           "train_labels": labels[:R_TRAIN], "val_labels": labels[R_TRAIN:]}
    print(f"records data: {R_TRAIN} + {R_VAL} images (labels over "
          f"{len(np.unique(labels))} of {R50_CLASSES} classes) in "
          f"{seconds:.1f} s, " + (f"JPEG quality 90, {out['jpeg_kb_mean']:.1f}"
                                  f" KB an image" if jpeg else "raw records")
          + (f"; {R_SHARDS} + 1 TFRecord shards" if legs["tfrecord"]
             else "") + ("; an ImageFolder tree" if legs["imagefolder"]
                         else ""), flush=True)
    return out


def probe_host() -> dict:
    """What the input sources need on this machine: ``g++`` (the host
    libraries), libjpeg's header and library (the TFRecord pipeline) and
    PIL (ImageFolder decode, JPEG writing)."""
    gxx = shutil.which("g++")
    header = link = False
    if gxx:
        header = subprocess.run(
            [gxx, "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
            capture_output=True, text=True).returncode == 0
        src = R_DIR / "probe.cc"
        src.write_text("int main() { return 0; }\n")
        link = subprocess.run(
            [gxx, str(src), "-ljpeg", "-o", str(R_DIR / "probe")],
            capture_output=True).returncode == 0
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    out = {"gxx": gxx, "jpeglib_h": header, "ljpeg": link, "pil": pil}
    legs = {"native": bool(gxx), "tfrecord": bool(gxx and header and link),
            "imagefolder": pil is not None, "pil": pil is not None}
    print(f"records probe: g++ {gxx or 'not found'}; jpeglib.h through "
          f"g++ -E {'found' if header else 'not found'}; -ljpeg "
          f"{'links' if link else 'does not link'}; PIL "
          f"{pil or 'not importable'}", flush=True)
    for leg, need in (("native", "g++"),
                      ("tfrecord", "g++, jpeglib.h and -ljpeg"),
                      ("imagefolder", "PIL")):
        if not legs[leg]:
            print(f"records: the {leg} leg does not run here: it needs "
                  f"{need}", flush=True)
    return {"probe": out, "legs": legs}


def source_rate(batches) -> dict:
    """img/s of one epoch of a source alone, no model."""
    t0 = time.perf_counter()
    n = sum(len(y) for _, y in batches)
    seconds = time.perf_counter() - t0
    return {"images": n, "seconds": seconds, "img_per_s": n / seconds}


@contextlib.contextmanager
def cli_probe():
    """Inside, the Trainer's train step notes the host clock at each
    return (no sync: the headline's step is host-bound), and its eval step
    the batch size of each call."""
    import lbt_tpu_torch.train.trainer as trainer_mod
    marks, evals = [], []
    real_train, real_eval = (trainer_mod.make_train_step,
                             trainer_mod.make_eval_step)

    def make_train_step(model, tc):
        step = real_train(model, tc)

        def timed(*args):
            out = step(*args)
            marks.append(time.perf_counter())
            return out
        return timed

    def make_eval_step(model, faithful_eval=False):
        step = real_eval(model, faithful_eval=faithful_eval)

        def counted(model, x, y, key):
            evals.append(int(x.shape[0]))
            return step(model, x, y, key)
        return counted

    with mock.patch.object(trainer_mod, "make_train_step", make_train_step), \
            mock.patch.object(trainer_mod, "make_eval_step", make_eval_step):
        yield marks, evals


def _host_pins() -> dict:
    s = torch.cuda.host_memory_stats()
    return {"blocks_created": s.get("num_host_alloc"),
            "handouts": s.get("active_requests.allocated")}


def records_cli(tag, argv, quant, gemm, fused, n_val) -> dict:
    """``lbt_tpu_torch.main`` on the card with ``argv``, every launch
    counter reset just before: each kernel launched; the logged losses
    finite; each eval covering all ``n_val`` images in ragged batches.
    Then the run's eval timed again, and 2 more steps on batches of its
    source in a profiler window: the kernels' names, one launch a K1 and
    #4/#5 call, the busy share."""
    from lbt_tpu_torch.data.pipeline import batch_iterator
    from lbt_tpu_torch.main import main as train_main
    exp = R_DIR / tag.replace(" ", "_")
    pins = _host_pins()
    reset_counters(quant, gemm, fused)
    with cli_probe() as (marks, evals):
        run, run_ms = _sync_ms(lambda: train_main(
            argv + ["--exp_path", str(exp)]))
    launches = train_counters(quant, gemm, fused)
    pins = {k: (v - pins[k] if v is not None and pins[k] is not None
                else None) for k, v in _host_pins().items()}
    for k, v in launches.items():
        check(v > 0, f"{tag}: {k} never launched")
    rows = _rows(exp / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    stall = [r["train/input_stall_frac"] for r in rows
             if "train/input_stall_frac" in r]
    check(losses and all(math.isfinite(x) for x in losses),
          f"{tag}: logged losses {losses}")
    bs = run.tc.eval_batch_size
    per_eval = [min(bs, n_val - lo) for lo in range(0, n_val, bs)]
    check(per_eval[-1] < bs, f"{tag}: no ragged eval batch of {bs}")
    check(evals and evals == per_eval * (len(evals) // len(per_eval)),
          f"{tag}: eval batches {evals}, want {per_eval} an eval")
    epoch = run.epoch_time
    steps = len(marks)
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    final, eval_ms = _sync_ms(run.evaluate)

    lr = run.tc.lr
    if run.native is not None:
        src = run.native.epoch(1)
    elif "train_iter" in run.dataset:
        src = run.dataset["train_iter"](1, run.tc.batch_size)
    else:
        src = batch_iterator(*run.dataset["train"], run.tc.batch_size,
                             epoch=1)
    batches = [tuple(torch.from_numpy(a).cuda() for a in b)
               for _, b in zip(range(2), src)]
    del src

    def one(step, batch):
        return run.train_step(run.model, run.velocity, batch[0], batch[1],
                              step, lr, run.base_key)["loss"]
    reset_counters(quant, gemm, fused)
    prof = _profile_steps(one, batches, run.step)
    calls = train_counters(quant, gemm, fused)
    one_launch_a_call(prof.pop("rows"), calls)
    check(all(v > 0 for v in prof["kernel_ms_per_step"].values()),
          f"{tag}: a kernel took no device time in the profile: "
          f"{prof['kernel_ms_per_step']}")
    out = {"launches": launches, "losses": losses, "steps": steps,
           "img_per_s": epoch["images"] / epoch["seconds"],
           "epoch_seconds": epoch["seconds"],
           "input_stall_frac": stall[-1] if stall else None,
           "stall_seconds": epoch["stall_seconds"],
           "ms_per_step": statistics.median(gaps) if gaps else None,
           "step_gaps_ms": gaps, "eval_batches": evals,
           "eval_ms": eval_ms, "final_eval": final, "run_s": run_ms / 1e3,
           "pinned": pins, "profile": prof}
    print(f"{tag}: {steps} steps in {epoch['seconds']:.2f} s, "
          f"{out['img_per_s']:.1f} img/s, input stall "
          f"{100 * (out['input_stall_frac'] or 0):.2f}% of the epoch, "
          f"median {out['ms_per_step']:.1f} ms between step returns; "
          f"losses {losses}; eval of {n_val} in batches {per_eval} "
          f"{eval_ms:.1f} ms; launches {launches}; pinned blocks created "
          f"{pins['blocks_created']} for {pins['handouts']} handouts; "
          f"profile: kernels' device ms a step "
          f"{prof['kernel_ms_per_step']}, busy {prof['busy_share']}",
          flush=True)
    shutil.rmtree(exp / "ckpt", ignore_errors=True)
    del run, batches
    torch.cuda.empty_cache()
    return out


def phase_records(quant, gemm, fused, headline_ms: float) -> dict:
    """The headline trained through ``lbt_tpu_torch.main`` from TFRecord
    shards and from an ImageFolder tree of ImageNet-like JPEGs written
    from a seed, each source also timed alone; ResNet-20 through the C++
    loader (the loss must fall); ``--debug_nans``.  A leg whose
    prerequisite is missing here does not run, and the phase says so; the
    data is deleted after."""
    t0 = time.perf_counter()
    shutil.rmtree(R_DIR, ignore_errors=True)
    R_DIR.mkdir(parents=True)
    try:
        out = _records(quant, gemm, fused, headline_ms)
    finally:
        shutil.rmtree(R_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"records: phase took {out['seconds']:.1f} s", flush=True)
    return out


def _records(quant, gemm, fused, headline_ms: float) -> dict:
    from lbt_tpu_torch.data.imagefolder import ImageFolderDataset
    from lbt_tpu_torch.data.tfrecord import TFRecordDataset
    out = probe_host()
    legs = out["legs"]
    out["cpu_count"] = os.cpu_count()
    shards = str(R_DIR / f"train-*-of-{R_SHARDS:02d}.tfrecord")
    tree = R_DIR / "tree"
    if legs["tfrecord"] or legs["imagefolder"]:
        data = write_records(legs)
        out["data"] = {k: v for k, v in data.items()
                       if not k.endswith("labels")}

    alone = {}
    if legs["tfrecord"]:
        ds = TFRecordDataset(shards, 224, train=True, seed=SEED)
        alone["tfrecord"] = source_rate(ds.batches(0, BATCH))
        ds.close()
    if legs["imagefolder"]:
        ds = ImageFolderDataset(str(tree / "train"), 224, train=True,
                                seed=SEED, workers=R_IMAGEFOLDER_WORKERS)
        alone["imagefolder"] = source_rate(ds.batches(0, BATCH))
    out["alone"] = alone
    for k, v in alone.items():
        print(f"records alone, {k}"
              + (f" at {R_IMAGEFOLDER_WORKERS} workers" if k ==
                 "imagefolder" else " at its default workers")
              + f": {v['images']} images at 224 px in {v['seconds']:.2f} s, "
              f"{v['img_per_s']:.1f} img/s on {os.cpu_count()} CPUs",
              flush=True)

    # the control: the same command line on in-memory synthetic images
    cli = {"memory": records_cli(
        "records memory", R_HEADLINE + R_RUN + [
            "--n_train", str(R_TRAIN), "--n_test", str(R_VAL)],
        quant, gemm, fused, R_VAL)}
    if legs["tfrecord"]:
        cli["tfrecord"] = records_cli(
            "records tfrecord", R_HEADLINE + R_RUN + [
                "--tfrecord_train", shards, "--tfrecord_val",
                str(R_DIR / "val-00-of-01.tfrecord"), "--num_classes",
                str(R50_CLASSES)], quant, gemm, fused, R_VAL)
    if legs["imagefolder"]:
        cli["imagefolder"] = records_cli(
            "records imagefolder", R_HEADLINE + R_RUN + [
                "--data_dir", str(tree)], quant, gemm, fused, R_VAL)
    out["cli"] = cli
    for k, v in cli.items():
        print(f"records {k}: {v['ms_per_step']:.1f} ms a step against "
              f"{cli['memory']['ms_per_step']:.1f} from memory through the "
              f"CLI and {headline_ms:.1f} in phase resnet50 (a sync a "
              f"step); {v['img_per_s']:.1f} against "
              f"{cli['memory']['img_per_s']:.1f} img/s an epoch",
              flush=True)
    out["headline_ms_per_step"] = headline_ms

    if legs["native"]:
        out["native_loader"] = records_native(quant, gemm, fused)
    out["debug_nans"] = records_debug_nans(legs, tree)
    return out


def records_native(quant, gemm, fused) -> dict:
    """The trainer phase's ResNet-20 command line with ``--native_loader``,
    1 epoch of 20 steps, counters reset just before: each kernel launched,
    the logged loss falls."""
    from lbt_tpu_torch.main import main as train_main
    exp = R_DIR / "native"
    reset_counters(quant, gemm, fused)
    run, run_ms = _sync_ms(lambda: train_main(
        TRAINER_ARGV + ["--native_loader", "--n_epoch", "1", "--device",
                        "cuda", "--exp_path", str(exp)]))
    launches = train_counters(quant, gemm, fused)
    for k, v in launches.items():
        check(v > 0, f"native loader run: {k} never launched")
    check(run.native is not None and run.augment is None,
          "the run did not take the native loader")
    rows = _rows(exp / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    stall = [r["train/input_stall_frac"] for r in rows
             if "train/input_stall_frac" in r]
    check(len(losses) >= 2 and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"the loss did not fall: {losses}")
    epoch = run.epoch_time
    out = {"launches": launches, "losses": losses, "steps": run.step,
           "img_per_s": epoch["images"] / epoch["seconds"],
           "input_stall_frac": stall[-1], "run_s": run_ms / 1e3}
    print(f"records native loader: ResNet-20, {run.step} steps of "
          f"{run.tc.batch_size} in "
          f"{epoch['seconds']:.2f} s, {out['img_per_s']:.1f} img/s, input "
          f"stall {100 * stall[-1]:.2f}%; losses {losses}; launches "
          f"{launches}", flush=True)
    shutil.rmtree(exp / "ckpt", ignore_errors=True)
    return out


def records_debug_nans(legs: dict, tree: Path) -> dict:
    """``--debug_nans`` on the card: ResNet-20 (a 10-way head) from the
    1000-class tree raises FloatingPointError at step 0; the same run
    without the flag logs NaN losses and finishes; a clean run with the
    flag finishes."""
    from lbt_tpu_torch.main import main as train_main
    if not legs["imagefolder"]:
        print("records debug_nans: not run (needs the ImageFolder tree)",
              flush=True)
        return {"ran": False}
    argv = ["--model", "CIFAR10_Resnet20", "--noise_mode", "hash",
            "--batch_size", str(BATCH), "--n_epoch", "1", "--log_every",
            "1", "--device", "cuda", "--data_dir", str(tree)]
    t0 = time.perf_counter()
    try:
        train_main(argv + ["--debug_nans", "--exp_path",
                           str(R_DIR / "nan_on")])
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    check(raised is not None and "train step 0" in raised,
          f"--debug_nans with labels outside the head: {raised}")
    off = train_main(argv + ["--exp_path", str(R_DIR / "nan_off")])
    losses = [r["train/loss"] for r in _rows(R_DIR / "nan_off"
                                             / "metrics.jsonl")
              if "train/loss" in r]
    check(off.step == R_TRAIN // BATCH and losses
          and all(math.isnan(x) for x in losses),
          f"without --debug_nans: {off.step} steps, losses {losses}")
    clean = train_main(ZOO_ARGV + [
        "--model", "CIFAR10_Resnet20", "--noise_mode", "hash",
        "--debug_nans", "--device", "cuda", "--exp_path",
        str(R_DIR / "nan_clean")])
    check(clean.step > 0, "the clean run with --debug_nans took no step")
    seconds = time.perf_counter() - t0
    print(f"records debug_nans: labels outside the head raise "
          f"FloatingPointError: {raised!r}; without the flag "
          f"{off.step} steps, losses {losses}; a clean run with the flag "
          f"took {clean.step} steps ({seconds:.1f} s)", flush=True)
    return {"ran": True, "raised": raised, "off_losses": losses,
            "off_steps": off.step, "clean_steps": clean.step,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# dp: data parallelism on torch.distributed (2 ranks sharing the card)
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_STEPS = 2            # ResNet-20 steps: kernel route, then plain route
DP_LOWBIT_STEPS = 2     # each low-bit transport's ResNet-20 steps
DP_WIRES = (None, "int16", "int8")   # psum transport, then the two rings
DP_R50_GATE = 3         # headline steps before the timed ones (on, off, off)
DP_R50_TIMED = 1
DP_DIR = REPO / "experiments" / "smoke_dp"
DP_CLI = ["--model", "CIFAR10_Resnet20", "--data_parallel",
          "--lowbit_allreduce", "--noise_mode", "hash", "--batch_size",
          "128", "--n_train", "1280", "--n_test", "300", "--log_every",
          "5", "--checkpoint_every", "1"]


def _digest(model, velocity, ebuf=None) -> dict:
    """sha256 of every tensor of the training state: parameters,
    exponents, BN statistics, velocity (and ``ebuf``)."""
    return _sha256s({**_state(model, velocity),
                     **{f"ebuf.{k}": v for k, v in (ebuf or {}).items()}})


def _sha256s(tensors: dict) -> dict:
    import hashlib
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, v in tensors.items()}


def _dp_run(model, group, batches, lowbit=None, wire=None):
    """``(run, velocity, ebuf)``: ``run(i)`` takes DP step ``i`` of
    ``model`` on this rank's rows of ``batches[i % len]`` and returns its
    loss (a tensor)."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.dfxp.keys import base_key
    from lbt_tpu_torch.parallel import init_error_buffers, make_dp_train_step
    from lbt_tpu_torch.train.optim import momentum_init
    params = dict(model.net.named_parameters())
    vel, ebuf = momentum_init(params), init_error_buffers(params)
    step = make_dp_train_step(model, TrainConfig(), group, lowbit_bits=lowbit,
                              lowbit_wire=wire)
    dev, per = model.device, batches[0][0].shape[0] // group.world
    rows = slice(group.rank * per, (group.rank + 1) * per)

    def run(i):
        x, y = batches[i % len(batches)]
        return step(model, vel, ebuf, x[rows].to(dev), y[rows].to(dev), i,
                    TRAIN_LR, base_key(TRAIN_KEY_SEED))["loss"]
    return run, vel, ebuf


def _dp_rank_r20(group, modules) -> dict:
    """Leg (a) on one rank: ResNet-20, global batch 128, through the
    kernels (counters reset just before) and through the plain versions,
    then the first step on the CPU over the same group, then each low-bit
    transport."""
    qmod, qops, quant, gemm, fused = modules
    batches = train_batches(DP_STEPS)
    card = build_train_model(SEED).to("cuda")
    run, vel, _ = _dp_run(card, group, batches)
    reset_counters(quant, gemm, fused)
    losses = [run(i) for i in range(DP_STEPS)]
    torch.cuda.synchronize()
    launches = train_counters(quant, gemm, fused)
    for k, v in launches.items():
        check(v > 0, f"{k} never launched on the data-parallel path")
    plain = build_train_model(SEED).to("cuda")
    prun, pvel, _ = _dp_run(plain, group, batches)
    with plain_route(qmod, qops, quant, gemm):
        plain_losses = [prun(i).item() for i in range(DP_STEPS)]
    check(train_counters(quant, gemm, fused) == launches,
          "the plain route launched a kernel")
    out = {"launches": launches, "losses": [x.item() for x in losses],
           "plain_losses": plain_losses, "digest": _digest(card, vel),
           "plain_digest": _digest(plain, pvel)}
    cpu = build_train_model(SEED)
    crun, _, _ = _dp_run(cpu, group, batches)
    out["cpu_first_loss"] = crun(0).item()
    out["lowbit"] = {}
    for wire in DP_WIRES:
        model = build_train_model(SEED).to("cuda")
        lrun, lvel, _ = _dp_run(model, group, batches, lowbit=8, wire=wire)
        ls = [lrun(i).item() for i in range(DP_LOWBIT_STEPS)]
        out["lowbit"][str(wire)] = {"losses": ls,
                                    "digest": _digest(model, lvel)}
    return out


def _dp_rank_r50(group, modules) -> dict:
    """Leg (c) on one rank: the headline (ResNet-50/224 under lean-a8)
    with the low-bit all-reduce (psum transport), 64 rows of a global 128;
    ``DP_R50_GATE`` steps, then ``DP_R50_TIMED`` timed ones: host ms a
    step (synced), collective host ms and calls a step, kernel launches a
    step, peak memory."""
    _, _, quant, gemm, fused = modules
    batches = r50_batches(1)
    model = build_resnet50(SEED).to("cuda")
    run, vel, _ = _dp_run(model, group, batches, lowbit=8)
    torch.cuda.reset_peak_memory_stats()
    gate = [run(i).item() for i in range(DP_R50_GATE)]
    check(all(math.isfinite(x) for x in gate), f"losses {gate}")
    reset_counters(quant, gemm, fused)
    sec0, calls0 = group.seconds, group.calls
    samples = []
    for i in range(DP_R50_GATE, DP_R50_GATE + DP_R50_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    n = DP_R50_TIMED
    coll_ms = (group.seconds - sec0) * 1e3 / n
    coll_calls = (group.calls - calls0) / n
    launches = {k: v / n for k, v in train_counters(quant, gemm,
                                                   fused).items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the low-bit bucket's wires alone, at the headline's size: the psum
    # transport's int32 all-reduce, and one ring hop (bucket / N) in int16
    # and in int8 (2 (N - 1) hops a step); host ms, device synced
    size = sum(p.numel() for p in model.net.parameters())
    wires = {}
    for name, dtype, numel in (("psum_int32", torch.int32, size),
                               ("ring_int16_hop", torch.int16,
                                size // group.world),
                               ("ring_int8_hop", torch.int8,
                                size // group.world)):
        x = torch.ones(numel, dtype=dtype, device="cuda")
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (group.ring_pass if "ring" in name else group.all_reduce)(x)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        wires[name] = {"mb": numel * x.element_size() / 1e6,
                       "ms": statistics.median(ts)}
    return {"gate_losses": gate, "samples_ms": samples, "wires": wires,
            "ms_per_step": statistics.median(samples),
            "collective_ms_per_step": coll_ms,
            "collective_calls_per_step": coll_calls,
            "launches_per_step": launches,
            "max_memory_gib": peak, "digest": _digest(model, vel)}


def dp_worker(argv) -> int:
    """One rank of phase dp (``chip_smoke.py --dp-worker STORE RANK WORLD
    OUT``): joins the group through ``parallel.initialize`` (2 ranks on
    one card: gloo), runs legs (a) and (c), writes its results to OUT."""
    import pickle
    store, rank, world, out_path = argv
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    qmod, qops, _, gemm, quant = port_modules()
    from lbt_tpu_torch.ops.kernels import conv_fused
    from lbt_tpu_torch.parallel import initialize
    group = initialize("cuda", init_method=f"file://{store}",
                       world_size=int(world), rank=int(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    modules = (qmod, qops, quant, gemm, conv_fused)
    out = {"backend": group.backend, "device": str(group.device)}
    out["r20"] = _dp_rank_r20(group, modules)
    torch.cuda.empty_cache()
    out["r50"] = _dp_rank_r50(group, modules)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def _dp_nccl(modules) -> dict:
    """Leg (b): ResNet-20 steps of ``make_dp_train_step`` over an NCCL
    group of world size 1, plain and with each low-bit transport, equal
    bit for bit to the same steps over a gloo group of world size 1 on
    the card: every collective's dtype and call is one NCCL takes."""
    import tempfile
    import torch.distributed as dist
    from lbt_tpu_torch.parallel import Group
    tmp = tempfile.mkdtemp(dir=DP_DIR)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        groups = {"nccl": Group(device="cuda"),
                  "gloo": Group(dist.new_group(backend="gloo"),
                                device="cuda")}
        batches = [(x[:64], y[:64]) for x, y in train_batches(2)]
        out = {}
        for wire in ("plain",) + DP_WIRES:
            res = {}
            for name, g in groups.items():
                model = build_train_model(SEED).to("cuda")
                run, vel, ebuf = _dp_run(
                    model, g, batches, lowbit=None if wire == "plain"
                    else 8, wire=None if wire == "plain" else wire)
                losses = [run(i).item() for i in range(2)]
                res[name] = (losses, _digest(model, vel, ebuf))
            check(res["nccl"] == res["gloo"],
                  f"dp {wire}: NCCL and gloo steps differ")
            out[str(wire)] = res["nccl"][0]
        print(f"dp (b): NCCL at world size 1 equals gloo bitwise, 2 "
              f"ResNet-20 steps each: plain, psum, int16 ring, int8 ring; "
              f"losses {out}", flush=True)
        return out
    finally:
        dist.destroy_process_group()


def _dp_cli() -> dict:
    """Leg (d): the CLI under ``torch.distributed.run`` with 2 ranks on
    the card, 1 epoch of 10 steps and an eval of 300 (one padded, ragged
    batch), then a second run to 2 epochs that resumes."""
    exp = DP_DIR / "cli"
    shutil.rmtree(exp, ignore_errors=True)
    out = {}
    for n_epoch in (1, 2):
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(DP_RANKS), "-m", "lbt_tpu_torch.main",
               *DP_CLI, "--n_epoch", str(n_epoch), "--exp_path", str(exp)]
        p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=300)
        check(p.returncode == 0, f"torchrun exit {p.returncode}: "
              f"{p.stderr[-3000:]}")
        out[f"epochs_{n_epoch}_s"] = time.perf_counter() - t0
    log = (exp / "experiment.log").read_text()
    rows = _rows(exp / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    tests = [r["test/accuracy"] for r in rows if "test/accuracy" in r]
    check(log.count("Start of experiment") == 2, "rank 0 alone logs")
    check("Resumed from" in log and "@ step 10" in log,
          "the second run did not resume at step 10")
    check(len(losses) == 4 and all(math.isfinite(v) for v in losses),
          f"logged losses {losses}")
    check(len(tests) == 2, f"evals logged {tests}")
    check(sorted(int(d) for d in os.listdir(exp / "ckpt")) == [10, 20],
          "checkpoints")
    out.update(losses=losses, test_accuracy=tests)
    print(f"dp (d): torchrun 2 ranks on the card, --data_parallel "
          f"--lowbit_allreduce: 1 epoch ({out['epochs_1_s']:.1f} s), "
          f"resumed to 2 ({out['epochs_2_s']:.1f} s); losses {losses}, "
          f"test accuracy {tests}", flush=True)
    return out


def phase_dp(qmod, qops, quant, gemm, fused) -> dict:
    """Data parallelism on the card: (b) NCCL at world size 1 against
    gloo, in this process; (a) and (c) in 2 rank processes sharing the
    card over gloo; (d) the CLI under torchrun."""
    import pickle
    t0 = time.perf_counter()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    torch.use_deterministic_algorithms(True)
    try:
        out = {"nccl": _dp_nccl((qmod, qops, quant, gemm, fused))}
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--dp-worker",
         str(DP_DIR / "store"), str(r), str(DP_RANKS),
         str(DP_DIR / f"rank{r}.pkl")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP_RANKS)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"dp rank {r} exit {p.returncode}:\n"
              f"{logs[r][-3000:]}")
    ranks = []
    for r in range(DP_RANKS):
        with open(DP_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    a0, a1 = (r["r20"] for r in ranks)
    check(ranks[0]["backend"] == "gloo", "2 ranks on one card: gloo")
    check(a0["digest"] == a1["digest"] and a0["losses"] == a1["losses"],
          "dp (a): the ranks' states differ")
    check(a0["digest"] == a0["plain_digest"]
          and a0["losses"] == a0["plain_losses"],
          "dp (a): kernel and plain routes differ")
    check(math.isclose(a0["cpu_first_loss"], a0["losses"][0],
                       rel_tol=1e-5),
          f"dp (a): first loss {a0['losses'][0]} against the 2-rank CPU "
          f"route's {a0['cpu_first_loss']}")
    for wire in map(str, DP_WIRES):
        l0, l1 = a0["lowbit"][wire], a1["lowbit"][wire]
        check(l0 == l1, f"dp (a) lowbit {wire}: the ranks differ")
        check(all(math.isfinite(v) for v in l0["losses"]),
              f"dp (a) lowbit {wire}: losses {l0['losses']}")
    print(f"dp (a): ResNet-20, 2 ranks x 64 on the card over gloo, "
          f"{DP_STEPS} steps: kernel route == plain route, rank 0 == rank "
          f"1 in all {len(a0['digest'])} tensors (tolerance 0); losses "
          f"{a0['losses']}, the 2-rank CPU route's first "
          f"{a0['cpu_first_loss']}; launches {a0['launches']}; low-bit "
          f"{ {w: a0['lowbit'][w]['losses'] for w in a0['lowbit']} }, "
          f"ranks equal", flush=True)
    c0, c1 = (r["r50"] for r in ranks)
    check(c0["digest"] == c1["digest"], "dp (c): the ranks' states differ")
    print(f"dp (c): the headline, 2 ranks x 64 sharing one card "
          f"({ranks[0]['backend']}; not a scaling number), "
          f"--lowbit_allreduce: median {c0['ms_per_step']:.1f} / "
          f"{c1['ms_per_step']:.1f} ms a step (ranks 0 / 1), collectives "
          f"{c0['collective_ms_per_step']:.1f} / "
          f"{c1['collective_ms_per_step']:.1f} ms in "
          f"{c0['collective_calls_per_step']:g} calls a step, peak "
          f"{c0['max_memory_gib']:.2f} / {c1['max_memory_gib']:.2f} GiB, "
          f"launches a step {c0['launches_per_step']}; ranks equal",
          flush=True)
    print("dp (c): the bucket's wires alone, host ms (staged through host "
          "memory): " + ", ".join(
              f"{k} {v['mb']:.1f} MB {v['ms']:.1f} / "
              f"{c1['wires'][k]['ms']:.1f}" for k, v in c0["wires"].items()),
          flush=True)
    out.update(backend=ranks[0]["backend"], r20=a0, r20_rank1=a1, r50=c0,
               r50_rank1=c1)
    out["cli"] = _dp_cli()
    out["seconds"] = time.perf_counter() - t0
    print(f"dp: phase took {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

TP_DIR = REPO / "experiments" / "smoke_tp"
TP_R20_STEPS = 3        # ResNet-20 steps at 2 x 2: kernel route, plain route
TP_CLI = ["--model", "CIFAR10_Resnet20", "--data_parallel",
          "--tensor_parallel", "2", "--noise_mode", "hash", "--batch_size",
          "128", "--n_train", "1280", "--n_test", "300", "--log_every",
          "5", "--checkpoint_every", "1"]


def _whole_digest(model, velocity, specs, tp, ebuf=None) -> dict:
    """:func:`_digest`'s keys and hashes for a model cut over the model
    group ``tp``: its slices gathered first (every rank calls it)."""
    import hashlib
    from lbt_tpu_torch.parallel.mesh import gather_params
    sd = dict(model.net.state_dict())
    state = {f"net.{k}": v for k, v in gather_params(
        sd, {k: specs.get(k, ()) for k in sd}, tp).items()}
    state.update({f"velocity.{k}": v for k, v in
                  gather_params(velocity, specs, tp).items()})
    if ebuf is not None:
        state.update({f"ebuf.{k}": v for k, v in
                      gather_params(ebuf, specs, tp).items()})
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, v in state.items()}


def _window_key(noise) -> tuple:
    """``(n_global, col0)`` of a call's column window, ``(0, 0)`` for
    none."""
    return (0, 0) if noise is None else (noise.n_global, noise.col0)


def record_tp_calls(qmod, qops, quant, gemm, fused, run, steps):
    """``(losses, calls)``: one rank's kernel calls in ``run``'s steps
    (``(step index, weight, batch)``, a call counting ``weight`` times as
    in :func:`record_train_calls`), keyed as there with the column window
    ``(n_global, col0)`` last in K1's and #4/#5's keys."""
    k1, k2, tn, conv = (collections.Counter() for _ in range(4))
    weight = [1.0]

    def k1_rec(t, bits, exp, noise=None, stats=False):
        k1[(tuple(t.shape), bits, *noise_key(noise), bool(stats),
            *_window_key(noise))] += weight[0]
        return quant.quantize_codes(t, bits, exp, noise, stats)

    def k2_rec(a, b, inv=None):
        k2[(a.shape[0], a.shape[1], b.shape[1], inv is not None)] += \
            weight[0]
        return gemm.int8_matmul(a, b, inv)

    def tn_rec(a, b):
        tn[(a.shape[0], a.shape[1], b.shape[1])] += weight[0]
        return gemm.int8_matmul_tn(a, b)

    def conv_rec(kind):
        def rec(xc, wc, inv, mult, *, strides, pads, bits_out=8,
                noise=None, round_bf16=False):
            conv[(kind, tuple(xc.shape), str(xc.dtype), tuple(wc.shape),
                  tuple(strides), tuple(pads), *noise_key(noise),
                  bool(round_bf16), *_window_key(noise))] += weight[0]
            return getattr(fused, kind)(xc, wc, inv, mult, strides=strides,
                                        pads=pads, bits_out=bits_out,
                                        noise=noise, round_bf16=round_bf16)
        return rec

    with mock.patch.object(qmod, "quantize_codes", k1_rec), \
            mock.patch.object(qops, "int8_matmul", k2_rec), \
            mock.patch.object(qops, "int8_matmul_tn", tn_rec), \
            mock.patch.object(qops, "conv3x3_fused",
                              conv_rec("conv3x3_fused")), \
            mock.patch.object(qops, "conv1x1_fused",
                              conv_rec("conv1x1_fused")):
        losses = []
        for i, w, batch in steps:
            weight[0] = w
            losses.append(run(i, batch).item())
    torch.cuda.synchronize()
    return losses, (k1, k2, tn, conv)


def _tp_gate(run, steps, tp, modules, after=None) -> tuple:
    """``(losses, calls, timing)`` of a leg's gate ``steps`` (``(step
    index, weight, batch)``) on one rank of a layout, each recorded by
    :func:`record_tp_calls`, ``after(step index)`` called after each.
    The last step is timed: host ms (synced; the recorders' bookkeeping
    included), the model group's collectives in it by kind, its
    launches and its peak memory."""
    qmod, qops, quant, gemm, fused = modules
    losses, calls = [], None
    for n, (i, w, batch) in enumerate(steps):
        if n == len(steps) - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kinds0 = {k: list(v) for k, v in tp.by_kind.items()}
            before = train_counters(quant, gemm, fused)
            t0 = time.perf_counter()
        loss, c = record_tp_calls(qmod, qops, quant, gemm, fused, run,
                                  [(i, w, batch)])
        if n == len(steps) - 1:
            ms = (time.perf_counter() - t0) * 1e3
            zero = [0.0, 0, 0]
            timing = {
                "samples_ms": [ms], "ms_per_step": ms,
                "collectives_per_step": {
                    k: {"ms": (v[0] - kinds0.get(k, zero)[0]) * 1e3,
                        "calls": v[1] - kinds0.get(k, zero)[1],
                        "mb": (v[2] - kinds0.get(k, zero)[2]) / 1e6}
                    for k, v in tp.by_kind.items()},
                "launches_per_step": {
                    k: v - before[k] for k, v in
                    train_counters(quant, gemm, fused).items()},
                "max_memory_gib": torch.cuda.max_memory_allocated()
                / 2 ** 30}
        losses += loss
        calls = c if calls is None else tuple(
            x + y for x, y in zip(calls, c))
        if after is not None:
            after(i)
    return losses, calls, timing


def _tp_rank_r50(data, tp, modules) -> dict:
    """Leg (a) on one rank: the headline (ResNet-50/224, batch 128,
    lean-a8) at tp = 2, the one-rank step on the model cut by
    ``shard_model``: phase resnet50's 3 gate steps (every counter reset
    just before, each kernel required to launch; their calls recorded,
    weighted as a step at the bench's cadence: the controllers on in one
    step of 8; the last, controllers off, timed by :func:`_tp_gate`),
    the whole state's digest."""
    qmod, qops, quant, gemm, fused = modules
    from lbt_tpu_torch.parallel.mesh import shard_model
    batches = r50_batches(R50_GATE_STEPS)
    model = build_resnet50(SEED).to("cuda")
    specs = shard_model(model, tp)
    vel, run = make_trainer(model)
    reset_counters(quant, gemm, fused)
    losses, calls, timing = _tp_gate(
        run, [(i, w, b) for i, (w, b) in enumerate(zip(
            (1 / 8, 7 / 16, 7 / 16), batches))], tp, modules)
    launches = train_counters(quant, gemm, fused)
    for k, v in launches.items():
        check(v > 0, f"{k} never launched on the tensor-parallel path")
    return {"losses": losses, "launches": launches, "calls": calls,
            "digest": _whole_digest(model, vel, specs, tp),
            "sharded_leaves": sum(bool(v) for v in specs.values()),
            **timing}


def _tp_rank_b50(data, tp, modules) -> dict:
    """Leg (d) on one rank: configuration A (phase baseline50's config,
    sim_bf16 + prng: K1 in threefry mode, the contractions in bf16) at
    tp = 2, the one-rank step on the model cut by ``shard_model``: phase
    baseline50's ``B50_GATE_STEPS`` gate steps from its seed and batches
    (every counter reset just before, K1 required to launch, in threefry
    mode at every call; the calls recorded, a step's; the last timed by
    :func:`_tp_gate`), the exponents and (rank 0) the whole parameters
    after each step, the whole state's digest."""
    qmod, qops, quant, gemm, fused = modules
    from lbt_tpu_torch.parallel.mesh import shard_model
    batches = r50_batches(B50_GATE_STEPS)
    model = build_baseline50(SEED).to("cuda")
    specs = shard_model(model, tp)
    vel, run = make_trainer(model)
    snaps = {}

    def snapshot(i):
        snaps[i] = (_exponents(model), _host_params(model, specs, tp))
    reset_counters(quant, gemm, fused)
    losses, calls, timing = _tp_gate(
        run, [(i, 1 / B50_GATE_STEPS, b) for i, b in enumerate(batches)],
        tp, modules, snapshot)
    launches = train_counters(quant, gemm, fused)
    threefry = threefry_counters(quant, fused)
    check(launches["k1"] > 0 and threefry["k1"] == launches["k1"],
          "K1 did not launch in threefry mode at every call of leg (d)")
    check(not any(v for k, v in launches.items() if k != "k1"),
          f"leg (d) launched {launches}: its path has K1 only")
    exps, params = (list(v) for v in zip(*(snaps[i] for i in
                                            range(B50_GATE_STEPS))))
    return {"losses": losses, "launches": launches, "threefry": threefry,
            "digest": _whole_digest(model, vel, specs, tp),
            "exps": exps, "params": None if tp.rank else params,
            "calls": calls,
            "sharded_leaves": sum(bool(v) for v in specs.values()),
            **timing}


def _tp_run(model, data, tp, batches):
    """``(run, velocity, ebuf)``: ``run(i)`` is step ``i`` of the
    data-parallel step on the layout with the low-bit all-reduce (psum
    transport), this data index's rows of ``batches[i % len]``."""
    from lbt_tpu_torch.config import TrainConfig
    from lbt_tpu_torch.dfxp.keys import base_key
    from lbt_tpu_torch.parallel import init_error_buffers, make_dp_train_step
    from lbt_tpu_torch.train.optim import momentum_init
    params = dict(model.net.named_parameters())
    vel, ebuf = momentum_init(params), init_error_buffers(params)
    step = make_dp_train_step(model, TrainConfig(), data, lowbit_bits=8,
                              tp=tp)
    dev, per = model.device, batches[0][0].shape[0] // data.world
    rows = slice(data.rank * per, (data.rank + 1) * per)

    def run(i):
        x, y = batches[i % len(batches)]
        return step(model, vel, ebuf, x[rows].to(dev), y[rows].to(dev), i,
                    TRAIN_LR, base_key(TRAIN_KEY_SEED))["loss"]
    return run, vel, ebuf


def _tp_rank_r20(data, tp, modules) -> dict:
    """Leg (b) on one rank: ResNet-20 at dp x tp = 2 x 2, global batch
    128, the low-bit all-reduce: ``TP_R20_STEPS`` steps through the
    kernels (counters reset just before, each required to rise), then
    through the plain versions from the same start; the whole states'
    digests (ebuf included)."""
    qmod, qops, quant, gemm, fused = modules
    from lbt_tpu_torch.parallel.mesh import shard_model
    batches = train_batches(TP_R20_STEPS)
    out = {}
    for route in ("kernel", "plain"):
        model = build_train_model(SEED).to("cuda")
        specs = shard_model(model, tp)
        run, vel, ebuf = _tp_run(model, data, tp, batches)
        reset_counters(quant, gemm, fused)
        with (plain_route(qmod, qops, quant, gemm) if route == "plain"
              else contextlib.nullcontext()):
            losses = [run(i).item() for i in range(TP_R20_STEPS)]
        torch.cuda.synchronize()
        out[route] = {"losses": losses,
                      "launches": train_counters(quant, gemm, fused),
                      "digest": _whole_digest(model, vel, specs, tp, ebuf)}
    for k, v in out["kernel"]["launches"].items():
        check(v > 0, f"{k} never launched at 2 x 2")
    check(not any(out["plain"]["launches"].values()),
          "the plain route launched a kernel")
    return out


def tp_worker(argv) -> int:
    """One rank of phase tp (``chip_smoke.py --tp-worker STORE RANK WORLD
    OUT LEG``): joins the world through ``parallel.initialize`` (ranks
    sharing the card: gloo), cuts it into leg ``r50``'s 1 x 2 or leg
    ``r20``'s 2 x 2 layout (``parallel.make_groups``), runs the leg and
    writes its results to OUT."""
    import pickle
    store, rank, world, out_path, leg = argv
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    qmod, qops, _, gemm, quant = port_modules()
    from lbt_tpu_torch.ops.kernels import conv_fused
    from lbt_tpu_torch.parallel import initialize, make_groups
    world_group = initialize("cuda", init_method=f"file://{store}",
                             world_size=int(world), rank=int(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    data, tp = make_groups(*{"r50": (1, 2), "b50": (1, 2),
                             "r20": (2, 2)}[leg], device=world_group.device)
    modules = (qmod, qops, quant, gemm, conv_fused)
    out = {"backend": tp.backend, "data_index": data.rank,
           "model_index": tp.rank}
    out.update({"r50": _tp_rank_r50, "b50": _tp_rank_b50,
                "r20": _tp_rank_r20}[leg](data, tp, modules))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def _tp_ranks(leg: str, world: int):
    """Start leg ``leg``'s ``world`` rank processes; returns a function
    that waits for them and gives each rank's results."""
    import pickle
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--tp-worker",
         str(TP_DIR / f"store_{leg}"), str(r), str(world),
         str(TP_DIR / f"{leg}{r}.pkl"), leg], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

    def wait():
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"tp {leg} rank {r} exit "
                  f"{p.returncode}:\n{logs[r][-3000:]}")
        out = []
        for r in range(world):
            with open(TP_DIR / f"{leg}{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    return wait


def _tp_cli() -> dict:
    """Leg (c): the CLI under ``torch.distributed.run`` with 2 ranks on
    the card, ``--tensor_parallel 2``: 1 epoch of 10 steps and an eval of
    300, then a second run to 2 epochs that resumes."""
    exp = TP_DIR / "cli"
    out = {}
    for n_epoch in (1, 2):
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "lbt_tpu_torch.main", *TP_CLI,
               "--n_epoch", str(n_epoch), "--exp_path", str(exp)]
        p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=300)
        check(p.returncode == 0, f"torchrun exit {p.returncode}: "
              f"{p.stderr[-3000:]}")
        out[f"epochs_{n_epoch}_s"] = time.perf_counter() - t0
    log = (exp / "experiment.log").read_text()
    rows = _rows(exp / "metrics.jsonl")
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    tests = [r["test/accuracy"] for r in rows if "test/accuracy" in r]
    check(log.count("Start of experiment") == 2, "rank 0 alone logs")
    check("column slices" in log, "the run was not tensor parallel")
    check("Resumed from" in log and "@ step 10" in log,
          "the second run did not resume at step 10")
    check(len(losses) == 4 and all(math.isfinite(v) for v in losses),
          f"logged losses {losses}")
    check(len(tests) == 2, f"evals logged {tests}")
    check(sorted(int(d) for d in os.listdir(exp / "ckpt")) == [10, 20],
          "checkpoints")
    out.update(losses=losses, test_accuracy=tests)
    return out


def _tp_noise(quant, mode, shape, shared, n_global, col0, row0=0):
    """:func:`noise_of` for a column slice of ``shape`` at ``col0`` of
    ``n_global`` columns (the shared draw and the offset the whole
    tensor's)."""
    full = (*shape[:-1], n_global)
    inner = math.prod(full[1:]) if shared else 0
    offset = (row0 * inner) if shared else row0 * math.prod(full[1:])
    return quant.Noise(mode, NOISE_K0, NOISE_K1, inner, offset, n_global,
                       col0)


def _tp_k1_rows(quant, k1_calls, gen, tag) -> dict:
    """K1 at every windowed call of ``k1_calls`` against its plain
    version bitwise (rank 0's window and the last rank's, that one at the
    counter offset ``CHECK_ROW0``), and timed against its bound."""
    from lbt_tpu_torch.ops.kernels import work
    rate = CARD["issue_per_s"]
    exp = torch.tensor(1, dtype=torch.int32, device="cuda")
    err, rows = 0.0, []
    for (shape, bits, mode, shared, stats, ng, col0), count in sorted(
            k1_calls.items()):
        if not ng:
            continue
        x = (torch.randn(shape, generator=gen) * 2).cuda()
        for c0, row0 in ((col0, 0), (ng - shape[-1], CHECK_ROW0)):
            noise = _tp_noise(quant, mode, shape, shared, ng, c0, row0)
            got = quant.quantize_codes(x, bits, exp, noise, True)
            want = quant.quantize_codes_plain(x, bits, exp, noise, True)
            torch.cuda.synchronize()
            err = max(err, max(_max_err(g, w) for g, w in zip(got, want)))
            check(_equal_outputs(got, want), f"K1 (window) differs from "
                  f"its plain version at {shape} noise={noise}")
        noise = _tp_noise(quant, mode, shape, shared, ng, col0)
        code_bytes = torch.empty((), dtype=quant.code_dtype(bits)) \
            .element_size()
        rows.append({"shape": list(shape), "n_global": ng,
                     "mode": MODE_NAMES[mode], "stats": stats,
                     "calls": count, **_timings(
                         lambda x, e, n=noise: quant.quantize_codes(
                             x, bits, e, n, stats),
                         lambda x, e, n=noise: quant.quantize_codes_plain(
                             x, bits, e, n, stats),
                         (x, exp), x.numel() * (4 + code_bytes),
                         work.quantize_work(x.numel(), code_bytes, stats,
                                            mode, rate), reps=FAST_REPS)})
    return {"max_abs_err": err, **_print_rows(
        tag, rows, lambda r: f"{r['shape']} of {r['n_global']} "
        f"{r['mode']}{' mm' if r['stats'] else ''}"), "shapes": rows}


def phase_tp_kernels(quant, gemm, fused, calls, r50_k2_rows,
                     b50_k1_calls) -> dict:
    """Each kernel's tensor-parallel form at leg (a)'s shapes: K1 at
    every windowed call (the sharded weights), #4 / #5 at every windowed
    call (the sharded convs' BN inputs), each against its plain version
    bitwise at rank 0's window and at the last rank's, the latter at the
    counter offset of rows ``CHECK_ROW0..``, and timed; K2 at the shapes
    that a one-rank step does not have (the slices' contractions, the
    partial dx), as phase K2-train; then K1 at leg (d)'s windowed calls
    (configuration A's sharded weights, threefry), as leg (a)'s."""
    from lbt_tpu_torch.ops.im2col import out_hw
    from lbt_tpu_torch.ops.kernels import work
    k1_calls, k2_calls, tn_calls, conv_calls = calls
    gen = torch.Generator().manual_seed(SEED + 8)
    rate = CARD["issue_per_s"]
    out = {"k1": _tp_k1_rows(quant, k1_calls, gen, "TP K1 window")}
    for kind in ("conv3x3_fused", "conv1x1_fused"):
        fn = getattr(fused, kind)
        err, rows = 0.0, []
        for key, count in sorted(conv_calls.items()):
            (k, xshape, xdtype, wshape, strides, pads, mode, shared, rbf,
             ng, col0) = key
            if k != kind or not ng:
                continue
            lim = 256 if xdtype == str(torch.int16) else 128
            xc = torch.randint(-lim, lim, xshape, generator=gen,
                               dtype=torch.int16 if lim == 256
                               else torch.int8).cuda()
            wc = torch.randint(-128, 128, wshape, generator=gen,
                               dtype=torch.int8).cuda()
            inv = torch.tensor([2.0 ** -14], device="cuda")
            mult = torch.tensor([2.0 ** -2], device="cuda")
            yshape = (xshape[0], *out_hw(xshape[1], xshape[2], wshape[:2],
                                         strides, pads), wshape[3])
            for c0, row0 in ((col0, 0), (ng - wshape[3], CHECK_ROW0)):
                kw = dict(strides=strides, pads=pads, round_bf16=rbf,
                          noise=_tp_noise(quant, mode, yshape, shared, ng,
                                          c0, row0))
                got = fn(xc, wc, inv, mult, **kw)
                want = fused.conv_fused_plain(xc, wc, inv, mult, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    err = max(err, _max_err(g, w))
                    check(g.dtype == w.dtype and torch.equal(g, w),
                          f"{kind} (window) differs from its plain version "
                          f"at x {xshape} w {wshape} noise={kw['noise']}")
            kw = dict(strides=strides, pads=pads, round_bf16=rbf,
                      noise=_tp_noise(quant, mode, yshape, shared, ng, col0))
            rows.append({"x": list(xshape), "w": list(wshape),
                         "n_global": ng, "mode": MODE_NAMES[mode],
                         "calls": count, **_timings(
                             lambda x, w, kw=kw: fn(x, w, inv, mult, **kw),
                             lambda x, w, kw=kw: fused.conv_fused_plain(
                                 x, w, inv, mult, **kw),
                             (xc, wc), xc.numel() * xc.element_size()
                             + math.prod(yshape),
                             work.conv_fused_work(
                                 xshape, xc.element_size(), wshape, strides,
                                 pads, mode, rate),
                             lib_conv(xc, wc, strides, pads), FAST_REPS)})
        out[kind] = {"max_abs_err": err, **_print_rows(
            f"TP {kind} window", rows, lambda r: f"x{r['x']} w{r['w']} of "
            f"{r['n_global']} {r['mode']}"), "shapes": rows}
    one_rank = {(r["form"], r["m"], r["k"], r["n"]) for r in r50_k2_rows}
    out["k2"] = phase_k2_train(
        gemm, collections.Counter({k: v for k, v in k2_calls.items()
                                   if ("AB", *k[:3]) not in one_rank}),
        collections.Counter({k: v for k, v in tn_calls.items()
                             if ("ATB", k[1], k[0], k[2]) not in one_rank}),
        R50_K2_REPS, "TP K2")
    out["k1_threefry"] = _tp_k1_rows(quant, b50_k1_calls, gen,
                                     "TP K1 window (d)")
    return out


def _print_tp_rank(tag, r, res) -> None:
    kinds = ", ".join(f"{k} {v['ms']:.1f} ms in {v['calls']:g} calls "
                      f"of {v['mb']:.1f} MB" for k, v in sorted(
                          res["collectives_per_step"].items())
                      if v["calls"])
    print(f"{tag} rank {r}: median {res['ms_per_step']:.1f} ms a step "
          f"(samples {[round(v, 1) for v in res['samples_ms']]}; two "
          f"ranks sharing one card over gloo: not a scaling number); "
          f"model-group collectives a step: {kinds}; peak "
          f"{res['max_memory_gib']:.2f} GiB; launches a step "
          f"{res['launches_per_step']}", flush=True)


# leg (d)'s bound on each parameter leaf's relative L2 distance:
# tests/test_torch_imagenet.py's for bf16 ResNet-50 cascades (ROADMAP
# queue 3 item 2)
TP_B50_REL_L2 = 0.1


def _rel_l2(got, want) -> dict:
    """The largest and the median over the leaves of ``||got - want|| /
    ||want||`` (host tensors), and the largest one's name."""
    check(set(got) == set(want), "tp (d): parameter names")
    rel = {k: float((got[k].double() - w.double()).norm()
                    / max(w.double().norm().item(), 1e-30))
           for k, w in want.items()}
    worst = max(rel, key=rel.get)
    return {"largest_leaf": worst, "largest": rel[worst],
            "median": statistics.median(rel.values())}


def _held(tag, got, want) -> dict:
    """``got``'s gate steps against ``want``'s (``losses``, and after each
    step ``exps`` and ``params``): step 0's loss at rtol 1e-5, the
    exponents after it bitwise, and every parameter leaf within
    ``TP_B50_REL_L2`` relative L2 after step 0 and after the last step.
    The distances after each step, and how many exponents and parameter
    elements differ."""
    out = {"losses": got["losses"],
           "exps_differ": [sum(h.get(k) != v for k, v in w.items())
                           for h, w in zip(got["exps"], want["exps"])],
           "elements_differ": [sum(int((g[k] != v).sum()) for k, v in
                                   w.items())
                               for g, w in zip(got["params"],
                                               want["params"])],
           "rel_l2": [_rel_l2(g, w) for g, w in
                      zip(got["params"], want["params"])]}
    print(f"tp (d): {tag}: losses {got['losses']} / {want['losses']}; "
          f"exponents differing after each step {out['exps_differ']} of "
          f"{len(want['exps'][0])}; parameter elements differing "
          f"{out['elements_differ']} of "
          f"{sum(v.numel() for v in want['params'][0].values())}; leaves' "
          f"relative L2 after each step "
          + "; ".join(f"largest {r['largest']:.3g} ({r['largest_leaf']}), "
                      f"median {r['median']:.3g}" for r in out["rel_l2"])
          + f" (bound {TP_B50_REL_L2})", flush=True)
    check(math.isclose(got["losses"][0], want["losses"][0], rel_tol=1e-5),
          f"tp (d): {tag}: step 0's loss {got['losses'][0]} against "
          f"{want['losses'][0]}")
    check(set(got["exps"][0]) == set(want["exps"][0])
          and not out["exps_differ"][0],
          f"tp (d): {tag}: {out['exps_differ'][0]} exponents differ after "
          f"step 0")
    for s in (0, -1):
        r = out["rel_l2"][s]
        check(r["largest"] <= TP_B50_REL_L2,
              f"tp (d): {tag}: {r['largest_leaf']} is {r['largest']} away "
              f"in relative L2 after step {s % B50_GATE_STEPS} (bound "
              f"{TP_B50_REL_L2})")
    return out


def _tp_leg_b50() -> list:
    """Leg (d): configuration A at tp = 2 in 2 ranks.  The ranks'
    replicated state equal bitwise, and held by :func:`_held` against
    phase baseline50's one-rank steps on the same seed, weights and
    batches."""
    d = _tp_ranks("b50", 2)()
    check(d[0]["digest"] == d[1]["digest"] and
          d[0]["losses"] == d[1]["losses"] and
          d[0]["exps"] == d[1]["exps"], "tp (d): the ranks differ")
    got = d[0]
    d[1].pop("params")
    tp2 = {"losses": got["losses"], "exps": got["exps"],
           "params": got.pop("params")}
    print(f"tp (d): configuration A (sim_bf16 + prng) at tp = 2 (1 x 2, "
          f"{got['sharded_leaves']} sharded leaves), {B50_GATE_STEPS} "
          f"steps, ranks equal in all {len(got['digest'])} tensors; "
          f"launches {got['launches']}, in threefry mode "
          f"{got['threefry']}", flush=True)
    got["held"] = {"tp2": _held("tp = 2 against phase baseline50", tp2,
                                dict(B50_GATE))}
    for r, res in enumerate(d):
        _print_tp_rank("tp (d)", r, res)
    return d


def phase_tp(qmod, qops, quant, gemm, fused, r50) -> dict:
    """Tensor parallelism on the card, the ranks sharing it over gloo:
    (a) the headline at tp = 2 in 2 rank processes, equal to phase
    resnet50's one-rank kernel route in every tensor, then timed; (d)
    configuration A at tp = 2, held against phase baseline50's one-rank
    steps (:func:`_tp_leg_b50`), then timed; (b)
    ResNet-20 at 2 x 2 with the low-bit all-reduce in 4, kernel route
    equal to plain route, and (c) the CLI under torchrun with
    ``--tensor_parallel 2`` and a resume, (b) and (c) side by side; then
    each kernel's column-window form at (a)'s shapes against its plain
    version, timed."""
    t0 = time.perf_counter()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    a = _tp_ranks("r50", 2)()
    check(a[0]["backend"] == "gloo", "2 ranks on one card: gloo")
    check(a[0]["digest"] == a[1]["digest"] and
          a[0]["losses"] == a[1]["losses"], "tp (a): the ranks differ")
    diff = [k for k, v in r50["gate_digest"].items()
            if a[0]["digest"].get(k) != v]
    check(set(a[0]["digest"]) == set(r50["gate_digest"]) and not diff,
          f"tp (a): the tp = 2 steps differ from phase resnet50's one-rank "
          f"kernel route in {diff[:5]} ({len(diff)} tensors)")
    check(a[0]["losses"] == r50["losses"],
          f"tp (a): losses {a[0]['losses']}, one rank {r50['losses']}")
    print(f"tp (a): the headline at tp = 2 (1 x 2, {a[0]['sharded_leaves']} "
          f"sharded leaves), {R50_GATE_STEPS} steps equal to phase "
          f"resnet50's one-rank kernel route in all {len(r50['gate_digest'])}"
          f" tensors (tolerance 0), ranks equal; losses {a[0]['losses']}; "
          f"launches {a[0]['launches']}", flush=True)
    for r, res in enumerate(a):
        _print_tp_rank("tp (a)", r, res)
    torch.cuda.empty_cache()
    d = _tp_leg_b50()
    torch.cuda.empty_cache()
    wait_b = _tp_ranks("r20", 4)
    try:
        cli = _tp_cli()
    finally:
        b = wait_b()
    for r, res in enumerate(b):
        check(res["kernel"]["digest"] == res["plain"]["digest"] and
              res["kernel"]["losses"] == res["plain"]["losses"],
              f"tp (b) rank {r}: kernel and plain routes differ")
        twin = b[r ^ 1]  # the other model index of this data index
        check(twin["kernel"]["digest"] == res["kernel"]["digest"],
              f"tp (b) rank {r}: the model ranks of one data index differ")
    print(f"tp (b): ResNet-20 at dp x tp = 2 x 2, 4 ranks, global batch "
          f"{BATCH}, --lowbit_allreduce, {TP_R20_STEPS} steps: kernel route"
          f" == plain route on every rank in all "
          f"{len(b[0]['kernel']['digest'])} tensors (tolerance 0), model "
          f"ranks equal; losses {b[0]['kernel']['losses']}; rank 0 "
          f"launches {b[0]['kernel']['launches']}", flush=True)
    print(f"tp (c): torchrun 2 ranks on the card, --data_parallel "
          f"--tensor_parallel 2: 1 epoch ({cli['epochs_1_s']:.1f} s), "
          f"resumed to 2 ({cli['epochs_2_s']:.1f} s); losses "
          f"{cli['losses']}, test accuracy {cli['test_accuracy']}",
          flush=True)
    out = {"r50": a[0], "r50_rank1": {k: v for k, v in a[1].items()
                                      if k != "calls"},
           "b50": d[0], "b50_rank1": {k: v for k, v in d[1].items()
                                      if k != "calls"},
           "r20": b[0], "cli": cli}
    out["kernels"] = phase_tp_kernels(quant, gemm, fused,
                                      out["r50"].pop("calls"),
                                      r50["k2"]["shapes"],
                                      out["b50"].pop("calls")[0])
    out["seconds"] = time.perf_counter() - t0
    print(f"tp: phase took {out['seconds']:.1f} s", flush=True)
    return out


def port_modules():
    """Import every module of the port that this script drives and check
    that none of them loaded JAX, which the card's machine does not have,
    or anything of ``lbt_tpu``.  Returns the modules the phases take."""
    import lbt_tpu_torch.config  # noqa: F401
    import lbt_tpu_torch.data.imagefolder  # noqa: F401
    import lbt_tpu_torch.data.native  # noqa: F401
    import lbt_tpu_torch.data.tfrecord  # noqa: F401
    import lbt_tpu_torch.infer  # noqa: F401
    import lbt_tpu_torch.main  # noqa: F401
    import lbt_tpu_torch.models  # noqa: F401
    import lbt_tpu_torch.nn.core  # noqa: F401
    import lbt_tpu_torch.nn.norm  # noqa: F401
    import lbt_tpu_torch.train.step  # noqa: F401
    import lbt_tpu_torch.train.trainer  # noqa: F401
    from lbt_tpu_torch.dfxp import quantize as qmod
    from lbt_tpu_torch.ops import qops
    from lbt_tpu_torch.ops.kernels import build, gemm, quant
    check("jax" not in sys.modules, "importing lbt_tpu_torch loaded jax")
    check(not [m for m in sys.modules if m.split(".")[0] == "lbt_tpu"],
          "importing lbt_tpu_torch loaded lbt_tpu")
    return qmod, qops, build, gemm, quant


def kernel_lines(report) -> list:
    """The kernels: launches from the trainer's counted run,
    errors from every comparison; device, plain, bound and library ms per
    training step at the path's shapes (operands out of L2).  The step's
    K1 calls are stochastic or 9-bit, which no library call computes
    (``serve_8bit`` holds the serving forward's 8-bit calls beside
    ``torch.quantize_per_tensor``); #4/#5 have no library call that
    computes their function: ``conv_library_ms`` is cuDNN's conv alone.
    ``resnet50`` holds the same keys for the headline's path: launches of
    its 2 counted training steps, ms a step at its shapes and cadence;
    ``vgg16`` for configuration V's (K1, K2, #4; its path has no 1x1
    conv): launches of its 2 counted steps, ms a step at its shapes;
    ``records`` the launches of each CLI run of phase records (the
    headline from each streaming source that ran, ResNet-20 through the
    native loader), whose shapes are those of ``resnet50`` and the
    trainer's; ``dp`` rank 0's launches in phase dp (ResNet-20's 2
    counted steps, the headline's a step), at the shapes of half the
    batch; ``tp`` rank 0's launches in phase tp leg (a) (the headline at
    tp = 2: its 2 counted steps, and the last one's) and each kernel's
    column-window form at its shapes (K2: the shapes a one-rank step does
    not have); ``tp_baseline50`` the same for K1 in threefry mode in leg
    (d) (configuration A at tp = 2: its 2 counted steps, and the last
    one's); ``remat`` the launches of phase remat's counted runs (2
    steps of ResNet-20 and of the headline under each BN flag) and of
    the trainer phase's ``--scan_steps`` run (``scanned``).  The
    ``_rbg`` rows are K1 and #4/#5 in mode 4 (an
    unsafe_rbg key's Philox stream) from phase rbg: ResNet-20 at batch
    512, launches of its 2 counted steps, ms a step at its shapes.  The
    conv backward's rows (``conv_dgrad``, ``conv_wgrad``) add the im2col
    route's ms for the same calls (``im2col_route_ms``) and cuDNN's fp16
    dgrad / wgrad alone (``cudnn_fp16_ms``, not the same function), and
    ``tp_launches``, rank 0's in phase tp leg (a)."""
    k1, k2, fused = report["k1_train"], report["k2_train"], report["fused"]
    bwd = report["conv_bwd"]
    launches = report["trainer"]["launches"]
    rec = report["records"]
    rec_runs = {**rec["cli"], **({"native_loader": rec["native_loader"]}
                                 if "native_loader" in rec else {})}

    def at_records(*kinds):
        return {run: sum(r["launches"][k] for k in kinds)
                for run, r in rec_runs.items()}
    dp = report["dp"]

    def at_dp(*kinds):
        """Rank 0's launches in phase dp: ResNet-20's counted steps, the
        headline's a step."""
        return {"resnet20": sum(dp["r20"]["launches"][k] for k in kinds),
                "resnet50_a_step": sum(dp["r50"]["launches_per_step"][k]
                                       for k in kinds)}
    r50 = report["resnet50"]
    r50_launches = r50["launches"]
    remat = report["remat"]

    def at_remat(*kinds):
        """Phase remat's counted runs, and the scanned trainer run's."""
        out = {f"{model}_{flag}": sum(run["launches"][k] for k in kinds)
               for model in ("resnet20", "resnet50")
               for flag, run in remat[model].items() if isinstance(run, dict)}
        out["scanned"] = sum(report["trainer"]["scanned"]["launches"][k]
                             for k in kinds)
        return out

    def times(t, library=True):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["lib_ms"] if library else None}

    def at_r50(t, n, library=True, **extra):
        return {"launches": n, "max_abs_err": t["max_abs_err"],
                **times(t, library), **extra}

    tp = report["tp"]

    def at_tp(t, kinds, library=True, **extra):
        """Phase tp leg (a)'s launches on rank 0 (its 2 counted steps, and
        the last one's), and the column-window form at its shapes."""
        return {"launches": sum(tp["r50"]["launches"][k] for k in kinds),
                "launches_a_step": sum(tp["r50"]["launches_per_step"][k]
                                       for k in kinds),
                "max_abs_err": t["max_abs_err"], **times(t, library),
                **extra}
    tpk = tp["kernels"]
    tp_b50 = {"launches": tp["b50"]["launches"]["k1"],
              "launches_a_step": tp["b50"]["launches_per_step"]["k1"],
              "max_abs_err": tpk["k1_threefry"]["max_abs_err"],
              **times(tpk["k1_threefry"], library=False)}

    v = report["vgg16"]
    v_launches = v["launches"]
    v3 = v["fused"]["conv3x3_fused"]
    c3, c1 = fused["conv3x3_fused"], fused["conv1x1_fused"]
    r3, r1 = r50["fused"]["conv3x3_fused"], r50["fused"]["conv1x1_fused"]
    tf = report["trainer"]["defaults"]["threefry_launches"]
    b50 = report["baseline50"]
    threefry = [
        {"name": "k1_quantize_threefry", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/quantize.cu",
         "replaces": "lbt_tpu/ops/pallas/quant_kernels.py:126",
         "launches": tf["k1"],
         "max_abs_err": max(report["k1"]["max_abs_err"], k1["max_abs_err"],
                            b50["k1"]["max_abs_err"],
                            tp_b50["max_abs_err"]),
         **times(k1["threefry"], library=False),
         "baseline50": at_r50(b50["k1"], b50["threefry_launches"]["k1"],
                              False), "tp_baseline50": tp_b50},
        {"name": "conv3x3_fused_threefry", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/conv_fused.cuh",
         "replaces": "lbt_tpu/ops/pallas/conv_kernels.py:170",
         "launches": tf["conv3x3"], "max_abs_err": c3["max_abs_err"],
         **times(c3["threefry"], library=False),
         "conv_library_ms": c3["threefry"]["lib_ms"]},
        {"name": "conv1x1_fused_threefry", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/conv_fused.cuh",
         "replaces": "lbt_tpu/ops/pallas/conv1x1_kernels.py:146",
         "launches": tf["conv1x1"], "max_abs_err": c1["max_abs_err"],
         **times(c1["threefry"], library=False),
         "conv_library_ms": c1["threefry"]["lib_ms"]},
    ]
    rb = report["rbg"]

    def at_rbg(t, kind):
        """Phase rbg's counted gate steps, and its rows a step at batch
        512: the bound by mode 4's instructions, the plain version,
        ``torch.rand`` of as many uniforms (``rng_ms``: a yardstick of
        the generator, not the function: ``library_ms`` stays null), and
        the kernel's device ms a step in the profiles of rbg-int8
        (``profile_ms``) and of prng-int8 (``threefry_ms``)."""
        return {"launches": rb["launches"][kind],
                "max_abs_err": max(t["max_abs_err"],
                                   rb["forms"]["max_abs_err"]),
                **times(t, library=False), "rng_ms": t["rng_ms"],
                "profile_ms": t["profile_ms"],
                "threefry_ms": t["threefry_ms"]}
    rbg = [
        {"name": "k1_quantize_rbg", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/quantize.cu",
         "replaces": "lbt_tpu/ops/pallas/quant_kernels.py:126",
         **at_rbg(rb["k1"], "k1")},
        {"name": "conv3x3_fused_rbg", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/conv_fused.cuh",
         "replaces": "lbt_tpu/ops/pallas/conv_kernels.py:170",
         **at_rbg(rb["fused"]["conv3x3_fused"], "conv3x3")},
        {"name": "conv1x1_fused_rbg", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/conv_fused.cuh",
         "replaces": "lbt_tpu/ops/pallas/conv1x1_kernels.py:146",
         **at_rbg(rb["fused"]["conv1x1_fused"], "conv1x1")},
    ]
    return threefry + rbg + [
        {"name": "k1_quantize", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/quantize.cu",
         "replaces": "lbt_tpu/ops/pallas/quant_kernels.py:126",
         "launches": launches["k1"],
         "max_abs_err": max(report["k1"]["max_abs_err"], k1["max_abs_err"],
                            r50["k1"]["max_abs_err"], v["k1"]["max_abs_err"]),
         **times(k1, library=False),
         "serve_8bit": report["k1"]["library_8bit"],
         "resnet50": at_r50(r50["k1"], r50_launches["k1"], False),
         "vgg16": at_r50(v["k1"], v_launches["k1"], False),
         "records": at_records("k1"), "dp": at_dp("k1"),
         "remat": at_remat("k1"),
         "tp": at_tp(tpk["k1"], ("k1",), False)},
        {"name": "k2_int8_gemm", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/int8_gemm.cu",
         "replaces": "lbt_tpu/ops/pallas/quant_kernels.py:187",
         "launches": launches["k2"] + launches["k2_tn"],
         "max_abs_err": max(report["k2"]["max_abs_err"], k2["max_abs_err"],
                            r50["k2"]["max_abs_err"], v["k2"]["max_abs_err"]),
         **times(k2),
         "resnet50": at_r50(r50["k2"], r50_launches["k2"]
                            + r50_launches["k2_tn"],
                            forms=r50["k2"]["forms"]),
         "vgg16": at_r50(v["k2"], v_launches["k2"] + v_launches["k2_tn"],
                         forms=v["k2"]["forms"]),
         "records": at_records("k2", "k2_tn"), "dp": at_dp("k2", "k2_tn"),
         "remat": at_remat("k2", "k2_tn"),
         "tp": at_tp(tpk["k2"], ("k2", "k2_tn"))},
        {"name": "conv3x3_fused", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/conv_fused.cuh",
         "replaces": "lbt_tpu/ops/pallas/conv_kernels.py:170",
         "launches": launches["conv3x3"],
         "max_abs_err": max(c3["max_abs_err"], r3["max_abs_err"],
                            v3["max_abs_err"]),
         **times(c3, library=False), "conv_library_ms": c3["lib_ms"],
         "resnet50": at_r50(r3, r50_launches["conv3x3"], False,
                            conv_library_ms=r3["lib_ms"]),
         "vgg16": at_r50(v3, v_launches["conv3x3"], False,
                         conv_library_ms=v3["lib_ms"]),
         "records": at_records("conv3x3"), "dp": at_dp("conv3x3"),
         "remat": at_remat("conv3x3"),
         "tp": at_tp(tpk["conv3x3_fused"], ("conv3x3",), False,
                     conv_library_ms=tpk["conv3x3_fused"]["lib_ms"])},
        {"name": "conv1x1_fused", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/conv_fused.cuh",
         "replaces": "lbt_tpu/ops/pallas/conv1x1_kernels.py:146",
         "launches": launches["conv1x1"],
         "max_abs_err": max(c1["max_abs_err"], r1["max_abs_err"]),
         **times(c1, library=False), "conv_library_ms": c1["lib_ms"],
         "resnet50": at_r50(r1, r50_launches["conv1x1"], False,
                            conv_library_ms=r1["lib_ms"]),
         "records": at_records("conv1x1"), "dp": at_dp("conv1x1"),
         "remat": at_remat("conv1x1"),
         "tp": at_tp(tpk["conv1x1_fused"], ("conv1x1",), False,
                     conv_library_ms=tpk["conv1x1_fused"]["lib_ms"])},
    ] + [
        {"name": f"conv_{kind}", "route": "cuda",
         "source": "lbt_tpu_torch/csrc/conv_bwd.cu",
         "replaces": "none: XLA emitted lbt_tpu's conv backward",
         "launches": launches[kind],
         "max_abs_err": max(bwd[kind]["max_abs_err"],
                            r50["conv_bwd"][kind]["max_abs_err"],
                            v["conv_bwd"][kind]["max_abs_err"]),
         **times(bwd[kind], library=False),
         "im2col_route_ms": bwd[kind]["old_ms"],
         "cudnn_fp16_ms": bwd[kind]["lib_ms"],
         "resnet50": at_r50(r50["conv_bwd"][kind], r50_launches[kind], False,
                            im2col_route_ms=r50["conv_bwd"][kind]["old_ms"],
                            cudnn_fp16_ms=r50["conv_bwd"][kind]["lib_ms"]),
         "vgg16": at_r50(v["conv_bwd"][kind], v_launches[kind], False,
                         im2col_route_ms=v["conv_bwd"][kind]["old_ms"],
                         cudnn_fp16_ms=v["conv_bwd"][kind]["lib_ms"]),
         "records": at_records(kind), "dp": at_dp(kind),
         "remat": at_remat(kind),
         "tp_launches": tp["r50"]["launches"][kind]}
        for kind in ("dgrad", "wgrad")]


# the phase running now, named in the report of a failure
PHASE = ["start"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    PHASE[0] = "device"
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke needs one")
    PHASE[0] = "imports"
    check((REPO / "lbt_tpu_torch").is_dir(),
          f"no lbt_tpu_torch package beside {__file__}: run chip_smoke.py "
          f"from the root of a checkout")
    qmod, qops, build, gemm, quant = port_modules()
    from lbt_tpu_torch.ops.kernels import conv_fused

    report = {}

    seconds = report["phase_seconds"] = {}

    def phase(name, fn, *fargs):
        PHASE[0] = name
        t0 = time.perf_counter()
        report[name] = fn(*fargs)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name} took {seconds[name]:.1f} s", flush=True)
        return report[name]

    phase("device", phase_device)
    phase("build", phase_build, build)
    PHASE[0] = "serve shapes"
    probe = build_resnet20(SEED).to("cuda")
    x = torch.from_numpy(np.random.default_rng(SEED + 3).normal(
        0, 1, (BATCH, 32, 32, 3)).astype(np.float32)).cuda()
    k1_calls, k2_calls = record_path_calls(probe, x, qmod, qops, quant,
                                           gemm)
    phase("k1", phase_k1, quant, k1_calls)
    phase("k2", phase_k2, gemm, k2_calls)
    phase("serve", phase_serve, quant, gemm, qmod, qops)
    from lbt_tpu_torch.infer import Predictor
    phase("profile", phase_profile, Predictor(probe), x)

    PHASE[0] = "train shapes"
    k1_t, k2_t, tn_t, conv_t, bwd_t = record_train_calls(
        qmod, qops, quant, gemm, conv_fused)
    phase("k1_train", phase_k1_train, quant, k1_t, REPS, "K1-stats", True)
    phase("k2_train", phase_k2_train, gemm, k2_t, tn_t)
    phase("fused", phase_fused, conv_fused, conv_t, REPS, True)
    phase("conv_bwd", phase_conv_bwd, qops, bwd_t)
    phase("train", phase_train, qmod, qops, quant, gemm, conv_fused)
    phase("rbg", phase_rbg, qmod, qops, quant, gemm, conv_fused)
    phase("trainer", phase_trainer, quant, gemm, conv_fused,
          report["device"]["nvidia_smi"])
    phase("resnet50", phase_resnet50, qmod, qops, quant, gemm, conv_fused)
    phase("baseline50", phase_baseline50, qmod, qops, quant, gemm,
          conv_fused)
    report["vs_baseline"] = (report["resnet50"]["img_per_s"]
                             / report["baseline50"]["img_per_s"])
    print(f"vs_baseline (bench.py's ratio, the port's first reading): the "
          f"headline's {report['resnet50']['img_per_s']:.1f} img/s (phase "
          f"resnet50) over the baseline's "
          f"{report['baseline50']['img_per_s']:.1f} (phase baseline50) = "
          f"{report['vs_baseline']:.3f}", flush=True)
    phase("remat", phase_remat, qmod, qops, quant, gemm, conv_fused,
          report["resnet50"])
    phase("vgg16", phase_vgg16, qmod, qops, quant, gemm, conv_fused)
    phase("zoo", phase_zoo, quant, gemm, conv_fused)
    phase("records", phase_records, quant, gemm, conv_fused,
          report["resnet50"]["ms_per_step"])
    phase("dp", phase_dp, qmod, qops, quant, gemm, conv_fused)
    phase("tp", phase_tp, qmod, qops, quant, gemm, conv_fused,
          report["resnet50"])

    PHASE[0] = "report"
    kernels = kernel_lines(report)
    report["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["device"]["kind"],
        "count": report["device"]["count"]}}))
    return 0


def run() -> int:
    """``main`` with every failure reported: the phase that failed and its
    traceback on stderr (a line on stdout too), then exit status 1; no
    result line is printed.  A crash below Python (a fault in a kernel)
    dumps the Python stack through ``faulthandler``."""
    faulthandler.enable()
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--tp-worker"]:
        return tp_worker(sys.argv[2:])
    try:
        return main()
    except Exception as e:  # noqa: BLE001 -- reported, then exit 1
        sys.stdout.flush()
        print(f"chip_smoke: FAILED in phase {PHASE[0]}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
        print(f"chip_smoke: FAILED in phase {PHASE[0]} (traceback on "
              f"stderr)", flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(run())
