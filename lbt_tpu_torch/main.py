"""Experiment CLI of the PyTorch port: ``main.py``'s flags and defaults,
plus ``--device``.

    python -m lbt_tpu_torch.main                  # main.py's defaults
    python -m lbt_tpu_torch.main --model CIFAR10_Resnet20 --bits 8 \\
        --noise_mode hash --batch_size 128 --device cuda
    python -m lbt_tpu_torch.main --model VGG16_CIFAR100 --bits_w 4 \\
        --bits_a 8 --bits_g 8 --batch_size 256
    python -m lbt_tpu_torch.main --model Imagenet_Resnet50 \\
        --batch_size 128 --tfrecord_train 'shards/train-*' \\
        --tfrecord_val 'shards/val-*' --num_classes 1000
    python -m lbt_tpu_torch.main --model Imagenet_Resnet50 \\
        --batch_size 128 --data_dir imagenet   # imagenet/{train,val}/<class>/
    python -m lbt_tpu_torch.main --model CIFAR10_Resnet20 --native_loader
    python -m torch.distributed.run --nproc_per_node 2 \
        -m lbt_tpu_torch.main --data_parallel --lowbit_allreduce \
        --lowbit_wire int8          # one process a rank (parallel/)
    python -m torch.distributed.run --nproc_per_node 4 \
        -m lbt_tpu_torch.main --data_parallel --tensor_parallel 2
                                    # a 2 x 2 data x model layout

A command line of ``main.py`` runs here unchanged, its defaults included
(``--noise_mode prng`` draws ``jax.random``'s threefry stream bit for
bit), ``--remat_bn``, ``--bn_residual_q16`` and ``--scan_steps`` too.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from typing import List, Optional

import torch

from lbt_tpu_torch import parallel
from lbt_tpu_torch.config import QuantConfig, TrainConfig
from lbt_tpu_torch.data.datasets import aug_spec, load_dataset, make_augment
from lbt_tpu_torch.data.imagefolder import streaming_dataset
from lbt_tpu_torch.data.tfrecord import tfrecord_dataset
from lbt_tpu_torch.models import build_model
from lbt_tpu_torch.models.zoo import MODEL_DATASET, MODEL_REGISTRY
from lbt_tpu_torch.train.step import debug_nans
from lbt_tpu_torch.train.trainer import Trainer
from lbt_tpu_torch.utils.logging import get_logger, null_logger


PROG = "python -m lbt_tpu_torch.main"


def _fail(msg: str):
    """Exit with argparse's status for a bad command line, 2."""
    print(f"{PROG}: error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG, description="DFXP low-bit training, PyTorch port")
    p.add_argument("--exp_path", type=str, default=None)
    p.add_argument("--model", type=str, default="CIFAR10_Resnet20",
                   choices=sorted(MODEL_REGISTRY))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on ('cuda', 'cuda:1', "
                        "'cpu'); 'cuda' without a card is an error")
    # quantization
    p.add_argument("--bits", type=int, default=8,
                   help="uniform bit-width (32 = fp32 passthrough)")
    p.add_argument("--bits_w", type=int, default=None)
    p.add_argument("--bits_a", type=int, default=None)
    p.add_argument("--bits_g", type=int, default=None)
    p.add_argument("--engine", type=str, default="int8",
                   choices=["sim", "sim_bf16", "int8", "pallas"])
    p.add_argument("--target_overflow_rate", type=float, default=0.0)
    p.add_argument("--deterministic_rounding", action="store_true",
                   help="round-to-nearest-even instead of stochastic")
    p.add_argument("--noise_mode", type=str, default="prng",
                   choices=["prng", "hash", "hash1"],
                   help="stochastic-rounding noise: jax.random's threefry "
                        "uniforms ('prng'), the counter hash ('hash') or "
                        "its single-round form ('hash1')")
    p.add_argument("--conv_act_extra", type=int, default=1,
                   help="extra bits for conv activations over --bits_a")
    p.add_argument("--fused_bn", action="store_true")
    p.add_argument("--act_dtype", type=str, default="f32",
                   choices=["f32", "bf16"])
    p.add_argument("--bn_residual_q16", action="store_true")
    p.add_argument("--remat_bn", action="store_true")
    p.add_argument("--initial_exponent_g", type=int, default=None,
                   help="cold-start exponent of the gradient sites")
    p.add_argument("--stem_s2d", action="store_true")
    p.add_argument("--range_update_every", type=int, default=1,
                   help="run the range controllers every K-th step")
    p.add_argument("--bn_momentum", type=float, default=0.999,
                   help="BN running-stats EMA momentum")
    p.add_argument("--faithful_eval", action="store_true")
    p.add_argument("--noise_shared_axis0", action="store_true")
    p.add_argument("--reset_momentum_on_decay", action="store_true")
    # training
    p.add_argument("--dropout", type=float, default=0.5,
                   help="dropout KEEP probability")
    p.add_argument("--weight_decay", type=float, default=2e-4)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--lr_decay_factor", type=float, default=0.1)
    p.add_argument("--lr_decay_epochs", type=int, nargs="*",
                   default=[80, 120, 140])
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_epoch", type=int, default=160)
    p.add_argument("--seed", type=int, default=0)
    # data / scale
    p.add_argument("--n_train", type=int, default=0)
    p.add_argument("--n_test", type=int, default=0)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--tfrecord_train", type=str, default=None)
    p.add_argument("--tfrecord_val", type=str, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--resume", action="store_true",
                   help="accepted; a run always resumes from the latest "
                        "checkpoint under <exp_path>/ckpt")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="write a torch.profiler trace of this many steps")
    p.add_argument("--native_loader", action="store_true")
    p.add_argument("--log_every", type=int, default=100,
                   help="log train metrics every N batches")
    p.add_argument("--scan_steps", type=int, default=0)
    p.add_argument("--data_parallel", action="store_true",
                   help="one rank a process (torch.distributed.run); "
                        "sync-BN, synced controllers, summed gradients")
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--debug_nans", action="store_true",
                   help="fail a step whose outputs hold a NaN (the port's "
                        "jax_debug_nans)")
    p.add_argument("--lowbit_allreduce", action="store_true",
                   help="DFXP-int8 gradient all-reduce with error "
                        "feedback (implies --data_parallel)")
    p.add_argument("--lowbit_wire", type=str, default=None,
                   choices=["int16", "int8"])
    p.add_argument("--gradient_buffer", action="store_true")
    return p


def quant_config(args) -> QuantConfig:
    """``main.py``'s QuantConfig of a command line: the FP32 passthrough
    (``QuantConfig.fp32()``, engine ``sim``) when every width is 32, else
    the flags as given (conv activations get no extra bit past a 32-bit
    ``bits_a``)."""
    bw = args.bits_w if args.bits_w is not None else args.bits
    ba = args.bits_a if args.bits_a is not None else args.bits
    bg = args.bits_g if args.bits_g is not None else args.bits
    if bw >= 32 and ba >= 32 and bg >= 32:
        return QuantConfig.fp32(stem_s2d=args.stem_s2d)
    return QuantConfig(
        bits_w=bw, bits_a=ba, bits_b=bw, bits_g=bg,
        conv_act_extra=0 if ba >= 32 else args.conv_act_extra,
        target_overflow_rate=args.target_overflow_rate,
        stochastic=not args.deterministic_rounding,
        noise_shared_axis0=args.noise_shared_axis0,
        noise_mode=args.noise_mode,
        engine=args.engine,
        fused_bn=args.fused_bn,
        bn_momentum=args.bn_momentum,
        faithful_eval=args.faithful_eval,
        range_update_every=args.range_update_every,
        act_dtype=args.act_dtype,
        remat_bn=args.remat_bn,
        bn_residual_q16=args.bn_residual_q16,
        initial_exponent_g=args.initial_exponent_g,
        stem_s2d=args.stem_s2d,
    )


def load_data(args, model, ds_name: str, logger):
    """``main.py``'s data branch: TFRecord shards, an ImageFolder tree
    (``<data_dir>/train``, ``<data_dir>/val`` where it exists) or the
    in-memory dataset of the model.  The streaming sources decode at the
    model's input size and augment on the host; ``--num_classes`` reaches
    the data only, the model keeps its head.  Returns ``(data,
    augment)``."""
    if args.tfrecord_train:
        if args.num_classes is None:
            raise SystemExit("--tfrecord_train requires --num_classes")
        if args.native_loader:
            raise SystemExit("--native_loader needs in-memory arrays; "
                             "drop it when streaming TFRecords")
        data = tfrecord_dataset(
            args.tfrecord_train, args.tfrecord_val,
            image_size=model.input_shape[0], seed=args.seed,
            num_classes=args.num_classes)
        return data, None
    if args.data_dir:
        if args.native_loader:
            raise SystemExit("--native_loader needs in-memory arrays; "
                             "drop it when using --data_dir streaming")
        val = os.path.join(args.data_dir, "val")
        data = streaming_dataset(
            os.path.join(args.data_dir, "train"),
            val if os.path.isdir(val) else None,
            image_size=model.input_shape[0], seed=args.seed)
        return data, None
    data = load_dataset(ds_name, n_train=args.n_train, n_test=args.n_test)
    if data["synthetic"]:
        logger.warning("dataset %s not found locally - SYNTHETIC data",
                       ds_name)
    return data, None if args.no_augment else make_augment(ds_name)


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Run the experiment; returns the finished :class:`Trainer`."""
    p = build_parser()
    args = p.parse_args(argv)
    for name in ("bits", "bits_w", "bits_a", "bits_g"):
        v = getattr(args, name)
        if v is not None and not (1 <= v <= 32):
            _fail(f"--{name} must be in 1..32 (32 = fp32 passthrough), "
                    f"got {v}")
    if args.gradient_buffer and not args.model.startswith("CIFAR10_Resnet"):
        _fail("--gradient_buffer only supported for the CIFAR10_Resnet* "
              "models (reference sites)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        _fail(f"--device {args.device}: no CUDA device is available "
                f"(pass --device cpu to train on the CPU)")
    exp = args.exp_path or os.path.join(
        "experiments",
        datetime.datetime.now().strftime("%m-%d-%H%M%S") + "-" + args.model)
    os.makedirs(exp, exist_ok=True)
    # rank 0 alone logs (torchrun's RANK; 0 in a single process)
    logger = None
    if int(os.environ.get("RANK", "0")) == 0:
        logger = get_logger(os.path.join(exp, "experiment.log"))
        logger.info("Start of experiment: %s",
                    json.dumps(vars(args), sort_keys=True))
    # one process a rank: join the group before anything is built
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        group = parallel.initialize(str(device))
        device = group.device

    cfg = quant_config(args)
    tc = TrainConfig(
        lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, batch_size=args.batch_size,
        n_epoch=args.n_epoch, lr_decay_factor=args.lr_decay_factor,
        lr_decay_epochs=tuple(args.lr_decay_epochs),
        warmup_epochs=args.warmup_epochs,
        dropout_keep=args.dropout,
        reset_momentum_on_decay=args.reset_momentum_on_decay,
        seed=args.seed,
        log_every=args.log_every,
        checkpoint_every_epochs=args.checkpoint_every,
        checkpoint_dir=os.path.join(exp, "ckpt"),
        data_parallel=args.data_parallel or args.lowbit_allreduce,
        tensor_parallel=args.tensor_parallel,
        lowbit_allreduce=args.lowbit_allreduce,
        lowbit_wire=args.lowbit_wire,
        scan_steps=args.scan_steps,
    )
    model_kw = dict(dropout_keep=args.dropout,
                    weight_decay=args.weight_decay)
    if args.gradient_buffer:
        model_kw["gradient_buffer_batch"] = args.batch_size
    model = build_model(args.model, cfg, **model_kw)
    ds_name = MODEL_DATASET[args.model]
    data, augment = load_data(args, model, ds_name, logger or null_logger())

    # Trainer.train() resumes from checkpoint_dir when it holds one
    trainer = Trainer(model, tc, data, augment=augment, logger=logger,
                      logdir=exp, profile_steps=args.profile_steps,
                      native_loader=args.native_loader,
                      aug_spec=aug_spec(ds_name), device=device, group=group)
    try:
        with debug_nans(args.debug_nans):
            final = trainer.train()
        trainer.logger.info("End of experiment: final test acc %.4f loss "
                            "%.4f", final["accuracy"], final["loss"])
    finally:
        trainer.metrics.close()
        if group is not None:
            torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
