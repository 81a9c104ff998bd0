#!/usr/bin/env python3
"""ImageNet training CLI of the PyTorch port, one process per device.
Port of the JAX package's root `train.py`, with its flag surface:

    python -m imagenet_models_tpu_torch.cli.train DATA --model map_convnext_tiny \\
        -b 128 --amp --epochs 300 --output ./output/train
    torchrun --nproc_per_node 8 -m imagenet_models_tpu_torch.cli.train DATA \\
        --model map_convnext_tiny -b 128 --amp --dist-coordinator auto [--zero1]

DATA is a dataset folder (root/<split>/<class>/<image>) or
`synthetic[-cls][:train_len[:val_len]]`. It runs on the GPU; with
IMTPU_PLATFORM=cpu (the variable the JAX CLI reads for the same purpose) it
runs on the CPU, and without a GPU and without that variable it raises.

As in the JAX CLI: `--amp` selects bf16 compute over fp32 parameters, and
fp32 compute without it; `-b` is the microbatch, `-tb`/`--grad-accumulation`
give the accumulation; the EMA model's eval metrics are THE eval metrics;
`--channels-last`, `--pin-mem`, `--no-prefetcher` and the other runtime
flags of the reference are accepted no-ops. `-c FILE` reads YAML defaults
(PyYAML is imported only then).

Fine-tuning: `-fp FILE.pth.tar` loads a reference checkpoint after
`--pretrained` and `--initial-checkpoint`, with the classifier fc dropped,
or with `-pt` remapped from 21k classes to 1k through `--in21k-1k-map`
(`ckpt.finetune`); relative-position tables are re-resolved to the model's
input size, so a 224 px MaxViT checkpoint fine-tunes `maxvit_tiny_tf_384`.

Data parallelism: each process drives one GPU (NCCL) or, with
IMTPU_PLATFORM=cpu, the CPU (gloo). `--dist-coordinator host:port` with
`--dist-num-processes` and `--dist-process-id`, or `auto` under torchrun
(its environment; a `--local_rank` alone means `auto` too) joins the group.
`-b` is per process: the global batch is b x processes x accumulation. Every
rank starts from rank 0's weights, gradients are mean-all-reduced each step,
and `--zero1` shards the optimizer state and the EMA shadow over the ranks
with synchronised BatchNorm statistics (train/state.py). Rank 0 writes the
run directory; checkpoints resume at any world size.
"""

import argparse
import json
import logging
import os
from datetime import datetime

from imagenet_models_tpu_torch.cli import Truncate, entry_device
from imagenet_models_tpu_torch.data.dataset import create_dataset
from imagenet_models_tpu_torch.data.loader import create_loader

_logger = logging.getLogger("train")

config_parser = argparse.ArgumentParser(description="Training Config", add_help=False)
config_parser.add_argument("-c", "--config", default="", type=str, metavar="FILE",
                           help="YAML config file overriding argparse defaults")

parser = argparse.ArgumentParser(description="ImageNet training (PyTorch port, one GPU per process)")
# Dataset / model
parser.add_argument("data_dir", metavar="DIR", help="path to dataset (or 'synthetic')")
parser.add_argument("--dataset", "-d", default="", type=str)
parser.add_argument("--train-split", default="train", type=str)
parser.add_argument("--val-split", default="validation", type=str)
parser.add_argument("--model", default="ga_convnext_tiny", type=str)
parser.add_argument("--pretrained", action="store_true", default=False)
parser.add_argument("--initial-checkpoint", default="", type=str,
                    help=".pth.tar (torch) or a port checkpoint to load weights from")
parser.add_argument("--resume", default="", type=str,
                    help="port checkpoint (a directory such as last/) to resume full state from")
parser.add_argument("-ri", "--resume-id", default=None, type=str,
                    help="wandb run id to resume logging into (MAP/train.py:412-416)")
parser.add_argument("-fp", "--finetuning-checkpoint", default="", type=str,
                    help="reference .pth.tar to fine-tune from: its classifier fc is dropped "
                         "(or remapped with -pt), the rest loads with strict=False")
parser.add_argument("-pt", "--in21k-to-in1k", action="store_true", default=False,
                    help="remap a 21k-class head to 1k classes (MAP/train.py:462-475)")
parser.add_argument("--in21k-1k-map", "--in21k_1k_map", default="in21k_1k_map.json", type=str,
                    help='class-map JSON {"in1k_idx": [...], "in21k_idx": [...]} for -pt')
parser.add_argument("--class-map", default="", type=str, metavar="FILENAME",
                    help="class-to-idx mapping file: one class name per line, "
                         "index = line number (timm load_class_map semantics)")
parser.add_argument("--dataset-download", action="store_true", default=False,
                    help="accepted no-op: datasets are local directories here")
parser.add_argument("--gp", default=None, type=str, metavar="POOL",
                    help="global pool override; factories fix the pooling here, "
                         "so any non-default value fails loudly")
parser.add_argument("--bn-eps", type=float, default=None,
                    help="BN epsilon override; unsupported (fails loudly if set)")
parser.add_argument("--bn-momentum", type=float, default=None,
                    help="BN momentum override; unsupported (fails loudly if set)")
parser.add_argument("--no-resume-opt", action="store_true", default=False)
parser.add_argument("--num-classes", type=int, default=None)
parser.add_argument("--img-size", type=int, default=None)
parser.add_argument("--input-size", default=None, nargs=3, type=int,
                    metavar="N N N", help="C H W (torch order, kept for CLI parity)")
parser.add_argument("--test-input-size", default=None, nargs=3, type=int)
parser.add_argument("--crop-pct", default=None, type=float)
parser.add_argument("--mean", type=float, nargs="+", default=None)
parser.add_argument("--std", type=float, nargs="+", default=None)
parser.add_argument("--interpolation", default="", type=str)
parser.add_argument("-b", "--batch-size", type=int, default=128,
                    help="per-device microbatch size")
parser.add_argument("-tb", "--total-batch-size", type=int, default=None,
                    help="effective global batch per optimizer update")
parser.add_argument("-vb", "--validation-batch-size", type=int, default=None)
# Optimizer
parser.add_argument("--opt", default="lamb", type=str)
parser.add_argument("--opt-eps", default=None, type=float,
                    help="None -> the optimizer's own default (lamb 1e-6, "
                         "adamw 1e-8), as the reference parser (GA/train.py:128)")
parser.add_argument("--opt-betas", default=None, type=float, nargs="+")
parser.add_argument("--momentum", type=float, default=0.9)
parser.add_argument("--weight-decay", type=float, default=0.05)
parser.add_argument("--clip-grad", type=float, default=None)
parser.add_argument("--clip-mode", type=str, default="norm")
# LR schedule
parser.add_argument("--sched", default="cosine", type=str)
parser.add_argument("--lr", type=float, default=5e-3)
parser.add_argument("--warmup-lr", type=float, default=1e-6)
parser.add_argument("--min-lr", type=float, default=1e-5)
parser.add_argument("--epochs", type=int, default=300)
parser.add_argument("--warmup-epochs", type=int, default=5)
parser.add_argument("--cooldown-epochs", type=int, default=10)
parser.add_argument("--decay-epochs", type=float, default=100)
parser.add_argument("--decay-rate", "--dr", type=float, default=0.1)
parser.add_argument("--lr-noise", type=float, nargs="+", default=None, metavar="pct, pct",
                    help="LR noise on/off epoch percentages (GA/train.py:147-148)")
parser.add_argument("--lr-noise-pct", type=float, default=0.67)
parser.add_argument("--lr-noise-std", type=float, default=1.0)
parser.add_argument("--lr-cycle-mul", type=float, default=1.0)
parser.add_argument("--lr-cycle-decay", type=float, default=0.5)
parser.add_argument("--lr-cycle-limit", type=int, default=1)
parser.add_argument("--lr-k-decay", type=float, default=1.0)
parser.add_argument("--patience-epochs", type=int, default=10,
                    help="plateau scheduler only (create_scheduler rejects sched=plateau)")
parser.add_argument("--start-epoch", default=None, type=int,
                    help="manual epoch number (useful on restarts)")
parser.add_argument("--epoch-repeats", type=float, default=0.,
                    help="accepted no-op: inert for folder/map-style datasets in the "
                         "reference too (timm only honors it for iterable datasets)")
# Augmentation & regularization
parser.add_argument("--no-aug", action="store_true", default=False)
parser.add_argument("--scale", type=float, nargs="+", default=[0.08, 1.0])
parser.add_argument("--ratio", type=float, nargs="+", default=[3. / 4., 4. / 3.])
parser.add_argument("--hflip", type=float, default=0.5)
parser.add_argument("--vflip", type=float, default=0.0)
parser.add_argument("--color-jitter", type=float, default=0.4)
parser.add_argument("--aa", type=str, default=None, help="rand augment spec, e.g. rand-m9-mstd0.5-inc1")
parser.add_argument("--smoothing", type=float, default=0.1)
parser.add_argument("--bce-loss", action="store_true", default=False)
parser.add_argument("--bce-target-thresh", type=float, default=None)
parser.add_argument("--jsd-loss", action="store_true", default=False)
parser.add_argument("--train-interpolation", type=str, default="random")
parser.add_argument("--reprob", type=float, default=0.0)
parser.add_argument("--remode", type=str, default="pixel")
parser.add_argument("--recount", type=int, default=1)
parser.add_argument("--mixup", type=float, default=0.0)
parser.add_argument("--cutmix", type=float, default=0.0)
parser.add_argument("--cutmix-minmax", type=float, nargs="+", default=None)
parser.add_argument("--mixup-prob", type=float, default=1.0)
parser.add_argument("--mixup-switch-prob", type=float, default=0.5)
parser.add_argument("--mixup-mode", type=str, default="batch")
parser.add_argument("--mixup-off-epoch", default=0, type=int)
parser.add_argument("--aug-repeats", "--aug-repeat", type=int, default=0)
parser.add_argument("--aug-splits", type=int, default=0,
                    help="augmentation splits (0 or >=2): clean + N-1 "
                         "augmented copies per sample, for --jsd-loss")
parser.add_argument("--resplit", action="store_true", default=False,
                    help="skip random erasing on the clean aug-split")
parser.add_argument("--split-bn", action="store_true", default=False,
                    help="per-aug-split BN batch statistics (timm "
                         "convert_splitbn_model semantics; needs --aug-splits)")
parser.add_argument("--drop", type=float, default=0.0)
parser.add_argument("--drop-connect", type=float, default=None)
parser.add_argument("--drop-path", type=float, default=None)
parser.add_argument("--drop-block", type=float, default=None,
                    help="accepted no-op: swallowed by **kwargs in every reference model "
                         "factory too (e.g. MAP/models/map_resnet.py:445-449)")
# Multi-head losses (GA + MAP)
parser.add_argument("--GA_lam", "--ga-lam", dest="GA_lam", type=float, default=None,
                    help="GA decorrelation lambda (GA/train.py:735-745)")
parser.add_argument("--dec-lam", type=float, default=-0.8,
                    help="MAP cross-group decorrelation lambda (MAP/train.py:823-837)")
parser.add_argument("--distill-tokens", type=int, default=0)
parser.add_argument("--token-distillation", type=int, default=1)
# EMA
parser.add_argument("--model-ema", action="store_true", default=False)
parser.add_argument("--model-ema-decay", type=float, default=0.9999)
parser.add_argument("--model-ema-force-cpu", action="store_true", default=False,
                    help="accepted no-op: the EMA shadow lives on the device")
# Misc
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--worker-seeding", type=str, default="all",
                    help="accepted no-op: host pipeline derives one RNG per sample "
                         "from (seed, epoch, index) regardless")
parser.add_argument("--log-interval", type=int, default=50)
parser.add_argument("--recovery-interval", type=int, default=0)
parser.add_argument("--checkpoint-hist", type=int, default=10)
parser.add_argument("-j", "--workers", type=int, default=4)
parser.add_argument("--grad-accumulation", type=int, default=None,
                    help="explicit grad accumulation (GA-style flag); derived from -tb if unset")
parser.add_argument("--amp", action="store_true", default=False,
                    help="bf16 compute (fp32 parameters); fp32 compute without it")
parser.add_argument("--channels-last", action="store_true", default=False,
                    help="accepted no-op: the port's models take NHWC")
parser.add_argument("--pin-mem", action="store_true", default=False,
                    help="accepted no-op: batches always reach the card through pinned memory")
parser.add_argument("--no-prefetcher", action="store_true", default=False,
                    help="accepted no-op: the loader always overlaps host decode with "
                         "device compute")
parser.add_argument("--output", default="", type=str)
parser.add_argument("--experiment", default="", type=str)
parser.add_argument("--project-name", default="imagenet_models_tpu", type=str)
parser.add_argument("--eval-metric", default="top1", type=str)
parser.add_argument("--log-wandb", action="store_true", default=False)
parser.add_argument("--save-images", action="store_true", default=False)
parser.add_argument("--sync-bn", action="store_true", default=False,
                    help="accepted no-op: BN statistics are synchronised under --zero1 and "
                         "their running averages all-reduced every step otherwise")
parser.add_argument("--dist-bn", type=str, default="reduce",
                    help="accepted no-op: BN running statistics are all-reduced every step "
                         "(strictly stronger than per-epoch reduce/broadcast)")
parser.add_argument("--zero1", action="store_true", default=False,
                    help="shard optimizer + EMA state over the data-parallel ranks, each leaf "
                         "owned by one rank (ZeRO-1), with synchronised BN statistics")
parser.add_argument("--early-stop", type=int, default=None)
parser.add_argument("--eval-epoch", type=int, default=1)
parser.add_argument("--dis_eval", "--dis-eval", action="store_true", default=False)
parser.add_argument("--torchcompile", nargs="?", type=str, default=None, const="inductor",
                    help="accepted no-op: the port's kernels are written by hand")
# torch-runtime flags accepted for CLI parity; each is either native here
# (bf16 AMP, NHWC, persistent workers) or another runtime's
parser.add_argument("--apex-amp", action="store_true", default=False,
                    help="reference AMP impl selector; enables --amp (bf16) here")
parser.add_argument("--native-amp", action="store_true", default=False,
                    help="reference AMP impl selector; enables --amp (bf16) here")
parser.add_argument("--torchscript", action="store_true", default=False,
                    help="accepted no-op: the model runs eagerly")
parser.add_argument("--fuser", default="", type=str,
                    help="accepted no-op: the port's kernels are written by hand")
parser.add_argument("--no-ddp-bb", action="store_true", default=False,
                    help="accepted no-op: BN buffers are all-reduced by the step, not broadcast")
parser.add_argument("--use-multi-epochs-loader", action="store_true", default=False,
                    help="accepted no-op: loader workers persist across epochs")
parser.add_argument("--local_rank", "--local-rank", default=None, type=int,
                    help="this process's GPU on its host (torch.distributed.launch); the "
                         "LOCAL_RANK variable wins; given alone it means --dist-coordinator auto")
parser.add_argument("--tta", type=int, default=0,
                    help="average eval logits over groups of N consecutive samples "
                         "(MAP/train.py:1009-1012 output.unfold semantics)")
# flags the reference parses but never consumes (MAP/train.py:246-329);
# accepted and warned-on so reference command lines keep working
parser.add_argument("--mesa", type=float, default=0.0)
parser.add_argument("--mesa-start-ratio", type=float, default=0.25,
                    help="parsed with --mesa; warns unsupported when mesa>0")
parser.add_argument("--prog-input", type=float, nargs="+", default=None)
parser.add_argument("--prog-input-milestones", type=float, nargs="+", default=None)
parser.add_argument("--head-dropout", type=float, default=None)
parser.add_argument("--n-devices", type=int, default=None,
                    help="devices in the run: absent or the number of processes (one GPU each)")
# multi-process data parallelism (the JAX CLI's multi-host flags, the
# torchrun/init_process_group analog, GA/train.py:374-381)
parser.add_argument("--dist-coordinator", type=str, default="",
                    help="rendezvous address host:port, or 'auto' for torchrun's environment "
                         "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
parser.add_argument("--dist-num-processes", type=int, default=None,
                    help="total process count for --dist-coordinator")
parser.add_argument("--dist-process-id", type=int, default=None,
                    help="this process's rank for --dist-coordinator")
parser.add_argument("--max-steps-per-epoch", type=int, default=None,
                    help="truncate epochs (smoke runs)")
parser.add_argument("--profile-steps", type=int, default=0,
                    help="write a torch.profiler trace of N steps in epoch 0")


def _parse_args(args_list=None):
    args_config, remaining = config_parser.parse_known_args(args_list)
    if args_config.config:
        import yaml

        with open(args_config.config) as f:
            cfg = yaml.safe_load(f)
        parser.set_defaults(**cfg)
    args = parser.parse_args(remaining)
    # args.yaml as JSON values, which are YAML too: no PyYAML needed to write it
    args_text = "".join(f"{k}: {json.dumps(v)}\n" for k, v in sorted(vars(args).items()))
    return args, args_text


def run(args, args_text: str) -> dict:
    """The training run (the JAX CLI's `run`). Returns what it did: the output
    directory, the epochs run with their train and eval metrics and loop
    timings, the host decoder, and how it ended ("done", "nan", "preempted",
    "early_stop", "interrupted")."""
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.ckpt.pretrained import load_pretrained
    from imagenet_models_tpu_torch.ckpt.saver import CheckpointSaver, resume_checkpoint
    from imagenet_models_tpu_torch.core.reinit import reference_init
    from imagenet_models_tpu_torch.data.dataset import check_dataset_name
    from imagenet_models_tpu_torch.data.mixup import Mixup
    from imagenet_models_tpu_torch.nn.layers import grouped_weights, set_bn_splits
    from imagenet_models_tpu_torch.parallel import mesh
    from imagenet_models_tpu_torch.train.engine import (
        NaNWatchdog, Preempted, install_preemption_handler, train_one_epoch, validate)
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer, set_schedule_count
    from imagenet_models_tpu_torch.train.scheduler import create_scheduler, lr_noise_table
    from imagenet_models_tpu_torch.train.state import (
        create_train_state, make_eval_step, make_train_step)
    from imagenet_models_tpu_torch.utils.meters import init_wandb, update_summary

    coordinator = args.dist_coordinator or ("auto" if args.local_rank is not None else "")
    device = mesh.init_distributed(coordinator, args.dist_num_processes, args.dist_process_id,
                                   device=entry_device(), local_rank=args.local_rank)
    n_proc, proc_id, group = mesh.world(), mesh.rank(), mesh.data_group()
    if args.n_devices is not None and args.n_devices != n_proc:
        raise ValueError(f"--n-devices {args.n_devices}: a process drives one GPU and this run "
                         f"has {n_proc} process(es); N processes come from torchrun or "
                         "--dist-coordinator/--dist-num-processes/--dist-process-id")
    if not mesh.is_primary():
        logging.getLogger().setLevel(logging.WARNING)  # progress is logged by rank 0
    if n_proc > 1:
        torch.manual_seed(mesh.rank_seed(args.seed, proc_id))  # each rank its own dropout
    install_preemption_handler()
    _logger.info("Training on %s (%s), process %d of %d", device,
                 torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU",
                 proc_id, n_proc)

    cfg = default_cfg(args.model)
    num_classes = args.num_classes or cfg["num_classes"]
    input_size = (args.input_size[1] if args.input_size else (args.img_size or cfg["input_size"][0]))
    test_size = args.test_input_size[1] if args.test_input_size else input_size
    crop_pct = args.crop_pct or cfg["crop_pct"]
    interpolation = args.interpolation or cfg["interpolation"]
    mean = tuple(args.mean) if args.mean else cfg["mean"]
    std = tuple(args.std) if args.std else cfg["std"]

    # aug-splits / JSD (GA/train.py:433-441,554,560-561,613-615 via timm):
    # a clean + N-1 augmented copies of one primary crop per sample
    num_aug_splits = 0
    if args.aug_splits > 0:
        if args.aug_splits <= 1:
            raise ValueError("A split of 1 makes no sense")  # GA/train.py:435
        num_aug_splits = args.aug_splits
    if args.jsd_loss and num_aug_splits <= 1:
        raise ValueError("--jsd-loss is only valid with --aug-splits >= 2 "
                         "(GA/train.py:614)")
    if args.resplit and not num_aug_splits:
        raise NotImplementedError(
            "--resplit without --aug-splits (timm's erase-second-half-batch "
            "mode) is not supported; none of the reference recipes use it")
    if args.split_bn:
        # timm convert_splitbn_model (GA/train.py:439-441): per-split BN
        # statistics, the clean split feeding the running statistics
        if num_aug_splits <= 1:
            raise ValueError("--split-bn requires --aug-splits >= 2 (GA/train.py:439)")
        if args.sync_bn:
            raise ValueError("--split-bn and --sync-bn are mutually exclusive "
                             "(GA/train.py:449 'assert not args.split_bn')")
    if args.apex_amp or args.native_amp:
        args.amp = True  # the reference's AMP selectors; the one AMP here is bf16
    if args.gp is not None:
        raise NotImplementedError(
            f"--gp {args.gp}: pooling is fixed by the model factory here "
            "(mmcap for map_*/ga_* models, avg otherwise)")
    if args.bn_eps is not None or args.bn_momentum is not None:
        raise NotImplementedError(
            "--bn-eps/--bn-momentum overrides are not supported; BN eps "
            "values are fixed per-model for checkpoint parity")
    if args.mesa or args.prog_input or args.prog_input_milestones or \
            args.head_dropout is not None:
        _logger.warning("--mesa/--prog-input*/--head-dropout are parsed but "
                        "never consumed by the reference engine "
                        "(MAP/train.py:246-329); ignoring them here too")
    drop_path = args.drop_path
    if args.drop_connect is not None:
        _logger.warning("--drop-connect is deprecated; using it as drop-path rate")
        if drop_path is None:
            drop_path = args.drop_connect

    dtype = torch.bfloat16 if args.amp else None
    model_kwargs = {"distill_tokens": args.distill_tokens} if args.distill_tokens else {}
    model = create_model(args.model, device=device, num_classes=num_classes,
                         drop_rate=args.drop, drop_path_rate=drop_path, dtype=dtype,
                         generator=torch.Generator().manual_seed(args.seed), **model_kwargs)
    # the reference's init of the kaiming/torch-default families (no-op for
    # ConvNeXt and MaxViT): matters for from-scratch training only
    reference_init(args.model, model, seed=args.seed)
    if args.split_bn:
        set_bn_splits(model, num_aug_splits)
    if args.pretrained:
        load_pretrained(model, args.model)
        _logger.info("loaded pretrained weights for %s", args.model)
    if args.initial_checkpoint:
        resume_checkpoint(args.initial_checkpoint, model)
        _logger.info("loaded initial checkpoint %s", args.initial_checkpoint)
    if args.finetuning_checkpoint:
        from imagenet_models_tpu_torch.ckpt.finetune import apply_finetune_checkpoint

        _, n_fc = apply_finetune_checkpoint(model, args.finetuning_checkpoint,
                                            in21k_to_in1k=args.in21k_to_in1k,
                                            map_path=args.in21k_1k_map)
        _logger.info("fine-tuning from %s (%d fc keys %s)", args.finetuning_checkpoint,
                     n_fc, "remapped" if args.in21k_to_in1k else "dropped")
    n_params = sum(p.numel() for p in model.parameters())
    _logger.info("Model %s created, param count: %d, %s compute", args.model, n_params,
                 "bf16" if args.amp else "fp32")

    # batch geometry (MAP/train.py:406 semantics; a device per process)
    per_dev = args.batch_size
    if args.grad_accumulation:
        grad_accum = args.grad_accumulation
    elif args.total_batch_size:
        grad_accum = max(1, args.total_batch_size // (per_dev * n_proc))
    else:
        grad_accum = 1
    global_batch = per_dev * n_proc * grad_accum
    _logger.info("global batch %d = %d/dev x %d dev x %d accum", global_batch, per_dev, n_proc,
                 grad_accum)

    check_dataset_name(args.dataset)
    dataset_train = create_dataset(args.data_dir, args.train_split,
                                   num_classes=num_classes, image_size=input_size,
                                   class_map=args.class_map or None)
    dataset_eval = create_dataset(args.data_dir, args.val_split,
                                  num_classes=num_classes, image_size=test_size,
                                  class_map=args.class_map or None)
    mixup_active = (args.mixup > 0 or args.cutmix > 0
                    or args.cutmix_minmax is not None)  # GA/train.py:547
    if mixup_active and num_aug_splits:
        raise ValueError("--aug-splits is not compatible with mixup/cutmix; "
                         "set --mixup 0 --cutmix 0")
    mixup_fn = None
    if mixup_active:
        mixup_fn = Mixup(mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
                         cutmix_minmax=args.cutmix_minmax,
                         prob=args.mixup_prob, switch_prob=args.mixup_switch_prob,
                         label_smoothing=args.smoothing, num_classes=num_classes,
                         mode=args.mixup_mode)
    loader_train = create_loader(
        dataset_train, input_size, global_batch, is_training=True,
        # no-aug forces the eval interpolation (GA/train.py:565)
        interpolation=interpolation if args.no_aug
        else (args.train_interpolation or interpolation),
        mean=mean, std=std, auto_augment=args.aa, hflip=args.hflip,
        vflip=args.vflip, color_jitter=args.color_jitter,
        reprob=args.reprob, remode=args.remode, recount=args.recount,
        scale=tuple(args.scale), ratio=tuple(args.ratio), mixup_fn=mixup_fn,
        num_workers=args.workers, seed=args.seed, repeats=args.aug_repeats,
        aug_splits=num_aug_splits, resplit=args.resplit, no_aug=args.no_aug,
        num_shards=n_proc, shard_id=proc_id)
    eval_batch = args.validation_batch_size or per_dev * n_proc
    quantum = n_proc * max(int(args.tta), 1)  # tta groups must tile each process's shard
    eval_batch = max(quantum, eval_batch // quantum * quantum)
    loader_eval = create_loader(dataset_eval, test_size, eval_batch,
                                is_training=False, interpolation=interpolation,
                                crop_pct=crop_pct, crop_mode=cfg.get("crop_mode", "center"),
                                mean=mean, std=std, num_workers=args.workers, seed=args.seed,
                                num_shards=n_proc, shard_id=proc_id)
    decoder = getattr(loader_train, "decoder", "PIL")
    _logger.info("host decoder: %s, %d loader workers", decoder, args.workers)

    # optimizer + schedule
    steps_per_epoch = len(loader_train)
    noise_range = [n * args.epochs for n in args.lr_noise] if args.lr_noise else None
    noise_table = lr_noise_table(args.epochs + args.cooldown_epochs + 1, noise_range,
                                 noise_pct=args.lr_noise_pct,
                                 noise_std=args.lr_noise_std, seed=args.seed)
    lr_fn = create_scheduler(args.sched, base_lr=args.lr, epochs=args.epochs,
                             warmup_epochs=args.warmup_epochs, warmup_lr=args.warmup_lr,
                             min_lr=args.min_lr, decay_epochs=args.decay_epochs,
                             decay_rate=args.decay_rate, cycle_mul=args.lr_cycle_mul,
                             cycle_decay=args.lr_cycle_decay,
                             cycle_limit=args.lr_cycle_limit,
                             k_decay=args.lr_k_decay, noise_table=noise_table)
    betas = tuple(args.opt_betas) if args.opt_betas else (0.9, 0.999)
    opt = create_optimizer(args.opt, learning_rate=lambda s: lr_fn(s // max(steps_per_epoch, 1)),
                           weight_decay=args.weight_decay, eps=args.opt_eps, betas=betas,
                           momentum=args.momentum, clip_grad=args.clip_grad,
                           clip_mode=args.clip_mode)

    ema_decay = args.model_ema_decay if args.model_ema else 0.0
    state = create_train_state(model, opt, ema_decay=ema_decay, device=device, group=group,
                               zero1=args.zero1)
    # the step's generator draws the stochastic-depth masks (JAX's step rng,
    # folded with the rank)
    generator = torch.Generator(device=device).manual_seed(mesh.rank_seed(args.seed, proc_id))
    start_epoch = 0
    if args.resume:
        state, last_epoch = resume_checkpoint(args.resume, state, generator=generator)
        start_epoch = last_epoch + 1
        if args.no_resume_opt:
            # optimizer state not restored (MAP/train.py:552-553); weights,
            # EMA and epoch are, and the LR schedule goes on from the epoch
            state.opt_state = opt.init(state.owned(state.params()),
                                       grouped=grouped_weights(model))
            _logger.info("resumed weights only (--no-resume-opt)")
        # timm steps the LR by epoch, apart from the optimizer: the schedule
        # count follows the resume epoch; the bias-correction count does not
        set_schedule_count(state.opt_state, start_epoch * steps_per_epoch)
        _logger.info("resumed from %s at epoch %d", args.resume, start_epoch)
    if args.start_epoch is not None:
        # manual epoch override (GA/train.py:169-170); the LR follows it
        start_epoch = args.start_epoch
        set_schedule_count(state.opt_state, start_epoch * steps_per_epoch)

    base_loss = create_loss_fn(bce_loss=args.bce_loss, smoothing=args.smoothing,
                               bce_target_thresh=args.bce_target_thresh,
                               mixup_active=mixup_active,
                               jsd_splits=num_aug_splits if args.jsd_loss else 0)
    dec_lam = args.GA_lam if args.GA_lam is not None else args.dec_lam
    step_fn = make_train_step(model, opt, base_loss, dec_lam=dec_lam, ema_decay=ema_decay,
                              grad_accum=grad_accum,
                              token_distillation=bool(args.token_distillation),
                              group=group, zero1=args.zero1)
    eval_step = make_eval_step(model, tta=args.tta)
    eval_step_ema = (make_eval_step(model, tta=args.tta, use_ema=True, state=state)
                     if ema_decay else None)

    run_name = args.experiment or "-".join([
        datetime.now().strftime("%Y%m%d-%H%M%S"), args.model, str(input_size)])
    if n_proc > 1:
        # one run directory: rank 0's name (the clocks may straddle a second)
        run_name = mesh.broadcast_object(run_name)
    output_dir = os.path.join(args.output or "./output/train", run_name)
    saver = CheckpointSaver(output_dir, max_history=args.checkpoint_hist,
                            decreasing=args.eval_metric == "loss", args_text=args_text,
                            # one process: the writes overlap the next steps;
                            # across processes saves are collective
                            async_save=n_proc == 1, generator=generator)
    _logger.info("output dir: %s", output_dir)

    log_wandb = False
    if args.log_wandb and mesh.is_primary():
        log_wandb = init_wandb(f"{args.project_name}_{os.path.basename(args.data_dir).lower()}",
                               run_name, vars(args), resume_id=args.resume_id)

    # timm: the run is the cosine cycle plus the cooldown epochs, which hold
    # min_lr (timm train.py num_epochs = get_cycle_length() + cooldown_epochs)
    num_epochs = args.epochs + (args.cooldown_epochs if args.sched == "cosine" else 0)
    result = {"output_dir": output_dir, "device": str(device), "world": n_proc,
              "decoder": decoder,
              "param_count": n_params, "start_epoch": start_epoch, "epochs": [],
              "best_metric": None, "best_epoch": None, "exit": "done"}
    wrote_header = False
    try:
        for epoch in range(start_epoch, num_epochs):
            loader_train.set_epoch(epoch)
            mixup_off = bool(args.mixup_off_epoch and epoch >= args.mixup_off_epoch)
            state, train_metrics, train_stats = train_one_epoch(
                epoch, state, step_fn, Truncate(loader_train, args.max_steps_per_epoch),
                generator, device, log_interval=args.log_interval, saver=saver,
                recovery_interval=args.recovery_interval, lr_fn=lr_fn,
                mixup_off=mixup_off, steps_per_epoch=steps_per_epoch,
                profile_steps=args.profile_steps if mesh.is_primary() else 0,
                profile_dir=os.path.join(output_dir, "profile"),
                save_images_dir=output_dir if args.save_images and mesh.is_primary() else "")
            record = {"epoch": epoch, "train": dict(train_metrics), "train_stats": train_stats}

            do_eval = not args.dis_eval and (epoch + 1) >= args.eval_epoch
            # a stable column set from row 0: with EMA on, eval rows carry
            # raw_* extras, and summary.csv's header is written once
            eval_metrics = {"top1": 0.0, "top5": 0.0}
            if eval_step_ema is not None:
                eval_metrics.update({"raw_top1": 0.0, "raw_top5": 0.0})
            if do_eval:
                loader_eval_t = Truncate(loader_eval, args.max_steps_per_epoch)
                eval_metrics, record["eval_stats"] = validate(
                    eval_step, loader_eval_t, device, log_interval=args.log_interval,
                    tta=args.tta)
                if eval_step_ema is not None:
                    ema_metrics, record["eval_ema_stats"] = validate(
                        eval_step_ema, loader_eval_t, device, log_interval=args.log_interval,
                        log_suffix=" (EMA)", tta=args.tta)
                    # the EMA metrics are THE eval metrics (GA/train.py:670-679);
                    # the raw model's stay as extra columns
                    eval_metrics = {**ema_metrics,
                                    "raw_top1": eval_metrics["top1"],
                                    "raw_top5": eval_metrics["top5"]}
            record["eval"] = dict(eval_metrics)
            result["epochs"].append(record)
            if mesh.is_primary():  # MAP/train.py:724-738
                update_summary(epoch, train_metrics, eval_metrics,
                               os.path.join(output_dir, "summary.csv"),
                               write_header=not wrote_header,
                               lr=float(lr_fn(epoch)), log_wandb=log_wandb)
                wrote_header = True
            if do_eval:
                result["best_metric"], result["best_epoch"] = saver.save_checkpoint(
                    state, epoch, metric=eval_metrics[args.eval_metric])
            else:
                saver.save_checkpoint(state, epoch)
            if args.early_stop is not None and epoch == args.early_stop - 1 \
                    and eval_metrics["top1"] < 72.8:
                _logger.info("early stop: top1 %.2f < 72.8 at epoch %d",
                             eval_metrics["top1"], epoch)
                result["exit"] = "early_stop"
                return result
    except NaNWatchdog as e:
        _logger.error("NaN watchdog fired (%s); exiting for restart via --resume", e)
        result["exit"] = "nan"
        return result
    except Preempted as e:
        _logger.warning("preempted (%s); recovery checkpoint saved: restart "
                        "with --resume %s", e, os.path.join(output_dir, "recovery"))
        result["exit"] = "preempted"
        return result
    except KeyboardInterrupt:
        result["exit"] = "interrupted"
    finally:
        # land every queued write before the run reports how it ended
        saver.close()
    if result["best_metric"] is not None:
        _logger.info("*** Best metric: %s (epoch %s)", result["best_metric"], result["best_epoch"])
    return result


def main(argv=None) -> dict:
    from imagenet_models_tpu_torch.parallel import mesh
    from imagenet_models_tpu_torch.utils.meters import setup_default_logging

    setup_default_logging()
    args, args_text = _parse_args(argv)
    try:
        return run(args, args_text)
    finally:
        mesh.destroy()  # the process group ends with the run


if __name__ == "__main__":
    main()
