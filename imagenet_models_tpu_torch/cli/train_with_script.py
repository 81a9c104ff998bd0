#!/usr/bin/env python3
"""Recipe runner of the PyTorch port: the preset hyper-parameter line of each
backbone, run for each named model. Port of the JAX package's root
`train_with_script.py` (the reference's true MAP entry point):

    python -m imagenet_models_tpu_torch.cli.train_with_script convnext_tiny \
        -m map_convnext_tiny --data-dir /data/imagenet

Each setup's recipe string is parsed by `cli.train._parse_args`; the runner's
flags (model, resume, checkpoints, seed, dataset, epochs, batch, the
`--dist-*` rendezvous and the MAP hyper-parameters) are set on the parsed
namespace, and `cli.train.run` trains each setup x model pair in turn.
"""

import argparse
import gc
import logging
import os

from imagenet_models_tpu_torch.cli.train import _parse_args, run

# Recipe strings preserved from the reference (train_with_script.py:12-20),
# minus --log-wandb (wandb is optional here); copied word for word from the JAX
# package's root train_with_script.py:17-25. Flags map 1:1 onto cli/train.py.
setting_dict = dict(
    resnet50="imageNet --input-size 3 224 224 --test-input-size 3 224 224 --aa rand-m20-mstd0.5-inc1 --mixup .1 --cutmix 1.0 --remode pixel --reprob 0.25 --crop-pct 0.95 --drop-path 0.1 --drop 0.1 --smoothing 0.1 --bce-loss --opt lamb --weight-decay .02 --sched cosine --epochs 300 --lr 5e-3 --warmup-lr 1e-6 -b 128 -j 8 --channels-last --amp -tb 1024 --pin-mem --aug-repeats 3",
    pit_s="imageNet --aa rand-m9-mstd0.5-inc1 --mixup .8 --cutmix 1.0 --aug-repeats 3 --remode pixel --reprob 0.25 --drop-path .1 --opt adamw --weight-decay .05 --sched cosine --epochs 300 --lr 1e-3 --warmup-lr 1e-6 -b 256 -tb 1024 -j 16 --amp --channels-last --pin-mem",
    convnext_tiny="imageNet --drop-path .1 -b 128 -tb 1024 --smoothing 0.1 --bce-loss --opt lamb --opt-eps 1e-8 --momentum 0.8 --weight-decay 0.05 --sched cosine --epochs 300 --lr 5e-3 --warmup-lr 1e-6 --crop-pct 0.875 --aa rand-m9-mstd0.5-inc1 --mixup .8 --cutmix 1.0 --remode pixel --reprob 0.25 --sched cosine -j 8 --amp --channels-last --model-ema --model-ema-decay 0.9999 --aug-repeats 3",
    convnext_small="imageNet --drop-path .4 -b 128 -tb 1024 --smoothing 0.1 --bce-loss --opt lamb --opt-eps 1e-8 --momentum 0.8 --weight-decay 0.05 --sched cosine --epochs 300 --lr 5e-3 --warmup-lr 1e-6 --crop-pct 0.875 --aa rand-m9-mstd0.5-inc1 --mixup .8 --cutmix 1.0 --remode pixel --reprob 0.25 --sched cosine -j 8 --amp --channels-last --model-ema --model-ema-decay 0.9999 --aug-repeats 3",
    faster_vit_3="imageNet --drop-path .3 -b 128 -tb 4096 --aug-repeat 3 --opt lamb --opt-eps 1e-8 --momentum 0.9 --weight-decay 0.05 --sched cosine --warmup-epochs 35 --epochs 300 --lr 5e-3 --warmup-lr 1e-6 --min-lr 5e-6 --crop-pct 0.95 --aa rand-m15-mstd0.5-inc1 --mixup .8 --cutmix 1.0 --remode pixel --reprob 0.25 --smoothing 0.1 --sched cosine -j 8 --amp --channels-last --clip-grad 5.0",
    maxvit_tiny="imageNet --aug-repeat 3 --aa rand-m15-mstd0.5-inc1 --mixup .8 --cutmix 1.0 --remode pixel --reprob 0.25 --drop-path .2 --opt lamb --bce-loss --weight-decay .05 --sched cosine --epochs 300 --lr 8e-3 --warmup-lr 1e-6 --warmup-epoch 30 --min-lr 1e-5 -b 64 -tb 4096 --smoothing 0.1 --clip-grad 1.0 -j 8 --amp --pin-mem --channels-last --project-name mmcap",
    mobilenet_v1="imageNet --input-size 3 160 160 --test-input-size 3 224 224 --aa rand-m7-mstd0.5-inc1 --mixup .1 --cutmix 1.0 --aug-repeats 0 --remode pixel --reprob 0.0 --crop-pct 0.95 --drop-path 0.05 --smoothing 0.0 --bce-loss --opt lamb --weight-decay .02 --sched cosine --epochs 100 --lr 5e-3 --warmup-lr 1e-6 -b 512 -j 16 --channels-last --amp -tb 1024 --pin-mem",
)


def get_multi_args_parser():
    p = argparse.ArgumentParser(description="multi-run recipe launcher")
    p.add_argument("setup", type=str, nargs="+", choices=setting_dict.keys())
    p.add_argument("-m", "--model-name", type=str, nargs="+", default=["map_resnet50"])
    p.add_argument("-r", "--resume", type=str, default=None)
    p.add_argument("-ri", "--resume_id", type=str, default=None)
    p.add_argument("-c", "--cuda", type=str, default="0,",
                   help="accepted no-op: GPU id list in the reference "
                        "(CUDA_VISIBLE_DEVICES); each process takes its own GPU here")
    p.add_argument("-cp", "--initial-checkpoint", type=str, default=None)
    p.add_argument("-fp", "--finetuning-checkpoint", type=str, default=None)
    p.add_argument("-pt", "--in21k-to-in1k", action="store_true")
    p.add_argument("-s", "--seed", type=int, default=42)
    p.add_argument("-e", "--eval-epoch", type=int, default=1)
    p.add_argument("-es", "--early-stop", type=int, default=None)
    p.add_argument("--data-dir", type=str, default=None,
                   help="override the recipe's dataset path (or 'synthetic')")
    p.add_argument("--epochs", type=int, default=None, help="override recipe epochs")
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--zero1", action="store_true", default=False,
                   help="shard the optimizer state and the EMA shadow over the ranks "
                        "(see cli/train.py)")
    p.add_argument("-b", "--batch-size", type=int, default=None, help="override recipe batch")
    p.add_argument("-tb", "--total-batch-size", type=int, default=None)
    # mmcap hyper-parameters (fixed; reference train_with_script.py:38-42)
    p.add_argument("--dist-coordinator", type=str, default="",
                   help="multi-process: rendezvous host:port or 'auto' (torchrun's "
                        "variables), forwarded to cli/train.py")
    p.add_argument("--dist-num-processes", type=int, default=0)
    p.add_argument("--dist-process-id", type=int, default=0)
    p.add_argument("--dec-lam", default=-0.8, type=float)
    p.add_argument("--distill-tokens", default=0, type=int)
    p.add_argument("--token-distillation", default=1, type=int)
    return p


def main():
    multi_args = get_multi_args_parser().parse_args()
    for setup in multi_args.setup:
        args, args_text = _parse_args(setting_dict[setup].split())
        for model in multi_args.model_name:
            args.model = model
            args.resume = multi_args.resume or ""
            args.resume_id = multi_args.resume_id
            args.initial_checkpoint = multi_args.initial_checkpoint or ""
            args.finetuning_checkpoint = multi_args.finetuning_checkpoint or ""
            args.in21k_to_in1k = multi_args.in21k_to_in1k
            args.seed = multi_args.seed
            args.eval_epoch = multi_args.eval_epoch
            args.early_stop = multi_args.early_stop
            args.dec_lam = multi_args.dec_lam
            args.distill_tokens = multi_args.distill_tokens
            args.token_distillation = multi_args.token_distillation
            if multi_args.data_dir:
                args.data_dir = multi_args.data_dir
            elif not os.path.isdir(args.data_dir):
                args.data_dir = os.environ.get("IMAGENET_DIR", args.data_dir)
            if multi_args.epochs:
                args.epochs = multi_args.epochs
            if multi_args.batch_size:
                args.batch_size = multi_args.batch_size
            if multi_args.total_batch_size:
                args.total_batch_size = multi_args.total_batch_size
            args.max_steps_per_epoch = multi_args.max_steps_per_epoch
            if multi_args.zero1:
                args.zero1 = True
            if multi_args.dist_coordinator:
                args.dist_coordinator = multi_args.dist_coordinator
                args.dist_num_processes = multi_args.dist_num_processes
                args.dist_process_id = multi_args.dist_process_id
            run(args, args_text)
            gc.collect()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
