#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width on the card, through the entry
points a user calls, with random weights from a fixed seed: map_convnext_tiny
serving (`create_model`, `serving.make_serving_fn`, `train.state.
make_eval_step`) and its train step (`train.state.create_train_state` /
`make_train_step` with bench.py's recipe: timm LAMB lr 5e-3 wd 0.05, BCE on
dense targets, dec_lam -0.8, EMA 0.9999); then map_maxvit_tiny_tf_224 serving
and its train step (the maxvit_tiny recipe: LAMB lr 8e-3 wd 0.05, clip 1.0 by
norm, BCE with smoothing 0.1, drop-path 0.2, dec_lam -0.8, no EMA); then
ga_cswin_tiny serving and its train step (the ConvNeXt recipe); then
map_resnet50 and map_mobilenet_v1 serving and train steps with the BatchNorm
switch on; then ga_convnext_tiny serving and its train step (the README's
recipe) with the dw weight-gradient switch on; then map_maxvit_tiny_tf_224
and ga_cswin_tiny again on the JAX package's opt-in routes, the flash
attention switch (kernels 12 and 13) and the transformer LN+MLP switch
(kernels 1 and 2 on their MLPs); then map_convnext_tiny again with its
blocks on the JAX package's fused-branch entry `convnext_branch_apply`
(kernels 10 and 11); then the train and validate entries and data
parallelism; then map_pit_s on kernels 1 and 2 (the transformer LN+MLP
switch) with the heads that came with it, and map_faster_vit_3_224 on
kernels 7 and 8 (the BatchNorm switch); then maxvit_tiny_tf_384 fine-tuned
from a 224 px checkpoint, with and without gradient checkpointing, and the
partition- and stripe-attention switches. Phases:

1. device: the card's name and power limit;
2. build: compile every CUDA kernel from `csrc/`, one nvcc per source, all
   started together;
3. kernels 1 and 2: each against its plain-PyTorch twin with both GELUs,
   bit-equal between two runs, at the four stage shapes of B=64, a ragged
   N=152 and BWD_EDGE_SHAPES (C = 64, 688, 1024; N = 1, 17, ragged tiles;
   hidden other than 4C), kernel 1 also at the stage shapes of B=256 (the
   eval batch) and B=128 (the train batch), kernel 2 at those of B=128, every
   output; times in turns (twin, kernel, kernel, twin) from CUDA events,
   kernel 1 at B=64 and B=256 with the exact GELU and at B=64 and B=128
   with the fast one, kernel 2 at B=128, each also stage by stage and
   beside its products as torch.matmul calls; kernel 1's registers and
   SASS counts (HGMMA in its GEMM stages); then at map_pit_s's widths (C =
   144, 288, 576, hidden 4C) and stage token counts at B=128 and B=256,
   kernels 1 and 2 with both GELUs against their twins by the same gates,
   kernel 1 timed at B=256 (exact) and B=128 (fast), kernel 2 at B=128,
   beside the bound and the products as torch.matmul calls
   (`check_pit_widths`);
4. ConvNeXt serving: four uint8 requests of 32 images through the kernel
   path, with launch counts per request, logits checked against the plain
   path, and one eval step;
5. ConvNeXt throughput: eval img/s at B=256, kernel path and plain path in
   turns;
6. ConvNeXt train: six steps at B=128, 224 px, on the kernel path (18
   forward and 18 backward launches each, finite loss and grad norm, the EMA
   shadow moves), and one step from a deep copy of the first state on the
   plain path, whose loss, grad norm and gradients (by stage and block
   parameter) must agree with the kernel path's first step, both paths'
   gradients held against those of an fp32 model with the same weights;
7. ConvNeXt train throughput (kernel and plain path in turns) and a
   torch.profiler profile of one train step;
8. kernels 3 and 4 (partition attention): against their twins at the three
   B=128 stage shapes of the MaxViT train step, block and grid, every output
   (out; dqkv, dbias), at T = 144 and 256, on non-square maps and an odd
   batch; each output of the bf16 instances (kernel 4's summed on the tensor
   cores) also against the float64 function of its inputs, its error at most 1.25
   times the twin's, every output bit-equal between two runs; the fp32
   instances' output bits against their
   CUDA-core build's (a digest, K34_FP32_DIGEST); the code report of both
   libraries, with HMMA asserted in kernel 4's 16 bf16 (tensor-core)
   instances; times per launch in turns at B=128 beside the
   bound, the plain twin, and F.scaled_dot_product_attention on windows
   partitioned beforehand (the partition copies timed apart), with the
   device time by the profiler; kernel 3 beside the eval composition at the
   B=256 stage shapes;
9. MaxViT serving: four requests (eval takes the composition: no kernel
   launch), logits against the plain path and an fp32 model, one eval step,
   eval img/s at B=256;
10. MaxViT train: three steps at B=128 on the kernel path (18 launches of each
   kernel per step, finite metrics, the loss falls on a fixed batch), one
   plain-path step from a deep copy of the first state with the same
   drop-path and dropout draws, checked as in phase 6; train img/s of both
   paths in turns, and a profile of one train step;
11. kernels 5 and 6 (CSWin stripe attention + LePE): against their twins at
   the five idx=0 stripe shapes of ga_cswin_tiny at B=128, ga_cswin_base's
   stage 3, a non-square map and an odd batch, every output (out; dq, dk, dv,
   dw9, dwb), each bf16 output (summed on the tensor cores) also against the
   float64 function of its inputs, its error at most 1.25 times the twin's,
   every output bit-equal between two runs, the ws = 1 taps exactly 0; the
   bf16 instances' registers and SASS counts (HMMA asserted); times per launch in
   turns at the three B=128 shapes the path runs (and each launch's device
   time by torch.profiler), their sums per forward and per train step,
   beside the bound, the twin,
   and two library calls (F.scaled_dot_product_attention on stripes
   partitioned beforehand plus the LePE as a cuDNN depthwise F.conv2d; the
   partition copies timed apart); kernel 5 (and 6) beside the composition at
   the stage-1 and stage-2 shapes, which the gate sends to the composition;
12. GA-CSWin serving (ga_cswin_tiny): four requests with 27 launches of
   kernel 5 each, logits against the plain path and an fp32 model, one eval
   step, eval img/s at B=256 of both paths in turns;
13. GA-CSWin train: the benchkit recipe (LAMB lr 5e-3 wd 0.05, BCE with
   smoothing 0.1 on dense targets, dec_lam -0.8, EMA 0.9999) at B=128: six
   kernel-path steps (27 + 27 launches each, finite metrics, a falling loss,
   the EMA moves), one plain-path step from a deep copy of the first state,
   checked as in phase 6 (the groups with a true gradient of zero, named in
   CSWIN_ZERO_GRAD, are checked to be ~0 rather than gated); train img/s of
   both paths in turns, and a profile of one train step with its peak memory;
14. kernels 7 and 8 (BatchNorm statistics): against their twins and float64
   sums at every BatchNorm shape that takes them in map_resnet50's B=128,
   224 px train step (a census of one training forward), in bf16 and fp32,
   at an odd row count, C = 40, mixed operand types and channel slices;
   kernel 8 bit-equal between runs; times per launch in turns at the path's
   bf16 shapes beside the bound, the twin, `torch.batch_norm_stats` and
   `torch.batch_norm_backward_reduce`, and their sums per train step;
15. map_resnet50 serving with IMTPU_PALLAS_BN at "full" (phases 15-17 set
   the switch through `ops.batch_norm._PALLAS_BN_MODE`): four requests (no
   launch of kernels 7 and 8: eval reads the running statistics), logits
   against the plain path and an fp32 model, one eval step, eval img/s;
16. map_resnet50 train, the resnet50 recipe (LAMB lr 5e-3 wd 0.02, BCE with
   smoothing 0.1, drop-path 0.1, head dropout 0.1, no EMA) at B=128: six
   kernel-path steps with the launches of kernels 7 and 8 per step, one
   plain-path step (use_kernel=False: no launch), checked as in phase 6 in
   fp32 and by the distance ratio to fp32 in bf16, and the bf16 training
   forward's distance from fp32 block by block (`bf16_drift`);
   train img/s of four arms in turns ("full" with the kernels, "full" with
   the twins, "bwd" with kernel 8, "0" the autograd BatchNorm), and a
   profile of one "full" step;
17. map_mobilenet_v1: serving as phase 15, one train step at its recipe's
   160 px and B=128, kernel path against plain path and fp32 gradients;
   then MaxViT's train img/s with the switch at "full" against "0", one
   pair of turns, on phase 10's trainer;
18. kernel 9 (the depthwise 7x7 weight gradient): against its twin and
   float64 sums at the five B=128 shapes of ga_convnext_tiny's train step
   (stages 0-3 and the gram layers), in bf16 and fp32, and at C = 688, a
   non-square map and an odd batch, bit-equal between two runs; times per
   launch in turns at the path's bf16 shapes beside the bound, the twin and
   cuDNN's depthwise weight gradient (`torch.nn.grad.conv2d_weight`, and
   the weight-only `aten.convolution_backward`), their sums per step and
   the kernel's over cuDNN's; the library's registers (ptxas) and SASS
   instruction counts (cuobjdump);
19. ga_convnext_tiny serving: four requests with 23 launches of kernel 1
   each (18 backbone blocks, 5 gram layers), logits against the plain path
   and an fp32 model, one eval step, eval img/s at B=256 of both paths;
20. ga_convnext_tiny train, the README recipe (LAMB lr 5e-3 wd 0.05, BCE
   with smoothing 0.1, drop-path 0.1, EMA 0.9999, dec_lam -0.8) at B=128
   with IMTPU_DW_WGRAD at "1" (phases 18-20 set it through
   `ops.dw_conv._DW_WGRAD`): six kernel-path steps with 23 launches each of
   kernels 1, 2 and 9, one plain-path step (no launch) checked as in phase
   6; train img/s of three arms in turns ("1" with kernel 9, "0" with
   cuDNN's weight gradient, the plain path), a profile of one step with its
   peak memory; then map_convnext_tiny's train img/s at "1" against "0",
   one pair of turns;
21. kernels 12 and 13 (fused window attention, forward): against their
   twins in bf16 and fp32 at the shapes the flash route gives them (kernel
   13 at the four stages of map_maxvit_tiny_tf_224's eval forward at B=256,
   with the rel-pos bias; kernel 12 at the six shapes of ga_cswin_tiny's
   LePEAttention calls at B=128), at N = 144 and 256, a ragged N=50, D=24,
   heads of 64 and 128 and kernel 12 with a per-window bias, bit-equal
   between two runs; both kernels' bf16 outputs (tensor cores, no longer
   bit-equal to their twins) also against the float64 function of their
   inputs, each error at most 1.25 times the twin's; kernel 12's fp32 bits
   against the CUDA-core build's (a digest); times per launch in turns at
   the path shapes beside the bound, the twin and
   F.scaled_dot_product_attention with the bias as its mask, their sums per
   forward and the kernels' over SDPA's; both kernels' registers and SASS
   counts, HMMA asserted in each bf16 instance;
22. map_maxvit_tiny_tf_224 with IMTPU_FLASH_ATTN at "1" (phases 22-23 set
   it through `ops.flash_attention._FLASH_ATTN`): serving with 22 launches
   of kernel 13 per request, logits against the plain path and an fp32
   model, one eval step, eval img/s at "1" and "0" in turns; three train steps
   of phase 10's recipe with 4 launches of kernel 13 per step (stage 3; the
   other stages keep kernels 3 and 4, 18 each), one plain-path step checked
   as in phase 10, train img/s at "1" and "0" in turns;
23. ga_cswin_tiny with the switch at "1": serving with one launch of kernel
   12 per LePEAttention call (61, counted from the model) and none of kernel
   5, logits against the plain path and an fp32 model, one eval step, eval
   img/s at "1" and "0"; three train steps of phase 13's recipe with 61
   launches of kernel 12 per step, one plain-path step checked as in phase
   13, train img/s at "1" and "0";
24. IMTPU_TLNMLP at "1" (`ops.convnext_block._TLNMLP`) on both models: two
   train steps each with kernels 1 and 2 launched once per eligible MLP (22
   and 31) forward and backward, an eval forward with one launch of kernel 1
   per MLP, the first step against the plain path by loss, grad norm and,
   by model, the distance ratio to an fp32 model's gradients or the paths'
   distance by group (TLNMLP_GRAD_GATES);
   train img/s at "1" and "0", one pair of turns, and a profile of one step
   at each with the device time of the elementwise kernels (the fast GELU's
   chains among them) and of kernels 1 and 2. Both switches go back to "0";
25. kernels 10 and 11 (the fused ConvNeXt branch, `ops/convnext_branch.py`:
   dw 7x7 -> LayerNorm -> MLP with the exact GELU -> layer scale, forward and
   backward): against their twins in bf16 and fp32 at the four B=128 stage
   shapes of map_convnext_tiny, ga_convnext_tiny's gram-layer shape, an odd
   batch, a non-square map and C = 688, every output, each bit-equal between
   two runs; their fp32 bits against the first design's build's (a digest,
   K1011_FP32_DIGEST); their code report (wgmma and TMA loads in the bf16
   GEMM stages, no mma instruction in a bf16 instance); times per launch in
   turns at the path's bf16 shapes beside the bound, the twin and the block
   route that does the same work today (cuDNN's depthwise conv and kernel 1;
   kernel 2 and cuDNN's depthwise data and weight gradients), each stage of
   their bf16 pipelines alone, and their sums per forward and per step; then
   map_convnext_tiny with the name its blocks call bound to
   `convnext_branch_apply` for the phase (`branch_route`; the block route is
   restored afterwards): serving with 18 launches of kernel 10 per request,
   logits against the plain composition and an fp32 model, one eval step,
   eval img/s of both routes in turns; six train steps of phase 6's recipe
   with 18 + 18 launches each, one plain-composition step checked as in
   phase 6, train img/s and the peak memory of both routes;
26. fp32 models (dtype None, the factories' default) of map_convnext_tiny,
   ga_convnext_tiny, ga_cswin_tiny and map_maxvit_tiny_tf_224 under the
   default dispatch, which sends fp32 CUDA tensors to the fp32 instances of
   kernels 1-6: each instance against its twin at the models' shapes (B=2),
   then one serving call and one train step per model beside the plain
   path's, logits and loss checked against it, and each model's kernels
   launched; then, in a child process of this script (`--phase26`, with
   CUBLAS_WORKSPACE_CONFIG set before cuBLAS starts), a trace of the fp32
   step's run-to-run difference: two fp32 map_convnext_tiny steps (B=8)
   from one state, which gradients differ and by how much, then the same
   pair under `torch.use_deterministic_algorithms(True)`: the op it
   refuses first, the ops it warns of, and whether the pair is bit-equal;
   the port's own pair must be bit-equal and no op refused;
27. the port's train and validate entries (`python -m
   imagenet_models_tpu_torch.cli.train` / `.cli.validate`), called in this
   process through their `main(argv)` so the launch counts can be read:
   map_convnext_tiny at full width and depth, 224 px, bf16 (`--amp`), B=128,
   the GA recipe (LAMB lr 5e-3 wd 0.05, BCE with smoothing 0.1, dec_lam
   -0.8, EMA 0.9999, drop-path 0.1) on `synthetic:384` through the host
   loader, two epochs of three steps, each with an eval of the raw and the
   EMA model: 18 launches each of kernels 1 and 2 per train step and 18 of
   kernel 1 per eval forward, finite losses, summary.csv with two rows,
   checkpoint-0, checkpoint-1, last and model_best; a resume from `last`
   that starts at epoch 2; the validate entry on model_best with and
   without --use-ema (18 launches of kernel 1 per forward), its top-1 and
   top-5 equal to the engine's eval of the same weights; one fp32 epoch of
   two steps (kernels 1 and 2's fp32 instances); the loops' img/s, the data
   time a step, the host decoder and the host's CPU. Without Pillow on the
   host, the phase binds the entries' `create_dataset`/`create_loader` to
   an in-memory loader of random batches of the same geometry, and says so;
28. data parallelism (`parallel.mesh`, the train step's two formulations), in
   child processes of this script (`--phase28`), so that no process group
   outlives the phase here: (a) the train entry over NCCL at world 1,
   `--dist-coordinator 127.0.0.1:<port> --dist-num-processes 1
   --dist-process-id 0 --zero1`, on phase 27's recipe (map_convnext_tiny, 224
   px, bf16, B=128, one epoch of three steps and an eval): 18 + 18 launches a
   step, finite losses, summary.csv and `last`, and the first step's loss,
   grad norm, weights, EMA shadow and LAMB moments bit-equal to a
   one-process step from a copy of the same state on the same batch and
   generators (cuDNN's deterministic algorithms in that child); then the
   step under NCCL beside the one-process step, and the reduction's share of
   it; (b) two processes on the one card over gloo (NCCL refuses two ranks
   on one device): map_convnext_tiny's replicated step at B=64 a rank and
   map_resnet50's ZeRO-1 step with synchronised BatchNorm statistics at B=32
   a rank, drop-path 0 and no dropout, held by loss, grad norm and gradient
   groups (phase 6's limits; the running statistics within 1e-3 for ZeRO-1)
   to one process on the global batch (for the replicated step, with two
   microbatches of 64: per-rank statistics are its semantics; the distances
   to whole-batch statistics are printed), each rank's launches of kernels 1
   and 2 counted (none of 7 and 8: synchronised statistics take plain ops);
29. map_pit_s (36,147,424 params) with IMTPU_TLNMLP at "1" (the phase sets
   `ops.convnext_block._TLNMLP` and puts it back): serving with 12 launches
   of kernel 1 per request (one per block), logits against the plain path
   and an fp32 model, one eval step, eval img/s at B=256 at "1" and "0" in
   turns; at B=256 one eval forward at each arm (12 launches and none, the
   logits within LOGITS_RTOL of each other); two train steps of the GA
   recipe at B=128 with 12 + 12 launches each, the first against the plain
   path and an fp32 model by `compare_grads`' default gates; train img/s
   at "1" and "0" in turns; then the heads that raised until this slice:
   map_convnext_tiny with split_norm=True and drop_rate 0.1 (SplitNormHeads)
   and map_maxvit_tiny_tf_224 with drop_rate 0.1 (its heads' fc dropout),
   one eval forward (18 launches of kernel 1; MaxViT's eval none of kernel
   3) and one train step at B=64 each (18 + 18 launches of kernels 1 and 2;
   of 3 and 4), finite logits and losses;
30. map_faster_vit_3_224 (187,338,000 params) with IMTPU_PALLAS_BN at
   "full": serving as phase 15 (no launch at eval; eval img/s at "full"
   and "0" in turns); three train steps of the faster_vit_3 recipe
   (train_with_script.py:23) at B=128 with kernels 7 and 8 launched once
   per training BatchNorm of the model's census (20 a forward), the first
   step against the plain path and an fp32 model by phase 16's gates (the
   conv blocks' conv biases, whose true gradient is zero, checked as such
   against their stage's groups); two bf16 steps from one state with
   bit-equal gradients; train img/s at "full" and "0" in turns; kernels 7
   and 8 against their twins, float64 sums and timed per launch at the
   census's shapes, with their sums per step.
31. fine-tuning at 384 px, all bf16: kernels 3 and 4 against their twins
   (and float64) and timed at maxvit_tiny_tf_384's T = 144 stage shapes at
   B=32; a maxvit_tiny_tf_224 `.pth.tar` written by the port from seed-0
   weights (its rel-pos tables drawn from a seed), loaded into
   maxvit_tiny_tf_384 with every table re-resolved 13x13 -> 23x23; (a) one
   train step of the maxvit_tiny recipe at B=32 from one state, with
   `grad_checkpointing` off and on: loss, grad norm, every gradient, every
   BatchNorm running statistic and the next DropPath draw bit-equal, kernel
   3 launched 18 times a step without and 36 with (the recompute), kernel 4
   18 in both, each arm's peak memory and img/s in turns; (b) the train
   entry with `-fp` on that file (synthetic:64, B=16, one epoch of two
   steps, `--amp`): exit 0, its fc keys dropped as JAX drops them, 18 + 18
   launches a step, then the validate entry with `--extract-logits` on the
   run's checkpoint (two batches, finite logits of the heads' shape); (c)
   map_maxvit_tiny_tf_224's eval at B=256 with IMTPU_PART_ATTN at "all"
   against "fused" (`ops.window_attention._PART_ATTN`): 18 launches of
   kernel 3 a forward and none, the logits within LOGITS_RTOL of the plain
   path and of "fused", img/s in turns, kernel 3 against its twin and timed
   at the B=256 shapes; (d) ga_cswin_tiny with IMTPU_STRIPE_MAXH at 56
   against 16 (`ops.stripe_attention._STRIPE_MAXH`): eval at B=256 (30
   launches of kernel 5 a forward and 27, logits within LOGITS_RTOL of the
   plain path), two train steps at B=128 at 56 held to phase 13's gates,
   kernels 5 and 6 counted a step at both, train img/s in turns, and kernels
   5 and 6 timed at the stage-1 and stage-2 shapes that 56 admits;
32. the serving export (`serving.export_serving`), whose programs call
   kernels 1, 3, 5, 12 and 13 through their `imtpu::` custom ops: (a)
   map_convnext_tiny as phase 4 builds it, (b) ga_cswin_tiny, (c)
   map_maxvit_tiny_tf_224 with IMTPU_PART_ATTN at "all", and
   map_maxvit_tiny_tf_224 and ga_cswin_tiny with IMTPU_FLASH_ATTN at "1",
   each exported at B=8 on the card and written to a temporary directory,
   its program listing only its kernel's op, the live serving function's
   launches a call counted (18 of kernel 1, 27 of 5, 18 of 3, 22 of 13, 61
   of 12); a child process (`--phase32`) that imports torch and the op
   library alone, and no model code, reloads every program and runs it
   twice on the same uint8 images: its logits within EXPORT_ATOL of the
   live ones (bit-equal expected: the same kernels on the same inputs), the
   same launches a call; then (a) and (b) exported at B=256, reloaded, and
   their eval img/s timed against the live eager model in turns; (d)
   map_convnext_tiny's train step at B=128 with IMTPU_GELU and
   IMTPU_XLA_GELU at "exact": 18 + 18 launches of kernels 1 and 2, all on
   their exact instances, the step against the plain path and an fp32
   model (also exact) by phase 7's gates, and train img/s at "exact" and
   at the default (fast) in turns of its own (GELU_TURNS), with the device
   time a step of both.

Any failure raises and exits non-zero. The last lines are a JSON summary of
the kernels, the card's name and power limit, and
`{"ok": true, "device": {...}}`. A copy of the measurements goes to
`chiprun_out/chip_smoke.json`. There is no CPU path: without CUDA the script
exits with status 2.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import logging
import pkgutil
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
STAGE_DEPTHS = (3, 3, 9, 3)  # map_convnext_tiny: launches per stage in one forward
STAGE_WIDTHS = (96, 192, 384, 768)
STAGE_SIDES = (56, 28, 14, 7)  # token grid of each stage at 224 px


def stage_shapes(batch: int):
    return [(batch * s * s, c) for s, c in zip(STAGE_SIDES, STAGE_WIDTHS)]


RAGGED_SHAPE = (49 * 3 + 5, 768)
# kernel 2's edges, (n, C, hidden): one token, a few, one more or less than
# k 128-token tiles; C = 688 (43 x 16) and 1024; a hidden width other than
# 4C
BWD_EDGE_SHAPES = ((1, 64, 256), (17, 96, 384), (128 * 3 - 1, 96, 384), (128 * 2 + 1, 688, 2752),
                   (128 + 1, 1024, 4096), (128 * 5 + 3, 96, 256))
# bf16 kernel vs twin: both sum in fp32 in different orders, so a result may
# round to the neighbouring bf16 value; 1e-2 of the largest |output| is 2.5
# bf16 ulps at the top of the range. The same bound holds every output of the
# backward: its fp32 sums add up to 400k exact products of bf16 operands that
# may differ by one rounding between kernel and twin.
KERNEL_RTOL = 1e-2
# kernel path vs plain path through 18 bf16 blocks and the head: one-ulp
# differences per block carry into the logits.
LOGITS_RTOL = 5e-2
# one train step, kernel path vs plain path, from the same state and batch:
# the blocks' bf16 roundings fall differently in the two paths. Measured on
# an H100 80GB HBM3 (700 W): loss 8.7e-6 and global grad norm 7.3e-6
# relative apart.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 1e-3
# The first step's gradients, grouped by stage and block parameter (the
# LN+MLP leaves kernel 2 writes, and the depthwise conv's, which take its
# dx): |g_kernel - g_plain| / |g_plain| (L2 over the group). Each path's
# bf16 roundings carry through every block below, so each is 6-8% (L2) from
# the gradients of the same weights computed in fp32, and the two are
# 2.4-4.2% apart per group (same card). Single leaves are no gate: some have
# a true gradient of zero (attention key biases; the last block's pwconv2
# bias, which only train-mode BatchNorm sees) and hold rounding noise only.
# So the gate is twofold: the paths within TRAIN_GRAD_RTOL of each other,
# and the kernel path no farther from fp32 than TRAIN_GRAD_ACC times the
# plain path's distance (measured at most 1.05).
TRAIN_GRAD_RTOL = 0.08
TRAIN_GRAD_ACC = 1.25
REQUESTS, REQUEST_BATCH, IMG = 4, 32, 224
# eval img/s from turns of six forwards, train img/s from turns of three
# steps after one warm-up step: short turns, so that the script with all its
# phases keeps inside its clock
BENCH_BATCH, BENCH_ITERS = 256, 6
TRAIN_BATCH, TRAIN_STEPS = 128, 6
TRAIN_WARMUP, TRAIN_ITERS = 1, 3
# the opt-in routes (phases 22-24) and MaxViT's train step (phase 10), for
# the same clock: three train steps, and the opt-in routes' turns of two
# steps after one warm-up step
OPT_IN_STEPS = 3
OPT_IN_TURNS = dict(iters=2, warmup=1)
# phase 32d's train img/s at "exact" against the fast fit: turns of its own,
# ten steps each after three warm-up steps of each arm, in three rounds
# (fast, exact, exact, fast, three times), since the two arms of this
# host-bound step differ by a few per cent and turns of two steps spread by
# tens of per cent; beside them the device time a step of each arm
GELU_TURNS = dict(iters=10, warmup=3, rounds=3)
MAXVIT = "map_maxvit_tiny_tf_224"
PS = (7, 7)  # its windows and grid at 224 px
# (map side, C, heads) of the stages that take kernels 3 and 4 at 224 px (the
# 7x7 stage 3 is a single window and takes the composition), and the launches
# of each kernel they give one train step: a block and a grid attention per
# block, in 2, 2 and 5 blocks
MAXVIT_STAGES = ((56, 64, 2), (28, 128, 4), (14, 256, 8))
# phase 8's other shapes of kernels 3 and 4, (B, H, W, heads, window): T = 144
# and 256 (the 384 and 512 px models), non-square maps, an odd batch with
# windows that are not square
ATTN_EXTRA_SHAPES = ((2, 96, 96, 2, (12, 12)), (1, 128, 128, 2, (16, 16)), (8, 14, 21, 3, (7, 7)),
                     (4, 21, 14, 2, (7, 7)), (3, 12, 15, 2, (4, 5)))
MAXVIT_STAGE_LAUNCHES = (4, 4, 10)
MAXVIT_LAUNCHES = sum(MAXVIT_STAGE_LAUNCHES)
MAXVIT_RECIPE = dict(learning_rate=8e-3, weight_decay=0.05, clip_grad=1.0)
MAXVIT_DROP_PATH = 0.2
# MBConv's pre_norm bias: a train-mode BatchNorm (norm1) follows the 1x1 conv
# it feeds, and removes the constant it adds, so its true gradient is zero
MAXVIT_ZERO_GRAD = ("conv.pre_norm.bias",)
# bf16 serving logits against an fp32 model with the same weights, through 11
# bf16 blocks and the head: a loose bound that a wrong route would break
MAXVIT_FP32_RTOL = 0.25
GA_CSWIN = "ga_cswin_tiny"
# (name, map side, ws, C/2, heads, kernel launches per forward) of the idx=0
# stripes of ga_cswin_tiny at 224 px: stages 1 and 2 are taller than the
# gate's 16 rows and take the composition; stage 3 (21 blocks), the stage-5
# block and the 5 gram layers take kernels 5 and 6 (the 7x7 stage 4 is one
# window, idx=-1)
CSWIN_STRIPES = (("stage1", 56, 1, 32, 1, 0), ("stage2", 28, 2, 64, 2, 0),
                 ("stage3", 14, 7, 128, 4, 21), ("stage5", 14, 7, 256, 8, 1),
                 ("gram", 14, 7, 96, 3, 5))
CSWIN_PATH_LAUNCHES = tuple(n for *_, n in CSWIN_STRIPES if n)
CSWIN_LAUNCHES = sum(CSWIN_PATH_LAUNCHES)
# the GA recipe of both GA models: benchkit's (imagenet_models_tpu/utils/
# benchkit.py:36-40) and README.md:51's -- timm LAMB lr 5e-3 wd 0.05, BCE with
# smoothing 0.1 on dense (mixup) targets, EMA 0.9999, dec_lam -0.8
GA_RECIPE = dict(learning_rate=5e-3, weight_decay=0.05)
GA_EMA = 0.9999
# groups with a true gradient of zero: the grouped projections' biases before
# the heads' train-mode BatchNorms, and the key third of every qkv bias
# (softmax ignores a shift of the keys); and one of nearly zero: the stage-5
# block's last bias adds one vector to every token of the map, which the
# heads' first BatchNorms remove and the class attention sees only through
# its 1e-4 layer scale (its fp32 gradient measured 4e-5 of the median
# group's on an H100, below the bf16 paths' noise)
CSWIN_ZERO_GRAD = ("gram_contraction.0.bias", "gram_embedding.0.bias", "qkv.bias_k",
                   ("5", "mlp.fc2.bias"))
# stage 1 (one block, so one leaf per group) runs no stripe kernel: the
# paths' gradients there differ only by what the stage-3 kernels' bf16
# roundings send down, and each group is just 1.8-2.0% from fp32, so its
# kernel / plain distance ratio is as much the draw of those roundings as
# the kernels' accuracy. Its worst group read 1.209 (norm1.bias), 1.264
# (attns.0.get_v.bias: 0.02268 / 0.01794), 1.197 (norm1.bias) and 1.149
# (proj.bias) in four calls of the same code (H100 80GB HBM3, 700 W), while
# the resamples' backward still added by atomics; since they do not, the
# bf16 steps are bit-equal between runs and stage 1 reads 1.239 (stripe
# route) and 1.089 (flash route). Held by TRAIN_GRAD_RTOL alone.
CSWIN_NOISY_STAGES = ("1",)
# bf16 serving logits against an fp32 model with the same weights, as MaxViT's
CSWIN_FP32_RTOL = 0.25
RESNET, MOBILENET = "map_resnet50", "map_mobilenet_v1"
# the resnet50 row of train_with_script.py:19 (LAMB lr 5e-3 wd 0.02, BCE with
# smoothing 0.1 on mixup's dense targets, drop-path 0.1, head dropout 0.1, no
# EMA; dec_lam -0.8 is train.py:151's default) and the mobilenet_v1 row (:25:
# the same optimizer, no smoothing, 160 px)
RESNET_RECIPE = {"opt": dict(learning_rate=5e-3, weight_decay=0.02),
                 "loss": dict(bce_loss=True, smoothing=0.1, mixup_active=True)}
RESNET_DROPS = dict(drop_path_rate=0.1, drop=0.1)
MOBILENET_RECIPE = {"opt": dict(learning_rate=5e-3, weight_decay=0.02),
                    "loss": dict(bce_loss=True, smoothing=0.0, mixup_active=True)}
MOBILENET_IMG = 160
# kernels 7 and 8 against float64 sums and their fp32 twins: |difference|
# per channel over the sum of |terms| of that channel, the scale of the fp32
# rounding of any order of summation (a sum of 1.6M terms in fp32 by a
# blocked order errs by some 1e-7 of it)
BN_SUM_RTOL = 1e-5
# bf16 serving logits against an fp32 model with the same weights
BN_FP32_RTOL = 0.25
# The BatchNorm family's bf16 first-step gradients are far from fp32 on
# either path (by group 0.51-0.82 L2 for map_resnet50, 0.84-2.42 for
# map_mobilenet_v1; H100 80GB HBM3, 700 W): at initialisation each conv +
# train-mode BatchNorm layer scales a small difference of its input up, so
# the forward's bf16 rounding grows geometrically with depth (`bf16_drift`
# logs it block by block), and two bf16 runs whose statistics differ in the
# last bits end far apart. JAX's bf16 gradients are as far from its fp32
# ones at a narrow size (tests/test_torch_resnet.py). So the kernel and
# plain paths are held together by group in fp32 (TRAIN_GRAD_RTOL), and in
# bf16 by group only through their distances to the fp32 gradients
# (TRAIN_GRAD_ACC).
GA_CONVNEXT = "ga_convnext_tiny"
# (name, B, H, W, C, launches per train step) of the ConvNeXt blocks of
# ga_convnext_tiny at 224 px and B=128: their dw convs' weight gradients are
# kernel 9's with IMTPU_DW_WGRAD at "1" (3, 3, 9 and 3 backbone blocks, one
# gram-layer block in each of the 5 branches), and each block is one launch
# of kernels 1 and 2
DW_SHAPES = (("stage0", 128, 56, 56, 96, 3), ("stage1", 128, 28, 28, 192, 3),
             ("stage2", 128, 14, 14, 384, 9), ("stage3", 128, 7, 7, 768, 3),
             ("gram", 128, 14, 14, 192, 5))
DW_PATH_LAUNCHES = tuple(n for *_, n in DW_SHAPES)
GA_LAUNCHES = sum(DW_PATH_LAUNCHES)
# kernel 9 off the path's shapes: stage 3 of ga_convnext_tiny_688 (C = 688,
# a ragged channel tile), a non-square map, an odd batch
DW_EXTRA = ((128, 7, 7, 688), (6, 20, 36, 128), (3, 14, 14, 192))
# kernel 9 against float64 sums of its (rounded) products: |difference| per
# tap over the tap's sum of |terms|, the scale of the fp32 rounding of any
# order of summation
DW_SUM_RTOL = 1e-5
# README.md:51 adds drop-path 0.1 to the GA recipe for ga_convnext_tiny;
# ls_init_value=1 as phase 6, so that the blocks show
GA_TRAIN_KW = dict(drop_path_rate=0.1, ls_init_value=1.0)
# groups with a true gradient of zero: the biases of the convs and
# projections that feed a train-mode BatchNorm (the heads' gram contraction
# and embedding, the stage-5 bottleneck's shortcut conv)
GA_ZERO_GRAD = ("gram_contraction.0.bias", "gram_embedding.0.bias", ("4", "downsample.0.bias"))
# The first train step's bf16 gradients of ga_convnext_tiny lie far apart
# between the kernel and the plain path: 11.2% (L2) over all leaves, up to
# 16% in a group (stage 0 norm.bias), each path 11.7% from fp32 (H100 80GB
# HBM3, 700 W), against 2.4-4.2% and 6-8% for map_convnext_tiny: the gram
# heads' and the bottleneck's train-mode BatchNorms amplify the paths'
# different bf16 roundings, as in the BatchNorm family (phase 16). So that
# pair is held by the loss and, by group, by its distances to the fp32
# gradients (TRAIN_GRAD_ACC); grad norms are logged. Kernel 9 is held on the
# path by its own inputs: every (x, dy) it takes in the first step, against
# float64 sums and the twin (DW_SUM_RTOL). The kernel path's first step at
# IMTPU_DW_WGRAD "0" from the same state (cuDNN's weight gradient; dx is the
# same framework call under both) must give the same loss and grad norm
# within DW_SWITCH_RTOL; its gradients are logged by group beside those of
# a second "0" step, whose distance is the library kernels' run-to-run
# spread.
DW_SWITCH_RTOL = 1e-3
# kernels 12 and 13 (fused window attention) on the flash route, N = 49 or
# 56 or 98 tokens, heads of FLASH_D channels, as the port's forward at 224 px
# gives them (per image; BW grows with the batch): kernel 13 in the 22
# attentions of map_maxvit_tiny_tf_224's eval forward, (name, windows per
# image, heads, launches), with one (heads, 49, 49) rel-pos bias each; in
# training only stage 3's 4 (stages 0-2 keep kernels 3 and 4)
FLASH_D = 32
MAXVIT_FLASH_SHAPES = (("stage0", 64, 2, 4), ("stage1", 16, 4, 4), ("stage2", 4, 8, 10),
                       ("stage3", 1, 16, 4))
MAXVIT_FLASH_WEIGHTS = tuple(n for *_, n in MAXVIT_FLASH_SHAPES)
MAXVIT_FLASH_LAUNCHES = sum(MAXVIT_FLASH_WEIGHTS)
MAXVIT_FLASH_TRAIN_LAUNCHES = MAXVIT_FLASH_SHAPES[-1][-1]
# kernel 12 in ga_cswin_tiny's 61 LePEAttention calls: (name, windows x
# heads per image, N, launches), no bias
CSWIN_FLASH_SHAPES = (("stage1", 56, 56, 2), ("stage2", 28, 56, 4), ("stage3", 8, 98, 42),
                      ("stage4", 16, 49, 1), ("stage5", 16, 98, 2), ("gram", 6, 98, 10))
CSWIN_FLASH_WEIGHTS = tuple(n for *_, n in CSWIN_FLASH_SHAPES)
CSWIN_FLASH_LAUNCHES = sum(CSWIN_FLASH_WEIGHTS)
# off the paths: the windows of maxvit_tiny_tf_384 and _512 (N = 144, 256),
# the JAX tests' ragged N = 50, D = 24, wider heads, and kernel 12 with a
# per-window bias: ("12" or "13", BW, heads, N, D, bias)
FLASH_EXTRA = (("13", 64, 2, 144, 32, True), ("13", 16, 2, 256, 32, True),
               ("13", 4, 3, 50, 24, True), ("12", 4, 1, 50, 24, True),
               ("12", 1024, 1, 98, 32, True), ("12", 7, 1, 256, 128, False),
               ("12", 9, 1, 33, 64, True))
# fp32 kernel vs twin: both keep every digit of p and sum in fp32 in other
# orders (1e-7 of a sum of |terms|)
FLASH_FP32_RTOL = 1e-5
# kernels 12 and 13's bf16 outputs against the float64 function of the same
# inputs: the tensor cores sum the products in another order than the twin,
# so the two may round p or the output to neighbouring bf16 values and are no
# longer bit-equal; a kernel's largest error may be at most this many times
# the twin's, at every shape
FLASH_FP64_RATIO = 1.25
# kernel 12's fp32 instance (the CUDA-core `window_attn_fwd_kernel`, with
# csrc/window_attn_common.cuh) keeps the bits of the build that ran both
# dtypes on the CUDA cores: the SHA-256 of its fp32 outputs at `k12_digest`'s
# fixed inputs from that build, on an NVIDIA H100 80GB HBM3 with the CUDA
# 12.8 toolkit
K12_FP32_DIGEST = "cf1d7dbd7faf6530a42960db473a8191151c796f85e3604a8ff2cd3b0462e57c"
# kernels 3 and 4's fp32 instances (the CUDA-core `partition_attn_fwd_kernel`
# and `partition_attn_bwd_kernel`, with their blocks per head) keep the bits
# of the build that ran both dtypes on the CUDA cores: the SHA-256 of their
# fp32 outputs at `k34_digest`'s fixed inputs from that build, on an NVIDIA
# H100 80GB HBM3 with the CUDA 12.8 toolkit and PyTorch 2.11.0+cu128. The
# bits are the kernels' own (no library call computes them), but another
# nvcc may compile expf or the contractions differently and move them.
K34_FP32_DIGEST = "47afd6a9c34981edb15f9e345ba5045031e8848a72d9b5dcf6c2c1134f9bc8b0"
# the SASS opcodes counted in the kernels' code reports (phases 18 and 21)
SASS_OPCODES = ("HMUL2", "HFMA2", "FADD", "FFMA", "FMUL", "HMMA", "LDSM", "LDS", "STS", "LDG",
                "LDGSTS", "BAR", "SHFL", "MUFU", "BRA", "HGMMA", "UTMALDG", "SYNCS")
# IMTPU_TLNMLP's first train step, kernel path (kernels 1 and 2 on every
# MLP) against the plain path, by model (H100 80GB HBM3, 700 W, four calls
# of the same code): MaxViT's bf16 gradients lie 8.6% (L2) apart in a group
# (stage 0 conv.pre_norm.weight, a BatchNorm after the MBConv's expansion,
# the amplifier of phase 16), 5.1% over all leaves, against 2.6% and 1.3%
# with the flash switch alone, while the kernel path stays as close to fp32
# as the plain path (distance ratio 1.073 in every call): held as phases 16
# and 20 hold theirs, by the ratio. GA-CSWin's two paths stay within 0.0657,
# 0.0654, 0.0689 and 0.0642 of each other by group, and 0.018 over all
# leaves, each 2.4% from fp32, but the ratio of its small stage-2 groups
# (two leaves of 64 or 128 values) wanders with the library kernels'
# nondeterminism, as phase 13's stage 1 does: 1.212, 1.22, 1.252 and 1.291
# in the four calls. Held by the "apart" gate. Both pairs are held by the loss and the grad norm
# too; the other gate's figure is logged.
TLNMLP_GRAD_GATES = {MAXVIT: ("ratio",), GA_CSWIN: ("apart",)}
# the eligible norm2 + MLP pairs of IMTPU_TLNMLP: every PartitionAttention of
# map_maxvit_tiny_tf_224 (22) and every CSWinBlock of ga_cswin_tiny with an
# ungrouped MLP (31: 25 backbone, the stage-5 block, 5 gram layers)
MAXVIT_MLPS, CSWIN_MLPS = 22, 31
# the fused ConvNeXt branch (kernels 10 and 11), phase 25: map_convnext_tiny's
# 18 blocks at 224 px and the train batch, (name, B, H, W, C, launches per
# forward); on the branch route each block is one launch of kernel 10 in the
# forward and one of kernel 11 in the backward
BRANCH_SHAPES = tuple((f"stage{i}", TRAIN_BATCH, s, s, c, n) for i, (s, c, n)
                      in enumerate(zip(STAGE_SIDES, STAGE_WIDTHS, STAGE_DEPTHS)))
# off the path: ga_convnext_tiny's gram layers, an odd batch, a non-square
# map, and C = 688 (ga_convnext_tiny_688's stage 3, a ragged channel tile)
BRANCH_EXTRA = (("gram", 128, 14, 14, 192), ("odd batch", 3, 14, 14, 384),
                ("non-square", 6, 20, 36, 128), ("C=688", 128, 7, 7, 688))
# fp32 kernel vs twin: the kernels' fp32 products are 3xTF32 (about 22 bits
# of each product kept) against the twins' exact fp32 products, and both sum
# in fp32 in other orders, the weight gradients over up to 400k tokens:
# 2.5e-4 of the largest |value| of each output. At phase 25's eight shapes
# the kernels read at most 1.03e-4 and one-pass TF32 products (11 bits, the
# twin with TF32 on, which compare_branch also reads) 5.2e-4 to 6.9e-4, so
# the limit tells a kernel that drops the 3xTF32 lo terms from one that keeps them
BRANCH_FP32_RTOL = 2.5e-4
# kernels 10 and 11's fp32 instances (the first design's 3xTF32 wmma kernels) keep
# their bits: the SHA-256 of their fp32 outputs at `k1011_digest`'s fixed
# inputs from that design's build (its bf16 instances on wmma too), on an
# NVIDIA H100 80GB HBM3 with the CUDA 12.8 toolkit and PyTorch 2.11.0+cu128
K1011_FP32_DIGEST = "5257499a508907901764ee9bdbb173054ff288dd92044a692fdebe1a3601bac0"
# bf16 serving logits on the branch route against an fp32 model with the same
# weights on it, as the GA models' (CSWIN_FP32_RTOL)
BRANCH_FP32_LOGITS_RTOL = 0.25

# the IMTPU_DW_WGRAD arms timed in phase 20: (switch, path)
DW_ARMS = (("1", "kernel"), ("0", "kernel"), ("0", "plain"))
# the switch's arms timed in phase 16: (IMTPU_PALLAS_BN, path)
BN_ARMS = (("full", "kernel"), ("full", "plain"), ("bwd", "kernel"), ("0", "kernel"))
# map_pit_s at 224 px, phases 3 and 29: (token map side, C, blocks) of its
# three stages; with IMTPU_TLNMLP at "1" each block's norm2 + MLP is one
# launch of kernel 1 in a forward and of kernel 2 in a backward, at C = 144,
# 288 and 576
PIT = "map_pit_s"
PIT_STAGES = ((27, 144, 2), (14, 288, 6), (7, 576, 4))
PIT_DEPTHS = tuple(n for *_, n in PIT_STAGES)
PIT_MLPS = sum(PIT_DEPTHS)
# the key third of every qkv bias has a true gradient of zero (softmax
# ignores a shift of the keys), as in GA-CSWin
PIT_ZERO_GRAD = ("attn.qkv.bias_k",)
# map_faster_vit_3_224, phase 30: the faster_vit_3 row of
# train_with_script.py:23 (LAMB lr 5e-3 wd 0.05, clip 5.0 by norm, soft-target
# cross-entropy on mixup's dense targets, drop-path 0.3, dec_lam -0.8 as
# train.py's default)
FASTERVIT = "map_faster_vit_3_224"
FASTERVIT_RECIPE = {"opt": dict(learning_rate=5e-3, weight_decay=0.05, clip_grad=5.0),
                    "loss": dict(bce_loss=False, smoothing=0.1, mixup_active=True)}
FASTERVIT_DROPS = dict(drop_path_rate=0.3)
FASTERVIT_STEPS = 3
# the conv blocks' conv biases feed a train-mode BatchNorm, which removes the
# constant they add: their true gradient is zero
FASTERVIT_ZERO_GRAD = ("conv1.bias", "conv2.bias")
# phase 29's heads item: map_convnext_tiny with SplitNormHeads and
# map_maxvit_tiny_tf_224 with the fc dropout, one train step each at this batch
HEADS_BATCH = 64
# the device kernels of kernels 1 and 2 (csrc/ln_mlp_fwd.cu, csrc/ln_mlp_bwd.cu)
LN_MLP_KERNEL_NAMES = ("ln_mlp_fwd_prologue_kernel", "ln_mlp_fwd_gemm_kernel",
                       "ln_mlp_bwd_prologue_kernel", "ln_mlp_bwd_gemm_kernel",
                       "ln_mlp_bwd_rows_kernel", "colsum_kernel", "dw2_finish_kernel")
# the card's published dense peaks (H100 SXM, NVIDIA's data sheet)
PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS = 989e12, 3.35e12, 67e12
OUT_DIR = Path("chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of `fn` on the current stream, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters: int, order=("plain", "kernel")):
    """Times of every fns[name] of `order` in turns (by default plain,
    kernel, kernel, plain: the order, then back); returns {name: [ms, ms]}."""
    times = {name: [] for name in order}
    for which in tuple(order) + tuple(order)[::-1]:
        times[which].append(cuda_ms(fns[which], iters))
    return times


def bound_ms(n: int, c: int, backward: bool) -> tuple:
    """The least time of one LN+MLP launch on (n, c) tokens, hidden 4c: the
    larger of its operations over the bf16 peak and its bytes (each input
    read once, each output written once) over the memory rate."""
    hidden = 4 * c
    if backward:
        # five products: pre1 (recomputed), dhmid, dln, dW1 and G = g^T hmid,
        # which gives dW2 = gamma * G and, with pre2 = hmid W2^T + b2,
        # dgamma = sum_j W2 * G + b2 * sum_t g, so pre2 need not be formed
        flops = 5 * 2 * n * c * hidden
        nbytes = 3 * n * c * 2 + 2 * hidden * c * 2 + 2 * hidden * c * 4 + 2 * (hidden + 4 * c) * 4
    else:
        flops = 2 * 2 * n * c * hidden
        nbytes = 2 * n * c * 2 + 2 * hidden * c * 2 + (hidden + 4 * c) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ln_mlp_args(n: int, c: int, gen, hidden: int = 0, dtype=None):
    """Tokens and weights in `dtype` (bf16 unless given), vectors fp32."""
    import torch

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    dt = dtype or torch.bfloat16
    hid = hidden or 4 * c
    return (randn(n, c).to(dt),
            randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1),
            randn(hid, c, scale=c ** -0.5).to(dt), randn(hid, scale=0.1),
            randn(c, hid, scale=hid ** -0.5).to(dt), randn(c, scale=0.1),
            randn(c))


def rel_err(got, ref) -> float:
    scale = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / max(scale, 1e-30)


def compare_forward(args, gelu_impl: str, tag: str) -> dict:
    """One launch of kernel 1 against its twin on the same inputs, and a
    second launch against the first; raises past KERNEL_RTOL or if the second
    gives other bits."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, plain_ln_mlp

    n, c = args[0].shape
    hidden = args[3].shape[0]
    with torch.inference_mode():
        got = fused_ln_mlp(*args, gelu_impl=gelu_impl)
        again = fused_ln_mlp(*args, gelu_impl=gelu_impl)
        ref = plain_ln_mlp(*args, gelu_impl=gelu_impl)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"forward kernel output at ({n}, {c}, {hidden}) is malformed")
        same = torch.equal(got, again)
        err = (got.float() - ref.float()).abs().max().item()
        ratio = rel_err(got, ref)
    log(f"[kernels] ln_mlp_fwd[{gelu_impl}] {tag}N={n} C={c} hidden={hidden}: "
        f"max|kernel-twin|/max|twin| = {ratio:.4g} (tol {KERNEL_RTOL}); bit-equal across two "
        f"runs: {same}")
    if not (ratio <= KERNEL_RTOL and same):
        raise AssertionError(f"forward kernel ({gelu_impl}) disagrees with its twin at "
                             f"({n}, {c}, {hidden}): {ratio}, or moved between runs ({same})")
    return {"n": n, "c": c, "hidden": hidden, "gelu": gelu_impl, "max_abs_err": err,
            "err_over_max_twin": ratio, "bit_equal": same}


def check_forward(gelu_impl: str, time_batches):
    """Kernel 1 vs its twin with `gelu_impl` at the B=64 stage shapes, the
    ragged one and BWD_EDGE_SHAPES, and with both GELUs at the stage shapes
    of each batch in `time_batches`, each bit-equal across two runs; at the
    latter, with `gelu_impl`, also timed per launch in turns with the twin
    ({batch: rows}), each stage of its pipeline alone (`ln_mlp_fwd_pipeline`),
    and, as a yardstick of the tensor cores and not the same function, its
    two products as torch.matmul calls at the same shapes (which the port
    never calls)."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import (
        FWD_STAGES, fused_ln_mlp, ln_mlp_fwd_pipeline, plain_ln_mlp)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for n, c, hidden in ([(n, c, 0) for n, c in stage_shapes(64) + [RAGGED_SHAPE]]
                         + list(BWD_EDGE_SHAPES)):
        args = ln_mlp_args(n, c, gen, hidden)
        rows.append(compare_forward(args, gelu_impl, ""))
        del args
    times = {}
    for time_batch, (n, c) in [(b, nc) for b in time_batches for nc in stage_shapes(b)]:
        args = ln_mlp_args(n, c, gen)
        rows += [compare_forward(args, gi, f"B={time_batch} ") for gi in ("exact", "fast")]
        iters = max(3, min(50, 2_000_000 // n))
        with torch.inference_mode():
            t = in_turns({"kernel": lambda: fused_ln_mlp(*args, gelu_impl=gelu_impl),
                          "plain": lambda: plain_ln_mlp(*args, gelu_impl=gelu_impl)}, iters)
            call = ln_mlp_fwd_pipeline(*args, gelu_impl=gelu_impl)
            stages = {name: cuda_ms(lambda k=k: call.run(k, k + 1), iters)
                      for k, name in enumerate(FWD_STAGES)}
            del call
            h, w1, w2 = args[0], args[3], args[5]
            mid = torch.randn(n, 4 * c, generator=gen, device="cuda").to(torch.bfloat16)
            matmul_ms = cuda_ms(lambda: (h @ w1.t(), mid @ w2.t()), iters)
        bound, by = bound_ms(n, c, backward=False)
        row = {"n": n, "c": c, "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
               "stages_ms": stages, "matmul2_ms": matmul_ms, "bound_ms": bound, "bound_by": by,
               "turns": t}
        times.setdefault(time_batch, []).append(row)
        log(f"[kernels] ln_mlp_fwd[{gelu_impl}] B={time_batch} N={n} C={c}: kernel "
            f"{row['ms']:.4f} ms (" + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
            + f" alone), twin {row['plain_ms']:.4f} ms, two torch.matmul products "
            f"{matmul_ms:.4f} ms, bound {bound:.4f} ms ({by}) (twin,kernel,kernel,twin: "
            f"{t['plain'][0]:.4f},{t['kernel'][0]:.4f},{t['kernel'][1]:.4f},{t['plain'][1]:.4f})")
        del args, mid
    for time_batch, batch_times in times.items():
        per = {k: weighted(batch_times, k, STAGE_DEPTHS)
               for k in ("ms", "plain_ms", "matmul2_ms", "bound_ms")}
        log(f"[kernels] ln_mlp_fwd[{gelu_impl}] per map_convnext_tiny forward at "
            f"B={time_batch}: kernel {per['ms']:.4f} ms, twin {per['plain_ms']:.4f} ms, two "
            f"torch.matmul products {per['matmul2_ms']:.4f} ms, bound {per['bound_ms']:.4f} ms")
    return rows, times


def check_forward_code(build) -> dict:
    """Kernel 1's code report: the GEMM stages' SASS must hold wgmma (HGMMA)
    instructions, where cuobjdump could read it."""
    code = code_report(build, "ln_mlp_fwd")
    gemms = {k: v for k, v in code["sass"].items() if "ln_mlp_fwd_gemm_kernel" in k}
    if gemms and not all(v.get("HGMMA") for v in gemms.values()):
        raise AssertionError(f"kernel 1's GEMM stages hold no wgmma instruction: {gemms}")
    return code


BWD_NAMES = ("dx", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")


def compare_backward(args, g, gelu_impl: str, tag: str) -> dict:
    """One launch of kernel 2 against its twin on the same inputs, all eight
    outputs, and a second launch against the first; raises past KERNEL_RTOL
    or if the second gives other bits."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp_bwd, plain_ln_mlp_bwd

    n, c = args[0].shape
    hidden = args[3].shape[0]
    got = fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    again = fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    ref = plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ratios = {}
    for name, o, r in zip(BWD_NAMES, got, ref):
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"backward kernel output {name} at ({n}, {c}): "
                                 f"{tuple(o.shape)} {o.dtype}, twin {tuple(r.shape)} {r.dtype}")
        if not torch.isfinite(o.float()).all():
            raise AssertionError(f"backward kernel output {name} at ({n}, {c}) is not finite")
        ratios[name] = rel_err(o, r)
    err = max((o.float() - r.float()).abs().max().item() for o, r in zip(got, ref))
    log(f"[kernels] ln_mlp_bwd[{gelu_impl}] {tag}N={n} C={c} hidden={hidden}: "
        "max|kernel-twin|/max|twin| " + " ".join(f"{k}={v:.3g}" for k, v in ratios.items())
        + f" (tol {KERNEL_RTOL}); bit-equal across two runs: {same}")
    bad = [k for k, v in ratios.items() if not v <= KERNEL_RTOL]
    if bad or not same:
        raise AssertionError(f"backward kernel ({gelu_impl}) disagrees with its twin at "
                             f"({n}, {c}, {hidden}) in {bad}, or moved between runs ({same})")
    return {"n": n, "c": c, "hidden": hidden, "gelu": gelu_impl, "max_abs_err": err,
            "ratios": ratios, "bit_equal": same}


def check_backward():
    """Kernel 2 vs its twin with both GELUs at the B=64 stage shapes, the
    ragged one and BWD_EDGE_SHAPES, bit-equal across two runs; with the
    training GELU at the B=128 stage shapes, where it is also timed per
    launch in turns with the twin, each stage of its pipeline alone
    (`ln_mlp_bwd_pipeline`), and, as a yardstick of the tensor cores and not
    the same function, its five products as torch.matmul calls at the same
    shapes (which the port never calls)."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import (
        BWD_STAGES, fused_ln_mlp_bwd, ln_mlp_bwd_pipeline, plain_ln_mlp_bwd)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for gelu_impl in ("exact", "fast"):
        for n, c, hidden in ([(n, c, 0) for n, c in stage_shapes(64) + [RAGGED_SHAPE]]
                             + list(BWD_EDGE_SHAPES)):
            args = ln_mlp_args(n, c, gen, hidden)
            g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
            rows.append(compare_backward(args, g, gelu_impl, ""))
            del args, g
    times = []
    for n, c in stage_shapes(TRAIN_BATCH):
        args = ln_mlp_args(n, c, gen)
        g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(compare_backward(args, g, "fast", f"B={TRAIN_BATCH} "))
        iters = max(3, min(30, 1_000_000 // n))
        t = in_turns({"kernel": lambda: fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast"),
                      "plain": lambda: plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast")},
                     iters)
        call = ln_mlp_bwd_pipeline(args[0], g, *args[1:], gelu_impl="fast")
        stages = {name: cuda_ms(lambda k=k: call.run(k, k + 1), iters)
                  for k, name in enumerate(BWD_STAGES)}
        del call
        h, w1, w2 = args[0], args[3], args[5]
        mid = torch.randn(n, 4 * c, generator=gen, device="cuda").to(torch.bfloat16)
        products = (lambda: h @ w1.t(), lambda: g @ w2, lambda: mid @ w1, lambda: mid.t() @ h,
                    lambda: g.t() @ mid)
        matmul_ms = cuda_ms(lambda: [p() for p in products], iters)
        bound, by = bound_ms(n, c, backward=True)
        row = {"n": n, "c": c, "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
               "stages_ms": stages, "matmul5_ms": matmul_ms, "bound_ms": bound, "bound_by": by,
               "turns": t}
        times.append(row)
        log(f"[kernels] ln_mlp_bwd[fast] B={TRAIN_BATCH} N={n} C={c}: kernel {row['ms']:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()) + f" alone), twin "
            f"{row['plain_ms']:.4f} ms, five torch.matmul products {matmul_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}) (twin,kernel,kernel,twin: {t['plain'][0]:.4f},"
            f"{t['kernel'][0]:.4f},{t['kernel'][1]:.4f},{t['plain'][1]:.4f})")
        del args, g, mid
    return rows, times


def serve():
    """The serving path: map_convnext_tiny on the card, through the kernel."""
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp
    from imagenet_models_tpu_torch.serving import make_serving_fn
    from imagenet_models_tpu_torch.train.state import make_eval_step

    n_blocks = sum(STAGE_DEPTHS)
    # ls_init_value=1: the default 1e-6 layer scale would hide every block's
    # branch, and with it the kernel, from the logits compared below
    t0 = time.perf_counter()
    model = create_model("map_convnext_tiny", dtype=torch.bfloat16, ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    if not next(model.parameters()).is_cuda:
        raise AssertionError("create_model did not build on the GPU by default")
    log(f"[serving] map_convnext_tiny built: "
        f"{sum(p.numel() for p in model.parameters())} params, bf16 compute, "
        f"{time.perf_counter() - t0:.1f} s")
    serve_fn = make_serving_fn(model)
    plain_fn = make_serving_fn(model, use_kernel=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    requests = [torch.randint(0, 256, (REQUEST_BATCH, IMG, IMG, 3), generator=gen,
                              device="cuda", dtype=torch.uint8) for _ in range(REQUESTS)]

    fused_ln_mlp.launches = 0
    outputs, per_request = [], []
    t0 = time.perf_counter()
    for images in requests:
        before = fused_ln_mlp.launches
        outputs.append(serve_fn(images))
        per_request.append(fused_ln_mlp.launches - before)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    launches = fused_ln_mlp.launches
    log(f"[serving] {REQUESTS} requests of {REQUEST_BATCH} in {served_s:.3f} s "
        f"(first includes warm-up); ln_mlp_fwd launches per request: {per_request}")
    if per_request != [n_blocks] * REQUESTS:
        raise AssertionError(f"expected {n_blocks} kernel launches per request, got {per_request}")
    for logits in outputs:
        if logits.shape != (REQUEST_BATCH, 1000) or logits.dtype != torch.float32:
            raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")

    plain = plain_fn(requests[0])
    err = (outputs[0] - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (outputs[0].argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[serving] kernel path vs plain path logits: max|diff|={err:.4g} "
        f"(tol {LOGITS_RTOL * scale:.4g}, max|plain|={scale:.4g}), top-1 agreement {agree:.3f}")
    if not err <= LOGITS_RTOL * scale:
        raise AssertionError(f"kernel-path logits disagree with the plain path: {err}")

    step = make_eval_step(model)
    cfg = default_cfg("map_convnext_tiny")
    mean = torch.tensor(cfg["mean"], device="cuda")
    std = torch.tensor(cfg["std"], device="cuda")
    x = (requests[1].float() / 255.0 - mean) / std
    targets = torch.randint(0, 1000, (REQUEST_BATCH,), generator=gen, device="cuda")
    before = fused_ln_mlp.launches
    logits, top1, top5 = step(x, targets)
    if fused_ln_mlp.launches - before != n_blocks:
        raise AssertionError("eval step did not run every block through the kernel")
    if not (logits - outputs[1]).abs().max().item() <= 1e-3 * scale:
        raise AssertionError("eval step logits differ from the serving logits on the same images")
    if not (top1 <= top5).all() or top1.shape != (REQUEST_BATCH,):
        raise AssertionError("eval step top-1/top-5 flags are malformed")
    log(f"[serving] eval step: top-1 {top1.mean().item():.4f}, top-5 {top5.mean().item():.4f} "
        f"on random targets")
    return model, launches, {"max_abs_err": err, "max_abs_plain": scale, "top1_agreement": agree}


def throughput(model, card: str, name: str = "map_convnext_tiny"):
    """Eval img/s at B=256 of the kernel path and the plain path in turns."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    model.eval()
    with torch.inference_mode():
        t = in_turns({"kernel": lambda: model(x, use_kernel=True),
                      "plain": lambda: model(x, use_kernel=False)}, BENCH_ITERS)
    runs = {k: [BENCH_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[throughput] {name} eval B={BENCH_BATCH} {IMG}px bf16: "
        f"kernel path {result['kernel']:.1f} img/s, plain path {result['plain']:.1f} img/s "
        f"(turns plain,kernel,kernel,plain: {runs['plain'][0]:.1f},{runs['kernel'][0]:.1f},"
        f"{runs['kernel'][1]:.1f},{runs['plain'][1]:.1f}) on {card}")
    return result, runs


def eval_arms(model, switch: str, card: str, name: str):
    """Eval img/s at B=256 of the kernel path with the switch at "0" and "1"
    in turns (0, 1, 1, 0); the switch is left at "1"."""
    import torch

    module, attr = switch_attr(switch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    model.eval()

    def arm(mode):
        def run():
            setattr(module, attr, mode)
            model(x)
        return run

    with torch.inference_mode():
        t = in_turns({"0": arm("0"), "1": arm("1")}, BENCH_ITERS, order=("0", "1"))
    setattr(module, attr, "1")
    runs = {k: [BENCH_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[throughput] {name} eval B={BENCH_BATCH} {IMG}px bf16: {switch} at 1 "
        f"{result['1']:.1f} img/s, at 0 {result['0']:.1f} img/s (turns 0,1,1,0: "
        f"{runs['0'][0]:.1f},{runs['1'][0]:.1f},{runs['1'][1]:.1f},{runs['0'][1]:.1f}) on {card}")
    return result, runs


def make_trainer():
    """bench.py's train recipe on a fresh full-width map_convnext_tiny."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state

    model = create_model("map_convnext_tiny", dtype=torch.bfloat16, ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    opt = create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05)
    state = create_train_state(model, opt, ema_decay=0.9999)
    loss_fn = create_loss_fn(bce_loss=True, smoothing=0.1, mixup_active=True)
    return state, opt, loss_fn


def train_batch():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    images = torch.randn(TRAIN_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    targets = torch.rand(TRAIN_BATCH, 1000, generator=gen, device="cuda")
    return images, targets


class FirstGrads:
    """An optimizer that keeps an fp32 copy of the gradients of its first
    update and passes every update on to `opt`."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params, grouped=None):
        return self.opt.init(params, grouped)

    def step(self, params, grads, state, **kw):
        if self.grads is None:
            self.grads = {k: g.detach().float().clone() for k, g in grads.items()}
        self.opt.step(params, grads, state, **kw)


def rel_l2(got, ref) -> float:
    return (got - ref).norm().item() / max(ref.norm().item(), 1e-30)


def grad_group(name: str):
    """(stage, block parameter) of a parameter name, or None: the blocks of a
    stage, `stages.<s>.<j>.<kind>` (ConvNeXt), `stages.<s>.blocks.<j>.<kind>`
    (MaxViT), `stage<s>.<j>.<kind>` and the stage-5 block `stage5.2.<kind>`
    (GA-CSWin); GA-ConvNeXt's blocks `stages.<s>.blocks.<j>.<kind>` and its
    stage-5 bottleneck `stages.4.<kind>`; the gram layers of GA-CSWin
    `gram_layer.<k>.1.<kind>` and of GA-ConvNeXt
    `gram_layer.<k>.blocks.0.<kind>` (stage "gram") and the other head
    leaves by module and parameter (stage "head");
    `layer<s>.<j>.<kind>` and `stem.<j>.<kind>` (ResNet), `layers.<s>.<j>.<kind>`
    (MobileNet), `transformers.<s>.blocks.<j>.<kind>` (PiT) and
    `levels.<s>.blocks.<j>.<kind>` (FasterViT)."""
    for pattern in (r"^stages\.(\d+)\.(?:blocks\.)?\d+\.(.+)$", r"^stage([1-4])\.\d+\.(.+)$",
                    r"^(?:transformers|levels)\.(\d+)\.blocks\.\d+\.(.+)$",
                    r"^stage(5)\.2\.(.+)$", r"^(gram)_layer\.\d+\.(?:blocks\.\d+|1)\.(.+)$",
                    r"^stages\.(4)\.(.+)$",
                    r"^layer([1-4])\.\d+\.(.+)$", r"^(stem)\.\d+\.(.+)$",
                    r"^layers\.([0-4])\.\d+\.(.+)$"):
        m = re.match(pattern, name)
        if m:
            return m.group(1), m.group(2)
    m = re.match(r"^(gram_contraction|gram_embedding|ga|fc)\.\d+\.(.+)$", name)
    return ("head", f"{m.group(1)}.{m.group(2)}") if m else None


def grad_groups(names) -> dict:
    """{(stage, block parameter): parameter names}, by `grad_group`."""
    groups = {}
    for name in names:
        key = grad_group(name)
        if key:
            groups.setdefault(key, []).append(name)
    return dict(sorted(groups.items()))


def compare_grads(kernel, plain, fp32=None, tag: str = "", zero_kinds=(), noisy=(),
                  gates=("apart", "ratio"), zero_by_stage: bool = False) -> dict:
    """The first step's gradients by (stage, block parameter) group: kernel
    path against plain path, and both against the fp32 gradients (if given);
    raises past TRAIN_GRAD_RTOL (gate "apart") or TRAIN_GRAD_ACC (gate
    "ratio"). Groups of `zero_kinds` (a block parameter, or a (stage, block
    parameter) pair) have a true gradient of zero, or one far below the bf16
    paths' rounding noise: they are not gated, but their fp32 gradient must
    be below 1e-3 of the median group's (with `zero_by_stage`, of the median
    gated group's of the same stage: where layer scales make whole stages'
    gradients small, as FasterViT's 1e-5). Groups of the stages in `noisy`
    are held by the "apart" gate only."""
    import torch

    ref = plain if fp32 is None else fp32
    groups = []
    for (s, kind), keys in grad_groups(ref).items():
        cat = lambda g: torch.cat([g[k].float().flatten() for k in keys])
        g = {"stage": s, "kind": kind, "leaves": len(keys), "fp32_norm": cat(ref).norm().item(),
             "kernel_vs_plain": rel_l2(cat(kernel), cat(plain))}
        if fp32 is not None:
            g.update(kernel_vs_fp32=rel_l2(cat(kernel), cat(fp32)),
                     plain_vs_fp32=rel_l2(cat(plain), cat(fp32)))
        groups.append(g)
    cat = lambda g: torch.cat([g[k].float().flatten() for k in ref])
    whole = {"kernel_vs_plain": rel_l2(cat(kernel), cat(plain))}
    if fp32 is not None:
        whole.update(kernel_vs_fp32=rel_l2(cat(kernel), cat(fp32)),
                     plain_vs_fp32=rel_l2(cat(plain), cat(fp32)))
    is_zero = lambda g: g["kind"] in zero_kinds or (g["stage"], g["kind"]) in zero_kinds
    zero = [g for g in groups if is_zero(g)]
    groups_gated = [g for g in groups if not is_zero(g)]
    def median_of(stage=None):
        norms = sorted(g["fp32_norm"] for g in groups_gated if stage in (None, g["stage"]))
        return norms[len(norms) // 2]

    median = median_of()
    if zero:
        scale = {g["stage"]: median_of(g["stage"]) if zero_by_stage else median for g in zero}
        worst = max(zero, key=lambda g: g["fp32_norm"] / scale[g["stage"]])
        log(f"[{tag}train] {len(zero)} groups with a true gradient of (nearly) zero "
            f"({', '.join(map(str, zero_kinds))}) not gated: fp32 norm at most "
            f"{worst['fp32_norm']:.3g} against a median group's {scale[worst['stage']]:.3g}"
            + (f" (stage {worst['stage']})" if zero_by_stage else ""))
        if not all(g["fp32_norm"] <= 1e-3 * scale[g["stage"]] for g in zero):
            raise AssertionError(f"a group taken for zero-gradient is not: {zero}")
    apart = max(groups_gated, key=lambda g: g["kernel_vs_plain"])
    msg = (f"[{tag}train] first step's gradients, {len(groups_gated)} (stage, block parameter) "
           f"groups, L2 relative: kernel vs plain path at most {apart['kernel_vs_plain']:.4g} "
           f"(stage {apart['stage']} {apart['kind']}; tol {TRAIN_GRAD_RTOL}"
           f"{'' if 'apart' in gates else ', not gated'})")
    failed = "apart" in gates and not apart["kernel_vs_plain"] <= TRAIN_GRAD_RTOL
    if fp32 is not None:
        rated = [g for g in groups_gated if g["stage"] not in noisy]
        ratio = max(rated, key=lambda g: g["kernel_vs_fp32"] / g["plain_vs_fp32"])
        worst_ratio = ratio["kernel_vs_fp32"] / ratio["plain_vs_fp32"]
        msg += (f"; distance to fp32 kernel / plain at most {worst_ratio:.4g} (stage "
                f"{ratio['stage']} {ratio['kind']}: {ratio['kernel_vs_fp32']:.4g} / "
                f"{ratio['plain_vs_fp32']:.4g}; tol {TRAIN_GRAD_ACC}"
                f"{'' if 'ratio' in gates else ', not gated'})")
        if noisy:
            held = [g for g in groups_gated if g["stage"] in noisy]
            spread = [g["kernel_vs_fp32"] / g["plain_vs_fp32"] for g in held]
            msg += (f"; stage {', '.join(noisy)} ({len(held)} groups) by the first gate only: "
                    f"kernel / plain {min(spread):.4g}-{max(spread):.4g}")
        failed |= "ratio" in gates and not worst_ratio <= TRAIN_GRAD_ACC
    msg += f"; all {len(ref)} leaves: " + ", ".join(f"{k.replace('_vs_', ' vs ')} {v:.4g}"
                                                   for k, v in whole.items())
    log(msg)
    if failed:
        raise AssertionError(f"the kernel-path gradients disagree with the plain path's: {msg}")
    return {"groups": groups, "all": whole}


def fp32_grads(loss_fn, images, targets):
    """The first step's gradients of the same weights with fp32 compute on
    the plain path."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state, make_train_step

    model = create_model("map_convnext_tiny", dtype=torch.float32, ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    opt = FirstGrads(create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05))
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, loss_fn, dec_lam=-0.8, use_kernel=False)
    torch.manual_seed(SEED + 10)
    step(state, images, targets, torch.Generator(device="cuda").manual_seed(SEED + 10))
    return opt.grads


def train():
    """The train path: six kernel-path steps with launch counts, and one
    plain-path step from a deep copy of the first state, whose loss, grad
    norm and gradients must agree with the kernel path's first step."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd
    from imagenet_models_tpu_torch.train.state import make_train_step

    n_blocks = sum(STAGE_DEPTHS)
    state, opt, loss_fn = make_trainer()
    plain_state = copy.deepcopy(state)
    first = {k: p.detach().clone() for k, p in state.params().items()}
    kernel_opt, plain_opt = FirstGrads(opt), FirstGrads(opt)
    step = make_train_step(state.model, kernel_opt, loss_fn, dec_lam=-0.8, ema_decay=0.9999)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, dec_lam=-0.8,
                                 ema_decay=0.9999, use_kernel=False)
    images, targets = train_batch()
    gen = torch.Generator(device="cuda")

    fused_ln_mlp.launches = fused_ln_mlp_bwd.launches = 0
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        torch.manual_seed(SEED + 10 + i)  # the head's dropout masks
        before = (fused_ln_mlp.launches, fused_ln_mlp_bwd.launches)
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10 + i))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append((fused_ln_mlp.launches - before[0], fused_ln_mlp_bwd.launches - before[1]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"fwd": fused_ln_mlp.launches, "bwd": fused_ln_mlp_bwd.launches}
    log(f"[train] {TRAIN_STEPS} steps of B={TRAIN_BATCH} in {train_s:.2f} s (first includes "
        f"warm-up); (forward, backward) launches per step: {per_step}")
    log("[train] loss per step: " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
        + "; grad_norm per step: " + ", ".join(f"{m['grad_norm']:.6f}" for m in metrics))
    if per_step != [(n_blocks, n_blocks)] * TRAIN_STEPS:
        raise AssertionError(f"expected {n_blocks} forward and {n_blocks} backward kernel "
                             f"launches per step, got {per_step}")
    for m in metrics:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite train metrics: {metrics}")
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"train state counted {state.step} steps")
    ema_moved = max((state.ema_params[k] - first[k]).abs().max().item() for k in first)
    moved = max((p.detach() - first[k]).abs().max().item() for k, p in state.params().items())
    log(f"[train] largest move from the initial weights: params {moved:.4g}, EMA shadow "
        f"{ema_moved:.4g}")
    if not 0.0 < ema_moved < moved:
        raise AssertionError("the EMA shadow did not move, or moved as far as the params")

    torch.manual_seed(SEED + 10)
    plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
    pm = {k: v.item() for k, v in pm.items()}
    loss_rel = abs(metrics[0]["loss"] - pm["loss"]) / abs(pm["loss"])
    gnorm_rel = abs(metrics[0]["grad_norm"] - pm["grad_norm"]) / abs(pm["grad_norm"])
    log(f"[train] first step, kernel vs plain path: loss {metrics[0]['loss']:.6f} vs "
        f"{pm['loss']:.6f} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}); grad_norm "
        f"{metrics[0]['grad_norm']:.6f} vs {pm['grad_norm']:.6f} (rel {gnorm_rel:.3g}, tol "
        f"{TRAIN_GNORM_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    grads = compare_grads(kernel_opt.grads, plain_opt.grads, fp32_grads(loss_fn, images, targets))
    kernel_opt.grads = plain_opt.grads = {}  # free them; later steps record nothing
    torch.cuda.empty_cache()
    check = {"losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
             "plain_loss": pm["loss"], "plain_grad_norm": pm["grad_norm"], "loss_rel": loss_rel,
             "grad_norm_rel": gnorm_rel, "grads_rel": grads, "ema_moved": ema_moved,
             "params_moved": moved}
    return (state, step), (plain_state, plain_step), images, targets, launches, check


def train_throughput(kernel, plain, images, targets, card: str, what: str):
    """Train img/s of both paths in turns (plain, kernel, kernel, plain) after
    TRAIN_WARMUP steps each; `what` names the model and recipe in the log."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    fns = {}
    for name, (st, step) in (("kernel", kernel), ("plain", plain)):
        def run(st=st, step=step):
            step(st, images, targets, gen)
        fns[name] = run
    for fn in fns.values():
        for _ in range(TRAIN_WARMUP):
            fn()
    t = in_turns(fns, TRAIN_ITERS)
    batch = images.shape[0]
    runs = {k: [batch * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[train-throughput] {what} train B={batch} {IMG}px bf16: "
        f"kernel path {result['kernel']:.1f} img/s, plain path {result['plain']:.1f} img/s "
        f"(turns plain,kernel,kernel,plain: {runs['plain'][0]:.1f},{runs['kernel'][0]:.1f},"
        f"{runs['kernel'][1]:.1f},{runs['plain'][1]:.1f}) on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return result, runs


def profile_step(kernel, images, targets, what: str, top: int = 15):
    """torch.profiler over one kernel-path train step: device time by kernel
    name, and the device's idle share of the span from the step's first
    kernel to its last (the profiler slows the host, so this span is longer
    than an unprofiled step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st, step = kernel
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    step(st, images, targets, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(st, images, targets, gen)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    span_ms = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == cuda:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            rows.append({"name": ev.key, "ms": dev_us / 1e3, "count": ev.count})
    rows.sort(key=lambda r: -r["ms"])
    idle = max(0.0, 1 - busy_ms / span_ms)
    # PyTorch's eager elementwise kernels (the fast GELU's chains among them)
    # and the LN+MLP kernels 1 and 2 (the latter's three kernels)
    kinds = {kind: sum(r["ms"] for r in rows if any(k in r["name"] for k in keys))
             for kind, keys in (("elementwise", ("elementwise",)),
                                ("ln_mlp", LN_MLP_KERNEL_NAMES))}
    log(f"[profile] one {what} train step: device span {span_ms:.2f} ms, kernels busy "
        f"{busy_ms:.2f} ms, idle share of the span {idle:.3f}; elementwise kernels "
        f"{kinds['elementwise']:.2f} ms, LN+MLP kernels {kinds['ln_mlp']:.2f} ms")
    for r in rows[:top]:
        log(f"[profile]   {r['ms']:9.3f} ms  x{r['count']:<5d} {r['name'][:110]}")
    return {"span_ms": span_ms, "busy_ms": busy_ms, "idle_share": idle,
            "elementwise_ms": kinds["elementwise"], "ln_mlp_ms": kinds["ln_mlp"],
            "rows": rows[:40]}


def weighted(times, key, weights):
    """One forward's or train step's launches: per-launch times weighted by
    the launches of each stage."""
    return sum(w * r[key] for w, r in zip(weights, times))


# ---------------------------------------------------------------- MaxViT

def attn_args(b, h, w, nh, ps, gen, dtype=None):
    """Inputs of the partition-attention kernels at a (b, h, w) map of nh
    heads of 32: qkv in `dtype` (bf16 unless given) with q scaled by
    32**-0.5 as the model scales it, an fp32 bias of 0.1 N(0, 1), and a
    cotangent in `dtype`."""
    import torch

    c, t = 32 * nh, ps[0] * ps[1]
    qkv = torch.randn(b, h, w, 3 * c, generator=gen, device="cuda")
    qkv[..., :c] *= 32 ** -0.5
    bias = 0.1 * torch.randn(nh, t, t, generator=gen, device="cuda")
    g = torch.randn(b, h, w, c, generator=gen, device="cuda")
    dt = dtype or torch.bfloat16
    return qkv.to(dt), bias, g.to(dt)


def attn_bound_ms(b, h, w, nh, ps, backward: bool) -> tuple:
    """The least time of one partition-attention launch: the larger of its
    products' operations over the bf16 peak and its bytes over the memory
    rate. Forward: q k^T and p v, 4 T^2 d flops per window and head; qkv
    read, out written, the bias read. Backward: the recomputed q k^T, p^T g,
    g v^T, ds k and ds^T q, 10 T^2 d flops; qkv and g read, dqkv written, the
    bias read and dbias written."""
    n, c, t = b * h * w, 32 * nh, ps[0] * ps[1]
    windows = n // t
    flops = (10 if backward else 4) * windows * nh * t * t * 32
    nbytes = (14 if backward else 8) * n * c + (2 if backward else 1) * nh * t * t * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


ATTN_OUTPUTS = ("out", "dqkv", "dbias")


def attn_fp64(args, part, ps, nh):
    """The float64 function of kernels 3 and 4's inputs: out, dqkv and dbias
    with no rounding (p and ds exact, every product and sum in float64)."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa

    qkv, bias, g = args
    h, w = qkv.shape[1:3]
    c, t = qkv.shape[-1] // 3, ps[0] * ps[1]
    rows = pa._windows(qkv, part, ps).double()
    n = rows.shape[0]
    q, k, v = rows.reshape(n, t, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    gh = pa._windows(g, part, ps).double().reshape(n, t, nh, c // nh).transpose(1, 2)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias.double(), dim=-1)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    grads = torch.stack([torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
                         torch.matmul(p.transpose(-1, -2), gh)])  # (3, N, nh, T, d)

    def back(x):  # (N, T, k C) -> (B, H, W, k C)
        return pa._unwindows(x, part, ps, (h, w))

    return (back(torch.matmul(p, v).transpose(1, 2).reshape(n, t, c)),
            back(grads.permute(1, 3, 0, 2, 4).reshape(n, t, 3 * c)), ds.sum(dim=0))


def compare_attention(args, part, ps, nh, tag) -> dict:
    """Kernels 3 and 4 against their twins on the same inputs, every output
    (out; dqkv, dbias), and a second launch of each against the first; with
    a bf16 map each output also against the float64 function of the inputs
    (`attn_fp64`), no farther from it than FLASH_FP64_RATIO times the twin;
    raises past KERNEL_RTOL or the ratio, or if an output differs in a bit
    between the two runs."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa

    qkv, bias, g = args

    def kernels():
        return (pa.fused_partition_attention(qkv, bias, part, ps, nh),
                *pa.fused_partition_attention_bwd(qkv, bias, g, part, ps, nh))

    got, again = kernels(), kernels()
    ref = (pa.plain_partition_attention(qkv, bias, part, ps, nh),
           *pa.plain_partition_attention_bwd(qkv, bias, g, part, ps, nh))
    exact = attn_fp64(args, part, ps, nh) if qkv.dtype == torch.bfloat16 else None
    torch.cuda.synchronize()
    ratios, errs, fp64 = {}, {}, {}
    for i, k in enumerate(ATTN_OUTPUTS):
        o, r = got[i], ref[i]
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"partition attention {k} {tag}: {tuple(o.shape)} "
                                 f"{o.dtype}, twin {tuple(r.shape)} {r.dtype}")
        if not torch.isfinite(o.float()).all():
            raise AssertionError(f"partition attention {k} {tag} is not finite")
        ratios[k] = rel_err(o, r)
        errs[k] = (o.float() - r.float()).abs().max().item()
        if exact is not None:
            fp64[k] = ((o.double() - exact[i]).abs().max().item(),
                       (r.double() - exact[i]).abs().max().item())
    del exact
    same = {k: torch.equal(a, b) for k, a, b in zip(ATTN_OUTPUTS, got, again)}
    log(f"[kernels] partition_attn[{part}] {tag}: max|kernel-twin|/max|twin| "
        + " ".join(f"{k}={v:.3g}" for k, v in ratios.items()) + f" (tol {KERNEL_RTOL})"
        + ("; max|err| vs float64, kernel/twin " + " ".join(
            f"{k}={a:.3g}/{b:.3g}" for k, (a, b) in fp64.items())
           + f" (limit {FLASH_FP64_RATIO}x)" if fp64 else "")
        + "; bit-equal across runs: " + ("all" if all(same.values()) else str(same)))
    bad = [k for k, v in ratios.items() if not v <= KERNEL_RTOL]
    far = [k for k, (a, b) in fp64.items() if not a <= FLASH_FP64_RATIO * b]
    moved = [k for k, v in same.items() if not v]
    if bad or far or moved:
        raise AssertionError(f"partition attention kernels {tag} [{part}]: disagree with their "
                             f"twins in {bad}, farther from float64 than {FLASH_FP64_RATIO}x the "
                             f"twin in {far} ({fp64}), or moved between runs in {moved}")
    return {"tag": tag, "part": part, "dtype": str(qkv.dtype), "ratios": ratios,
            "max_abs_err": errs, "fp64_err": {k: v[0] for k, v in fp64.items()},
            "twin_fp64_err": {k: v[1] for k, v in fp64.items()}}


def k34_digest(fwd, bwd) -> str:
    """The SHA-256 of kernels 3 and 4's fp32 outputs (out, dqkv, dbias: their
    bits) at fixed inputs made with numpy: block and grid windows of 49
    tokens (B=4, 28 x 28, 4 heads), 144 (B=1, 24 x 24, 2 heads) and 256
    (B=1, 32 x 32, 2 heads), and 4 x 5 windows of an odd batch on a
    non-square map (B=3, 12 x 15, 2 heads). `fwd(qkv, bias, part, ps, nh)`
    and `bwd(qkv, bias, g, part, ps, nh)` launch a build of each."""
    import hashlib

    import numpy as np
    import torch

    digest = hashlib.sha256()
    rng = np.random.default_rng(3434)
    draw = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    for b, h, w, nh, ps in ((4, 28, 28, 4, (7, 7)), (1, 24, 24, 2, (12, 12)),
                            (1, 32, 32, 2, (16, 16)), (3, 12, 15, 2, (4, 5))):
        c, t = 32 * nh, ps[0] * ps[1]
        qkv, bias, g = draw(b, h, w, 3 * c), 0.1 * draw(nh, t, t), draw(b, h, w, c)
        qkv[..., :c] *= 32 ** -0.5
        for part in ("block", "grid"):
            outs = (fwd(qkv, bias, part, ps, nh), *bwd(qkv, bias, g, part, ps, nh))
            torch.cuda.synchronize()
            for o in outs:
                digest.update(o.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return digest.hexdigest()


def k1011_digest(fwd, bwd) -> str:
    """The SHA-256 of kernels 10 and 11's fp32 outputs (out and the ten
    gradients: their bits) at fixed inputs made with numpy: a (2, 14, 14, 96)
    map, an odd batch on a non-square one (3, 9, 12, 64) and (1, 7, 7, 688),
    a ragged channel width, each with hidden 4C. `fwd(x, params)` and
    `bwd(x, g, params)` launch a build of each."""
    import hashlib

    import numpy as np
    import torch

    digest = hashlib.sha256()
    rng = np.random.default_rng(1011)
    draw = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).cuda()
    for b, h, w, c in ((2, 14, 14, 96), (3, 9, 12, 64), (1, 7, 7, 688)):
        x, g = draw(b, h, w, c), draw(b, h, w, c)
        params = [draw(c, 1, 7, 7, s=0.1), draw(c, s=0.1), 1.0 + draw(c, s=0.1), draw(c, s=0.1),
                  draw(4 * c, c, s=c ** -0.5), draw(4 * c, s=0.1), draw(c, 4 * c, s=(4 * c) ** -0.5),
                  draw(c, s=0.1), draw(c)]
        outs = (fwd(x, params), *bwd(x, g, params))
        torch.cuda.synchronize()
        for o in outs:
            digest.update(o.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return digest.hexdigest()


def check_attention_code(builds) -> dict:
    """Kernels 3 and 4's code reports, with the registers and spills of each
    instance: every bf16 instance of kernel 4 (16, on the tensor cores) must
    hold mma.sync (HMMA) instructions in its SASS, where cuobjdump could read
    it; kernel 3's instances run on the CUDA cores (its bf16 instances keep
    the first design's arithmetic, and so its bits), and hold none."""
    codes = {name: code_report(builds[name], name)
             for name in ("partition_attn_fwd", "partition_attn_bwd")}
    mma = {k: v.get("HMMA", 0) for k, v in codes["partition_attn_bwd"]["sass"].items()
           if "_mma" in k}
    log(f"[code] partition_attn_bwd: HMMA in each of its {len(mma)} bf16 instances: "
        + ", ".join(f"{v}" for v in mma.values()))
    if codes["partition_attn_bwd"]["sass"] and not (len(mma) == 16 and all(mma.values())):
        raise AssertionError(f"kernel 4's 16 bf16 instances do not all hold mma instructions: {mma}")
    return codes


def library_fns(args, part, ps, nh):
    """The yardsticks: F.scaled_dot_product_attention with the bias as a
    float attn_mask, on windows partitioned beforehand, and the autograd
    backward of that call (dq, dk, dv; the mask gets no gradient); and the
    partition copies each needs, timed apart: qkv into q, k, v windows and
    the output back (forward); g into windows and dq, dk, dv back (backward)."""
    import torch
    import torch.nn.functional as F

    from imagenet_models_tpu_torch.ops.partition_attention import _unwindows, _windows

    qkv, bias, g = args
    b, h, w, c3 = qkv.shape
    t = ps[0] * ps[1]

    def split(x):  # (B, H, W, k*C) -> k tensors (N, nh, T, d), contiguous
        rows = _windows(x, part, ps)
        k = rows.shape[-1] // (32 * nh)
        return rows.reshape(rows.shape[0], t, k, nh, 32).permute(2, 0, 3, 1, 4).contiguous().unbind(0)

    def merge(*hs):  # k tensors (N, nh, T, d) -> (B, H, W, k*C)
        rows = torch.stack(hs, 2).permute(0, 3, 2, 1, 4).reshape(hs[0].shape[0], t, -1)
        return _unwindows(rows, part, ps, (h, w))

    q, k, v = split(qkv)
    (gw,) = split(g)
    mask = bias.to(qkv.dtype)[None]
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    graph = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=1.0)
    return {
        "fwd": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0),
        "fwd_copies": lambda: (split(qkv), merge(out)),
        "bwd": lambda: torch.autograd.grad(graph, leaves, gw, retain_graph=True),
        "bwd_copies": lambda: (split(g), merge(q, k, v)),
    }


def attn_stage_times(args, side: int, c: int, nh: int, ps, kinds=("fwd", "bwd")) -> dict:
    """Kernels 3 and 4 (`kinds`) per launch at one stage's shape, block and
    grid, in turns with the twin (twin, kernel, kernel, twin), with the
    device time by the profiler, the bound and the library call (SDPA on
    windows partitioned beforehand; the copies timed apart); returns {kind:
    the mean of the block and the grid launch, with the rows}."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa

    qkv, bias, g = args
    b = qkv.shape[0]
    iters = max(5, min(50, 4_000_000 // (b * side * side)))
    stage = {which: [] for which in kinds}
    for part in ("block", "grid"):
        lib = library_fns(args, part, ps, nh)
        fns = {"fwd": (lambda: pa.fused_partition_attention(qkv, bias, part, ps, nh),
                       lambda: pa.plain_partition_attention(qkv, bias, part, ps, nh)),
               "bwd": (lambda: pa.fused_partition_attention_bwd(qkv, bias, g, part, ps, nh),
                       lambda: pa.plain_partition_attention_bwd(qkv, bias, g, part, ps, nh))}
        for which in kinds:
            kern, plain = fns[which]
            with torch.inference_mode(which == "fwd"):
                t = in_turns({"kernel": kern, "plain": plain}, iters)
                device = device_ms_by_kernel(kern, calls=10, per_launch=True)
            bound, by = attn_bound_ms(b, side, side, nh, ps, which == "bwd")
            row = {"side": side, "c": c, "heads": nh, "part": part, "batch": b,
                   "window": list(ps), "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
                   "device_ms": sum(v for k, v in device.items()
                                    if k.startswith("partition_attn")),
                   "library_ms": cuda_ms(lib[which], iters),
                   "copies_ms": cuda_ms(lib[which + "_copies"], iters),
                   "bound_ms": bound, "bound_by": by, "turns": t}
            stage[which].append(row)
            log(f"[kernels] partition_attn_{which}[{part}] B={b} {side}x{side} C={c} "
                f"T={ps[0] * ps[1]}: kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f} ms "
                f"by the profiler), twin {row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}), "
                f"SDPA {row['library_ms']:.4f} ms + partition copies {row['copies_ms']:.4f} ms "
                f"(twin,kernel,kernel,twin: {t['plain'][0]:.4f},{t['kernel'][0]:.4f},"
                f"{t['kernel'][1]:.4f},{t['plain'][1]:.4f})")
        del lib
    # block and grid: one launch of each per block
    return {which: {**{k: sum(r[k] for r in rows) / 2
                       for k in ("ms", "device_ms", "plain_ms", "library_ms", "copies_ms",
                                 "bound_ms")},
                    "bound_by": rows[0]["bound_by"], "rows": rows}
            for which, rows in stage.items()}


def check_attention(card: str, builds):
    """Kernels 3 and 4 against their twins (and in bf16 against float64) at
    the three B=128 stage shapes of the train step (block and grid), at T =
    144 and 256 (the 384 and 512 px models), on non-square maps and an odd
    batch; the fp32 instances' bits (`k34_digest`) and both libraries' code
    (`check_attention_code`); per launch at the B=128 shapes, in turns
    (twin, kernel, kernel, twin), with the bound, the device time by the
    profiler and the library call; kernel 3 beside the eval route's
    composition at the B=256 stage shapes."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for b, h, w, nh, ps in ATTN_EXTRA_SHAPES:
        args = attn_args(b, h, w, nh, ps, gen)
        for part in ("block", "grid"):
            rows.append(compare_attention(args, part, ps, nh, f"B={b} {h}x{w} T={ps[0] * ps[1]} "
                                                               f"heads={nh}"))
    digest = k34_digest(pa.fused_partition_attention, pa.fused_partition_attention_bwd)
    log(f"[kernels] kernels 3 and 4's fp32 bits at k34_digest's inputs: {digest}; the CUDA-core "
        f"build's: {K34_FP32_DIGEST}")
    if digest != K34_FP32_DIGEST:
        raise AssertionError("kernels 3 and 4's fp32 instances no longer give their CUDA-core "
                             "build's bits")
    code = check_attention_code(builds)
    times = {"fwd": [], "bwd": []}
    for side, c, nh in MAXVIT_STAGES:
        args = attn_args(TRAIN_BATCH, side, side, nh, PS, gen)
        for part in ("block", "grid"):
            rows.append(compare_attention(args, part, PS, nh, f"B={TRAIN_BATCH} {side}x{side} "
                                                              f"C={c}"))
        for which, row in attn_stage_times(args, side, c, nh, PS).items():
            times[which].append(row)
        del args
    for which, what in (("fwd", "kernel 3"), ("bwd", "kernel 4")):
        log(f"[kernels] {what} per {MAXVIT} train step, B={TRAIN_BATCH}: " + ", ".join(
            f"{key} {weighted(times[which], key, MAXVIT_STAGE_LAUNCHES):.4f}"
            for key in ("ms", "device_ms", "bound_ms", "plain_ms", "library_ms", "copies_ms"))
            + f" on {card}")
    # the eval route: partition -> composition -> reverse, against kernel 3
    evals = []
    with torch.inference_mode():
        for side, c, nh in MAXVIT_STAGES:
            qkv, bias, _ = attn_args(BENCH_BATCH, side, side, nh, PS, gen)
            for part in ("block", "grid"):
                cut, back = ((wa.window_partition, wa.window_reverse) if part == "block"
                             else (wa.grid_partition, wa.grid_reverse))
                comp = lambda: back(wa.slice_attention(cut(qkv, PS), bias, nh), PS, (side, side))
                t = in_turns({"kernel": lambda: pa.fused_partition_attention(qkv, bias, part,
                                                                             PS, nh),
                              "plain": comp}, 10)
                row = {"side": side, "c": c, "part": part, "kernel_ms": sum(t["kernel"]) / 2,
                       "composition_ms": sum(t["plain"]) / 2, "turns": t}
                evals.append(row)
                log(f"[kernels] eval B={BENCH_BATCH} {side}x{side} C={c} [{part}]: kernel 3 "
                    f"{row['kernel_ms']:.4f} ms, composition (partition, attention, reverse) "
                    f"{row['composition_ms']:.4f} ms (composition,kernel,kernel,composition: "
                    f"{t['plain'][0]:.4f},{t['kernel'][0]:.4f},{t['kernel'][1]:.4f},"
                    f"{t['plain'][1]:.4f}) on {card}")
            del qkv, bias
    return rows, times, evals, {"fp32_digest": digest, "code": code}


def serve_maxvit(card: str):
    """The serving path of map_maxvit_tiny_tf_224: eval takes the composition
    (the gate), so kernels 3 and 4 are not launched; the logits are held to
    the plain path's and, loosely, to an fp32 model's with the same weights;
    one eval step; eval img/s at B=256 in two runs."""
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.serving import make_serving_fn
    from imagenet_models_tpu_torch.train.state import make_eval_step

    t0 = time.perf_counter()
    model = create_model(MAXVIT, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    if not next(model.parameters()).is_cuda:
        raise AssertionError("create_model did not build on the GPU by default")
    log(f"[serving] {MAXVIT} built: {sum(p.numel() for p in model.parameters())} params, bf16 "
        f"compute, {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    requests = [torch.randint(0, 256, (REQUEST_BATCH, IMG, IMG, 3), generator=gen,
                              device="cuda", dtype=torch.uint8) for _ in range(REQUESTS)]
    serve_fn = make_serving_fn(model)
    pa.fused_partition_attention.launches = pa.fused_partition_attention_bwd.launches = 0
    t0 = time.perf_counter()
    outputs = [serve_fn(images) for images in requests]
    torch.cuda.synchronize()
    launches = pa.fused_partition_attention.launches + pa.fused_partition_attention_bwd.launches
    log(f"[serving] {REQUESTS} requests of {REQUEST_BATCH} in {time.perf_counter() - t0:.3f} s "
        f"(first includes warm-up); partition-attention launches: {launches} (eval takes the "
        f"composition)")
    if launches:
        raise AssertionError("the eval forward launched the partition-attention kernels")
    for logits in outputs:
        if logits.shape != (REQUEST_BATCH, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"malformed logits {tuple(logits.shape)}")
    plain = make_serving_fn(model, use_kernel=False)(requests[0])
    scale = plain.abs().max().item()
    err = (outputs[0] - plain).abs().max().item()
    fp32 = create_model(MAXVIT, generator=torch.Generator().manual_seed(SEED))
    ref = make_serving_fn(fp32)(requests[0])
    del fp32
    err32 = (outputs[0] - ref).abs().max().item() / ref.abs().max().item()
    agree = (outputs[0].argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[serving] logits vs the plain path: max|diff| {err:.4g} (tol {LOGITS_RTOL * scale:.4g}); "
        f"vs an fp32 model with the same weights: max|diff|/max|fp32| {err32:.4g} (tol "
        f"{MAXVIT_FP32_RTOL}), top-1 agreement {agree:.3f}")
    if not (err <= LOGITS_RTOL * scale and err32 <= MAXVIT_FP32_RTOL):
        raise AssertionError("MaxViT serving logits disagree with the plain path or fp32")
    step = make_eval_step(model)
    cfg = default_cfg(MAXVIT)
    mean, std = (torch.tensor(cfg[k], device="cuda") for k in ("mean", "std"))
    x = (requests[1].float() / 255.0 - mean) / std
    targets = torch.randint(0, 1000, (REQUEST_BATCH,), generator=gen, device="cuda")
    logits, top1, top5 = step(x, targets)
    if not (logits - outputs[1]).abs().max().item() <= 1e-3 * scale:
        raise AssertionError("eval step logits differ from the serving logits on the same images")
    if not (top1 <= top5).all() or top1.shape != (REQUEST_BATCH,):
        raise AssertionError("eval step top-1/top-5 flags are malformed")
    x = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    with torch.inference_mode():
        runs = [BENCH_BATCH * 1000.0 / cuda_ms(lambda: model(x), BENCH_ITERS) for _ in range(2)]
    log(f"[throughput] {MAXVIT} eval B={BENCH_BATCH} {IMG}px bf16: {sum(runs) / 2:.1f} img/s "
        f"(runs {runs[0]:.1f}, {runs[1]:.1f}; kernel and plain path are one route at eval) "
        f"on {card}")
    return {"max_abs_err": err, "max_abs_plain": scale, "fp32_rel": err32, "fp32_top1": agree,
            "eval_img_s": sum(runs) / 2, "eval_img_s_runs": runs}


def maxvit_trainer(dtype):
    """The maxvit_tiny recipe (train_with_script.py:24) on a fresh full-width
    map_maxvit_tiny_tf_224: timm LAMB lr 8e-3 wd 0.05 clip 1.0 by norm, BCE
    with smoothing 0.1 on dense (mixup) targets, drop-path 0.2, no EMA."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state

    model = create_model(MAXVIT, dtype=dtype, drop_path_rate=MAXVIT_DROP_PATH,
                         generator=torch.Generator().manual_seed(SEED))
    opt = FirstGrads(create_optimizer("lamb", **MAXVIT_RECIPE))
    return create_train_state(model, opt), opt, create_loss_fn(bce_loss=True, smoothing=0.1,
                                                               mixup_active=True)


def counter_launches(counters):
    """The launch counts of (kernel wrapper, launches per step) pairs."""
    return tuple(c.launches for c, _ in counters)


def check_step_launches(counters, per_step, tag: str) -> dict:
    """Raises unless every step launched each wrapper of `counters` its
    expected number of times; returns the totals by wrapper name."""
    expected = tuple(n for _, n in counters)
    names = ", ".join(c.__name__ for c, _ in counters)
    log(f"[{tag}train] ({names}) launches per step: {per_step}")
    if any(tuple(s) != expected for s in per_step):
        raise AssertionError(f"expected {expected} launches of ({names}) per step, got {per_step}")
    return {c.__name__: c.launches for c, _ in counters}


def train_maxvit(counters=None, steps: int = TRAIN_STEPS, tag: str = "maxvit-",
                 gates=("apart", "ratio")):
    """`steps` kernel-path steps of the MaxViT recipe with launch counts (of
    `counters`, (kernel wrapper, launches per step) pairs; by default kernels
    3 and 4), and one plain-path step from a deep copy of the first state
    (same drop-path and dropout draws), whose loss, grad norm and gradients
    must agree with the kernel path's first step and an fp32 model's
    (`compare_grads` by `gates`)."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.train.state import make_train_step

    if counters is None:
        counters = ((pa.fused_partition_attention, MAXVIT_LAUNCHES),
                    (pa.fused_partition_attention_bwd, MAXVIT_LAUNCHES))

    state, kernel_opt, loss_fn = maxvit_trainer(torch.bfloat16)
    plain_state = copy.deepcopy(state)
    plain_opt = FirstGrads(kernel_opt.opt)
    step = make_train_step(state.model, kernel_opt, loss_fn, dec_lam=-0.8)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, dec_lam=-0.8,
                                 use_kernel=False)
    images, targets = train_batch()
    gen = torch.Generator(device="cuda")

    for c, _ in counters:
        c.launches = 0
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        torch.manual_seed(SEED + 10 + i)  # the head's dropout masks
        before = counter_launches(counters)
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10 + i))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append([a - b for a, b in zip(counter_launches(counters), before)])
    torch.cuda.synchronize()
    log(f"[{tag}train] {steps} steps of B={TRAIN_BATCH} in {time.perf_counter() - t0:.2f} s "
        f"(first includes warm-up)")
    launches = check_step_launches(counters, per_step, tag)
    log(f"[{tag}train] loss per step: " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
        + "; grad_norm per step: " + ", ".join(f"{m['grad_norm']:.6f}" for m in metrics))
    for m in metrics:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite train metrics: {metrics}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError(f"the loss did not fall over {steps} steps on a fixed batch")

    torch.manual_seed(SEED + 10)
    plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
    pm = {k: v.item() for k, v in pm.items()}
    loss_rel = abs(metrics[0]["loss"] - pm["loss"]) / abs(pm["loss"])
    gnorm_rel = abs(metrics[0]["grad_norm"] - pm["grad_norm"]) / abs(pm["grad_norm"])
    log(f"[{tag}train] first step, kernel vs plain path: loss {metrics[0]['loss']:.6f} vs "
        f"{pm['loss']:.6f} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}); grad_norm "
        f"{metrics[0]['grad_norm']:.6f} vs {pm['grad_norm']:.6f} (rel {gnorm_rel:.3g}, tol "
        f"{TRAIN_GNORM_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    fp32_state, fp32_opt, _ = maxvit_trainer(torch.float32)
    fp32_step = make_train_step(fp32_state.model, fp32_opt, loss_fn, dec_lam=-0.8,
                                use_kernel=False)
    torch.manual_seed(SEED + 10)
    fp32_step(fp32_state, images, targets, gen.manual_seed(SEED + 10))
    del fp32_state
    grads = compare_grads(kernel_opt.grads, plain_opt.grads, fp32_opt.grads, tag,
                          MAXVIT_ZERO_GRAD, gates=gates)
    kernel_opt.grads = plain_opt.grads = fp32_opt.grads = {}
    torch.cuda.empty_cache()
    check = {"losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
             "plain_loss": pm["loss"], "plain_grad_norm": pm["grad_norm"], "loss_rel": loss_rel,
             "grad_norm_rel": gnorm_rel, "grads_rel": grads}
    return (state, step), (plain_state, plain_step), images, targets, launches, check


# ---------------------------------------------------------------- GA-CSWin

def stripe_args(b, h, w, c, gen, dtype=None):
    """Inputs of the stripe kernels at a (b, h, w) map of c channels, laid out
    as the model gives them: q, k, v as channel slices of a (b, h, w, 6c) qkv
    map in `dtype` (bf16 unless given; the first half-channel branch of a
    block of 2c channels), taps 0.2 N(0, 1), bias 0.1 N(0, 1), and the
    cotangent as a channel slice of a (b, h, w, 2c) map (the gradient of the
    two branches' concat)."""
    import torch

    dt = dtype or torch.bfloat16
    qkv = torch.randn(b, h, w, 6 * c, generator=gen, device="cuda").to(dt)
    w9 = 0.2 * torch.randn(9, c, generator=gen, device="cuda")
    wb = 0.1 * torch.randn(1, c, generator=gen, device="cuda")
    g = torch.randn(b, h, w, 2 * c, generator=gen, device="cuda").to(dt)
    return qkv[..., :c], qkv[..., 2 * c:3 * c], qkv[..., 4 * c:5 * c], w9, wb, g[..., :c]


def stripe_bound_ms(b, h, w, c, nh, ws, backward: bool) -> tuple:
    """The least time of one stripe-attention launch: the larger of its
    operations over the bf16 peak and its bytes over the memory rate. Per
    stripe of T = h*ws tokens and head of d channels: forward q k^T and p v,
    4 T^2 d flops, and 18 per output for LePE; q, k, v read, out written, w9
    and wb read. Backward: the recomputed q k^T, p^T g, g v^T, ds k and
    ds^T q, 10 T^2 d flops, 36 per output for the stencil and its weight
    gradient; q, k, v, g read, dq, dk, dv written, w9 read, dw9 and dwb
    written."""
    n, t, d = b * h * w, h * ws, c // nh
    stripes = b * (w // ws)
    flops = (10 if backward else 4) * stripes * nh * t * t * d + (36 if backward else 18) * n * c
    nbytes = (14 if backward else 8) * n * c + (20 if backward else 10) * c * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


STRIPE_OUTPUTS = ("out", "dq", "dk", "dv", "dw9", "dwb")


def stripe_fp64(args, ws, nh):
    """The float64 function of the stripe kernels' inputs: out, dq, dk, dv,
    dw9, dwb with q times the scale rounded to the operand type (the
    function the JAX kernel defines), and no other rounding: p and ds exact,
    every product and sum in float64."""
    import torch
    import torch.nn.functional as F

    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    q, k, v, w9, wb, g = args
    b, h, w, c = q.shape
    t, d = h * ws, c // nh
    scale = d ** -0.5

    def heads(x):  # (B, H, W, C) -> float64 (N, nh, T, d)
        rows = sa._stripes(x, ws).double()
        return rows.reshape(rows.shape[0], t, nh, d).transpose(1, 2)

    def back(x):  # (N, nh, T, d) -> (B, H, W, C)
        return sa._unstripes(x.transpose(1, 2).reshape(x.shape[0], t, c), b, h, w, ws)

    def images(x):
        return sa._stripe_images(x, ws).double()

    qs, kh, vh, gh = heads(sa._scaled(q, scale)), heads(k), heads(v), heads(g)
    taps = w9.double().t().reshape(c, 1, 3, 3)
    p = torch.softmax(torch.matmul(qs, kh.transpose(-1, -2)), dim=-1)
    lepe = F.conv2d(images(v), taps, padding=1, groups=c) + wb.double().reshape(1, c, 1, 1)
    out = back(torch.matmul(p, vh)) + sa._unstripes(
        lepe.permute(0, 2, 3, 1).reshape(-1, t, c), b, h, w, ws)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    gi, vi = images(g), images(v)
    dv_lepe = F.conv2d(gi, taps.flip(-1, -2), padding=1, groups=c).permute(0, 2, 3, 1)
    dv = back(torch.matmul(p.transpose(-1, -2), gh)) + sa._unstripes(
        dv_lepe.reshape(-1, t, c), b, h, w, ws)
    vp = F.pad(vi, (1, 1, 1, 1))
    dw9 = torch.stack([(vp[:, :, i:i + h, j:j + ws] * gi).sum(dim=(0, 2, 3))
                       for i in range(3) for j in range(3)])
    return (out, back(torch.matmul(ds, kh) * scale), back(torch.matmul(ds.transpose(-1, -2), qs)),
            dv, dw9, gi.sum(dim=(0, 2, 3)).reshape(1, c))


def compare_stripe(args, ws, nh, tag) -> dict:
    """Kernels 5 and 6 against their twins on the same inputs, every output
    (out; dq, dk, dv, dw9, dwb); each bf16 output also against the float64
    function of the inputs (`stripe_fp64`), no farther from it than
    FLASH_FP64_RATIO times the twin; raises past KERNEL_RTOL or the ratio, if
    any output of either kernel differs in a bit between two runs, or if a
    dy != 0 tap of ws = 1 (no source in the stripe) is not exactly 0."""
    import torch

    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    q, k, v, w9, wb, g = args
    scale = (q.shape[-1] // nh) ** -0.5
    got = (sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale),
           *sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale))
    again = (sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale),
             *sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale))
    ref = (sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale),
           *sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=ws, nh=nh, scale=scale))
    exact = stripe_fp64(args, ws, nh)
    torch.cuda.synchronize()
    ratios, errs, fp64, fp64_ratio = {}, {}, {}, {}
    for name, o, r, x in zip(STRIPE_OUTPUTS, got, ref, exact):
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"stripe attention {name} {tag}: {tuple(o.shape)} {o.dtype}, "
                                 f"twin {tuple(r.shape)} {r.dtype}")
        if not torch.isfinite(o.float()).all():
            raise AssertionError(f"stripe attention {name} {tag} is not finite")
        ratios[name] = rel_err(o, r)
        errs[name] = (o.float() - r.float()).abs().max().item()
        fp64[name] = ((o.double() - x).abs().max().item(), (r.double() - x).abs().max().item())
        fp64_ratio[name] = fp64[name][0] / max(fp64[name][1], 1e-30)
    del exact
    same = {name: torch.equal(a, b) for name, a, b in zip(STRIPE_OUTPUTS, got, again)}
    bf16 = [n for n, o in zip(STRIPE_OUTPUTS, got) if o.dtype == torch.bfloat16]
    log(f"[kernels] stripe_attn {tag}: max|kernel-twin|/max|twin| "
        + " ".join(f"{k}={v:.3g}" for k, v in ratios.items())
        + f" (tol {KERNEL_RTOL}); max|err| vs float64, kernel/twin "
        + " ".join(f"{k}={fp64[k][0]:.3g}/{fp64[k][1]:.3g}" for k in STRIPE_OUTPUTS)
        + f" (bf16 outputs' limit {FLASH_FP64_RATIO}x); bit-equal across runs: "
        + ("all" if all(same.values()) else str(same)))
    bad = [k for k, v in ratios.items() if not v <= KERNEL_RTOL]
    far = [k for k in bf16 if not fp64_ratio[k] <= FLASH_FP64_RATIO]
    moved = [k for k, v in same.items() if not v]
    if ws == 1 and got[4][[0, 2, 3, 5, 6, 8]].any():  # taps with no source: exactly 0
        raise AssertionError(f"stripe attention {tag}: dw9's dy != 0 taps of ws = 1 are not 0")
    if bad or far or moved:
        raise AssertionError(f"stripe attention kernels {tag}: disagree with their twins in {bad}, "
                             f"farther from float64 than {FLASH_FP64_RATIO}x the twin in {far} "
                             f"({fp64_ratio}), or moved between runs in {moved}")
    return {"tag": tag, "ratios": ratios, "max_abs_err": errs,
            "fp64_err": {k: v[0] for k, v in fp64.items()},
            "twin_fp64_err": {k: v[1] for k, v in fp64.items()}}


def stripe_library_fns(args, ws, nh):
    """The yardstick: two PyTorch calls, F.scaled_dot_product_attention on
    stripes partitioned beforehand and the LePE as a cuDNN depthwise
    F.conv2d on the partitioned v (forward), and the autograd backward of
    both (dq, dk, dv, and the conv's input and weight gradients); and the
    partition copies they need, timed apart: q, k, v into stripes and heads,
    v into stripe images, the output back (forward); g into stripes, heads
    and images, dq, dk, dv back (backward)."""
    import torch
    import torch.nn.functional as F

    from imagenet_models_tpu_torch.ops.stripe_attention import _stripe_images, _stripes, _unstripes

    q, k, v, w9, wb, g = args
    b, h, w, c = q.shape
    t = h * ws
    scale = (c // nh) ** -0.5
    weight = w9.t().reshape(c, 1, 3, 3).to(q.dtype).contiguous()
    bias = wb.reshape(c).to(q.dtype)

    def heads(x):  # (B, H, W, C) -> (N, nh, T, d), contiguous
        rows = _stripes(x, ws)
        return rows.reshape(rows.shape[0], t, nh, -1).transpose(1, 2).contiguous()

    def images(x):
        return _stripe_images(x, ws).to(x.dtype).contiguous()

    def back(o):  # (N, nh, T, d) -> (B, H, W, C)
        return _unstripes(o.transpose(1, 2).reshape(o.shape[0], t, c), b, h, w, ws)

    qh, kh, vh, vi, gh, gi = heads(q), heads(k), heads(v), images(v), heads(g), images(g)
    out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh, vi)]
    wleaf = weight.detach().requires_grad_()
    graph = (F.scaled_dot_product_attention(*leaves[:3], scale=scale),
             F.conv2d(leaves[3], wleaf, bias, padding=1, groups=c))
    return {
        "fwd": lambda: (F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
                        F.conv2d(vi, weight, bias, padding=1, groups=c)),
        "fwd_copies": lambda: (heads(q), heads(k), heads(v), images(v), back(out)),
        "bwd": lambda: torch.autograd.grad(graph, leaves + [wleaf], (gh, gi), retain_graph=True),
        "bwd_copies": lambda: (heads(g), images(g), back(qh), back(kh), back(vh)),
    }


def gate_composition(args, ws, nh, card, tag) -> dict:
    """Kernel 5 (with kernel 6 for the backward) against the route the gate
    gives an idx=0 branch taller than IMTPU_STRIPE_MAXH: the composition of
    `LePEAttention` (partition, bf16 scores, the LePE conv in bf16, reverse),
    with the same taps, forward and forward + backward, in turns."""
    import torch

    from imagenet_models_tpu_torch.ops.cswin_attention import LePEAttention
    from imagenet_models_tpu_torch.ops.stripe_attention import stripe_attention

    q, k, v, w9, wb, g = args
    c = q.shape[-1]
    attn = LePEAttention(c, nh, 0, ws, dtype=torch.bfloat16).cuda().train()
    with torch.no_grad():
        attn.get_v.weight.copy_(w9.t().reshape(c, 1, 3, 3))
        attn.get_v.bias.copy_(wb.reshape(c))
    scale = (c // nh) ** -0.5
    fns = {"kernel": lambda *a: stripe_attention(*a, w9, wb, ws=ws, num_heads=nh, scale=scale),
           "plain": lambda *a: attn(*a)}
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def both(f):
        return lambda: torch.autograd.grad(f(*leaves), leaves, g)

    with torch.inference_mode():
        fwd = in_turns({n: (lambda f=f: f(q, k, v)) for n, f in fns.items()}, 10)
    fb = in_turns({n: both(f) for n, f in fns.items()}, 10)
    row = {"tag": tag, "kernel_fwd_ms": sum(fwd["kernel"]) / 2,
           "composition_fwd_ms": sum(fwd["plain"]) / 2,
           "kernel_fwd_bwd_ms": sum(fb["kernel"]) / 2,
           "composition_fwd_bwd_ms": sum(fb["plain"]) / 2, "turns": {"fwd": fwd, "fwd_bwd": fb}}
    log(f"[kernels] gate {tag}: forward kernel 5 {row['kernel_fwd_ms']:.4f} ms vs composition "
        f"{row['composition_fwd_ms']:.4f} ms; forward+backward kernels 5+6 "
        f"{row['kernel_fwd_bwd_ms']:.4f} ms vs composition {row['composition_fwd_bwd_ms']:.4f} ms "
        f"(composition,kernel,kernel,composition fwd: {fwd['plain'][0]:.4f},{fwd['kernel'][0]:.4f},"
        f"{fwd['kernel'][1]:.4f},{fwd['plain'][1]:.4f}) on {card}")
    return row


def check_stripe_code(builds) -> dict:
    """Kernels 5 and 6's code reports: every bf16 (tensor-core) instance's
    SASS must hold mma.sync (HMMA) instructions, where cuobjdump could read
    it; logs the registers and spills of each instance."""
    codes = {}
    for name in ("stripe_attn_fwd", "stripe_attn_bwd"):
        code = codes[name] = code_report(builds[name], name)
        mma = {k: v.get("HMMA", 0) for k, v in code["sass"].items() if "_mma" in k}
        log(f"[code] {name}: HMMA in each of its {len(mma)} bf16 instances: "
            + ", ".join(f"{v}" for v in mma.values()))
        if code["sass"] and not (mma and all(mma.values())):
            raise AssertionError(f"{name}'s bf16 instances hold no mma instruction: {mma}")
    return codes


def stripe_stage_times(args, name: str, side: int, ws: int, c: int, nh: int, tag: str) -> dict:
    """Kernels 5 and 6 per launch at one stripe shape, in turns with the twin
    (twin, kernel, kernel, twin), with the device time by the profiler, the
    bound and the library calls (SDPA and a depthwise conv on stripes
    partitioned beforehand; the copies timed apart); returns {kind: row}."""
    import torch

    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    q, k, v, w9, wb, g = args
    b = q.shape[0]
    scale = (c // nh) ** -0.5
    iters = max(5, min(50, 4_000_000 // (b * side * side)))
    lib = stripe_library_fns(args, ws, nh)
    out = {}
    for which, kern, plain in (
            ("fwd", lambda: sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale),
             lambda: sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale)),
            ("bwd", lambda: sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale),
             lambda: sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=ws, nh=nh,
                                                   scale=scale))):
        with torch.inference_mode(which == "fwd"):
            t = in_turns({"kernel": kern, "plain": plain}, iters)
            device = device_ms_by_kernel(kern, calls=10, per_launch=True)
        bound, by = stripe_bound_ms(b, side, side, c, nh, ws, which == "bwd")
        row = {"stage": name, "side": side, "c": c, "heads": nh, "ws": ws, "batch": b,
               "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
               "device_ms": sum(v for k, v in device.items() if k.startswith("stripe_attn")),
               "library_ms": cuda_ms(lib[which], iters),
               "copies_ms": cuda_ms(lib[which + "_copies"], iters),
               "bound_ms": bound, "bound_by": by, "turns": t}
        out[which] = row
        log(f"[kernels] stripe_attn_{which} {tag}: kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f} ms by the profiler), twin "
            f"{row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}), SDPA + depthwise conv "
            f"{row['library_ms']:.4f} ms + partition copies {row['copies_ms']:.4f} ms "
            f"(twin,kernel,kernel,twin: {t['plain'][0]:.4f},{t['kernel'][0]:.4f},"
            f"{t['kernel'][1]:.4f},{t['plain'][1]:.4f})")
    del lib
    return out


def check_stripe(card: str):
    """Kernels 5 and 6 against their twins at the five idx=0 stripe shapes of
    ga_cswin_tiny at B=128 (stages 1-3, the stage-5 block, a gram layer),
    ga_cswin_base's stage 3 (heads of 24), a non-square map and an odd batch;
    per launch at the three shapes the path runs, in turns (twin, kernel,
    kernel, twin), with the bound and the library calls; kernel 5 beside the
    composition at the stage-1 and stage-2 shapes, which the gate sends to
    the composition."""
    import torch

    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows, times, gate = [], {"fwd": [], "bwd": []}, []
    # (b, h, w, ws, C, heads, tag): ga_cswin_base's stage 3 (heads of 24), a
    # non-square map, an odd batch
    extra = [(TRAIN_BATCH, 14, 14, 7, 192, 8, "ga_cswin_base stage3"),
             (8, 8, 12, 2, 64, 2, "non-square"), (3, 8, 9, 3, 96, 3, "odd batch")]
    for name, side, ws, c, nh, launches in CSWIN_STRIPES:
        args = stripe_args(TRAIN_BATCH, side, side, c, gen)
        tag = f"{name} B={TRAIN_BATCH} {side}x{side} ws={ws} C={c} heads={nh}"
        rows.append(compare_stripe(args, ws, nh, tag))
        if not launches:
            gate.append(gate_composition(args, ws, nh, card, tag))
            del args
            continue
        for which, row in stripe_stage_times(args, name, side, ws, c, nh, tag).items():
            times[which].append(row)
        del args
    for which, what in (("fwd", "forward"), ("bwd", "train step")):
        log(f"[kernels] stripe_attn_{which} per {GA_CSWIN} {what}, B={TRAIN_BATCH}: " + ", ".join(
            f"{key} {weighted(times[which], key, CSWIN_PATH_LAUNCHES):.4f}"
            for key in ("ms", "device_ms", "bound_ms", "plain_ms", "library_ms", "copies_ms"))
            + f" on {card}")
    for b, h, w, ws, c, nh, tag in extra:
        args = stripe_args(b, h, w, c, gen)
        rows.append(compare_stripe(args, ws, nh, f"{tag} B={b} {h}x{w} ws={ws} C={c} heads={nh}"))
        del args
    torch.cuda.empty_cache()
    return rows, times, gate


def serve_branches(card: str, name: str, counters, launches: int, tag: str, arms=None,
                   calls=None, **model_kw):
    """The serving path of a GA model (phases 12 and 19; MaxViT and GA-CSWin
    on the flash route in phases 22-23): four requests, `launches` launches
    each of the first of `counters` (kernel wrappers, each counting its own
    launches) and none of the others, logits against the plain path's and,
    loosely, an fp32 model's with the same weights; one eval step; eval img/s
    at B=256 on both paths in turns, or with the switch `arms` at "1" and
    "0" in turns on the kernel path. With `calls`, a module class, the
    forward calls of its modules are counted too, and each must launch the
    kernel once. `model_kw` goes to both models."""
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.serving import make_serving_fn
    from imagenet_models_tpu_torch.train.state import make_eval_step

    t0 = time.perf_counter()
    model = create_model(name, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED),
                         **model_kw)
    if not next(model.parameters()).is_cuda:
        raise AssertionError("create_model did not build on the GPU by default")
    log(f"[{tag}serving] {name} built: {sum(p.numel() for p in model.parameters())} params, "
        f"bf16 compute, {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    requests = [torch.randint(0, 256, (REQUEST_BATCH, IMG, IMG, 3), generator=gen,
                              device="cuda", dtype=torch.uint8) for _ in range(REQUESTS)]
    serve_fn = make_serving_fn(model)
    first = counters[0]
    called, hooks = [0], []
    if calls is not None:
        def count(*_):
            called[0] += 1
        hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, calls)]
    for c in counters:
        c.launches = 0
    outputs, per_request = [], []
    t0 = time.perf_counter()
    for images in requests:
        before = first.launches
        outputs.append(serve_fn(images))
        per_request.append(first.launches - before)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    others = [c.launches for c in counters[1:]]
    log(f"[{tag}serving] {REQUESTS} requests of {REQUEST_BATCH} in "
        f"{time.perf_counter() - t0:.3f} s (first includes warm-up); {first.__name__} launches "
        f"per request: {per_request}"
        + (f"; {len(hooks)} {calls.__name__} modules, {called[0]} calls" if hooks else ""))
    if per_request != [launches] * REQUESTS or any(others):
        raise AssertionError(f"expected {launches} forward launches per request and none of the "
                             f"other kernels, got {per_request}, {others}")
    if calls is not None and not len(hooks) == launches == called[0] // REQUESTS:
        raise AssertionError(f"{len(hooks)} {calls.__name__} modules called {called[0]} times in "
                             f"{REQUESTS} requests: not one launch of {first.__name__} each")
    for logits in outputs:
        if logits.shape != (REQUEST_BATCH, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"malformed logits {tuple(logits.shape)}")
    plain = make_serving_fn(model, use_kernel=False)(requests[0])
    scale = plain.abs().max().item()
    err = (outputs[0] - plain).abs().max().item()
    fp32 = create_model(name, generator=torch.Generator().manual_seed(SEED), **model_kw)
    ref = make_serving_fn(fp32)(requests[0])  # the default dispatch: the kernels' fp32 instances
    del fp32
    err32 = (outputs[0] - ref).abs().max().item() / ref.abs().max().item()
    agree = (outputs[0].argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[{tag}serving] logits vs the plain path: max|diff| {err:.4g} (tol "
        f"{LOGITS_RTOL * scale:.4g}, max|plain| {scale:.4g}); vs an fp32 model with the same "
        f"weights: max|diff|/max|fp32| {err32:.4g} (tol {CSWIN_FP32_RTOL}), top-1 agreement "
        f"{agree:.3f}")
    if not (err <= LOGITS_RTOL * scale and err32 <= CSWIN_FP32_RTOL):
        raise AssertionError(f"{name} serving logits disagree with the plain path or fp32")
    step = make_eval_step(model)
    cfg = default_cfg(name)
    mean, std = (torch.tensor(cfg[k], device="cuda") for k in ("mean", "std"))
    x = (requests[1].float() / 255.0 - mean) / std
    targets = torch.randint(0, 1000, (REQUEST_BATCH,), generator=gen, device="cuda")
    before = first.launches
    logits, top1, top5 = step(x, targets)
    if first.launches - before != launches:
        raise AssertionError(f"the eval step did not launch {first.__name__} {launches} times")
    if not (logits - outputs[1]).abs().max().item() <= 1e-3 * scale:
        raise AssertionError("eval step logits differ from the serving logits on the same images")
    if not (top1 <= top5).all() or top1.shape != (REQUEST_BATCH,):
        raise AssertionError("eval step top-1/top-5 flags are malformed")
    served = first.launches
    bench, runs = throughput(model, card, name) if arms is None else eval_arms(model, arms, card,
                                                                               name)
    del model
    torch.cuda.empty_cache()
    return served, {"max_abs_err": err, "max_abs_plain": scale, "fp32_rel": err32,
                            "fp32_top1": agree, "eval_img_s": bench, "eval_img_s_turns": runs}


def ga_trainer(name: str, dtype, **model_kw):
    """The GA recipe (GA_RECIPE, GA_EMA; dec_lam -0.8 goes to the step) on a
    fresh full-width `name`: timm LAMB, BCE with smoothing 0.1 on dense
    (mixup) targets, EMA; `model_kw` goes to the model."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state

    model = create_model(name, dtype=dtype, generator=torch.Generator().manual_seed(SEED),
                         **model_kw)
    opt = FirstGrads(create_optimizer("lamb", **GA_RECIPE))
    return (create_train_state(model, opt, ema_decay=GA_EMA), opt,
            create_loss_fn(bce_loss=True, smoothing=0.1, mixup_active=True))


def split_qkv_bias(grads):
    """The gradients with every `qkv.bias` (3C) split into its key third,
    `qkv.bias_k`, whose true gradient is zero (softmax ignores a shift of
    the keys), and the query and value thirds, `qkv.bias_qv`."""
    import torch

    out = {}
    for k, g in grads.items():
        if k.endswith("qkv.bias"):
            c = g.shape[0] // 3
            out[k + "_k"], out[k + "_qv"] = g[c:2 * c], torch.cat([g[:c], g[2 * c:]])
        else:
            out[k] = g
    return out


def train_cswin(counters=None, steps: int = TRAIN_STEPS, tag: str = "cswin-",
                gates=("apart", "ratio"), name: str = GA_CSWIN, zero_grad=CSWIN_ZERO_GRAD,
                noisy=CSWIN_NOISY_STAGES):
    """`steps` kernel-path steps of the benchkit recipe on `name` (by default
    ga_cswin_tiny) with launch counts (of `counters`, (kernel wrapper,
    launches per step) pairs; by default kernels 5 and 6), and one plain-path
    step from a deep copy of the first state, whose loss, grad norm and
    gradients must agree with the kernel path's first step and an fp32
    model's (`compare_grads` by `gates`, with `zero_grad` and `noisy` as
    there)."""
    import torch

    from imagenet_models_tpu_torch.ops import stripe_attention as sa
    from imagenet_models_tpu_torch.train.state import make_train_step

    if counters is None:
        counters = ((sa.fused_stripe_attention, CSWIN_LAUNCHES),
                    (sa.fused_stripe_attention_bwd, CSWIN_LAUNCHES))

    torch.cuda.reset_peak_memory_stats()
    state, kernel_opt, loss_fn = ga_trainer(name, torch.bfloat16)
    plain_state = copy.deepcopy(state)
    plain_opt = FirstGrads(kernel_opt.opt)
    first = {k: p.detach().clone() for k, p in state.params().items()}
    kw = dict(dec_lam=-0.8, ema_decay=GA_EMA)
    step = make_train_step(state.model, kernel_opt, loss_fn, **kw)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, use_kernel=False, **kw)
    images, targets = train_batch()
    gen = torch.Generator(device="cuda")

    for c, _ in counters:
        c.launches = 0
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        torch.manual_seed(SEED + 10 + i)  # the head's dropout masks
        before = counter_launches(counters)
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10 + i))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append([a - b for a, b in zip(counter_launches(counters), before)])
    torch.cuda.synchronize()
    log(f"[{tag}train] {steps} steps of B={TRAIN_BATCH} in {time.perf_counter() - t0:.2f} s "
        f"(first includes warm-up)")
    launches = check_step_launches(counters, per_step, tag)
    log(f"[{tag}train] loss per step: " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
        + "; grad_norm per step: " + ", ".join(f"{m['grad_norm']:.6f}" for m in metrics))
    for m in metrics:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite train metrics: {metrics}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError(f"the loss did not fall over {steps} steps on a fixed batch")
    ema_moved = max((state.ema_params[k] - first[k]).abs().max().item() for k in first)
    moved = max((p.detach() - first[k]).abs().max().item() for k, p in state.params().items())
    log(f"[{tag}train] largest move from the initial weights: params {moved:.4g}, EMA shadow "
        f"{ema_moved:.4g}")
    if not 0.0 < ema_moved < moved:
        raise AssertionError("the EMA shadow did not move, or moved as far as the params")

    torch.manual_seed(SEED + 10)
    plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
    pm = {k: v.item() for k, v in pm.items()}
    loss_rel = abs(metrics[0]["loss"] - pm["loss"]) / abs(pm["loss"])
    gnorm_rel = abs(metrics[0]["grad_norm"] - pm["grad_norm"]) / abs(pm["grad_norm"])
    fp32_state, fp32_opt, _ = ga_trainer(name, torch.float32)
    fp32_step = make_train_step(fp32_state.model, fp32_opt, loss_fn, use_kernel=False, **kw)
    torch.manual_seed(SEED + 10)
    _, fm = fp32_step(fp32_state, images, targets, gen.manual_seed(SEED + 10))
    fm = {k: v.item() for k, v in fm.items()}
    del fp32_state
    log(f"[{tag}train] first step, kernel vs plain path: loss {metrics[0]['loss']:.6f} vs "
        f"{pm['loss']:.6f} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}); grad_norm "
        f"{metrics[0]['grad_norm']:.6f} vs {pm['grad_norm']:.6f} (rel {gnorm_rel:.3g}, tol "
        f"{TRAIN_GNORM_RTOL}); the fp32 model's loss {fm['loss']:.6f}, grad_norm "
        f"{fm['grad_norm']:.6f}")
    grads = compare_grads(*(split_qkv_bias(o.grads) for o in (kernel_opt, plain_opt, fp32_opt)),
                          tag, zero_grad, noisy, gates=gates)
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    kernel_opt.grads = plain_opt.grads = fp32_opt.grads = {}
    torch.cuda.empty_cache()
    check = {"losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
             "plain_loss": pm["loss"], "plain_grad_norm": pm["grad_norm"], "loss_rel": loss_rel,
             "grad_norm_rel": gnorm_rel, "grads_rel": grads, "ema_moved": ema_moved,
             "params_moved": moved}
    return (state, step), (plain_state, plain_step), images, targets, launches, check


# ---------------------------------------------------------------- BatchNorm family

def bn_census(model, images) -> dict:
    """{(shape, dtype): count} of the BatchNorm inputs that take
    `ops.batch_norm.bn_train` in one training forward of `model` with the
    switch at "full": the launches of kernels 7 and 8 per train step. The
    forward runs on a deep copy, so the model's running statistics stay."""
    import torch

    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    seen, real = {}, bn_ops.bn_train

    def spy(x, *args, **kwargs):
        key = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
        seen[key] = seen.get(key, 0) + 1
        return real(x, *args, **kwargs)

    probe = copy.deepcopy(model).train()
    bn_ops.bn_train, mode = spy, bn_ops._PALLAS_BN_MODE
    bn_ops._PALLAS_BN_MODE = "full"
    try:
        with torch.no_grad():
            probe(images)
    finally:
        bn_ops.bn_train, bn_ops._PALLAS_BN_MODE = real, mode
    del probe
    return seen


def bn_bound_ms(n: int, c: int, itemsizes) -> tuple:
    """The least time of one launch of kernel 7 (one operand) or 8 (two): its
    bytes (each operand read once, the 2C fp32 sums written once) over the
    memory rate, against its fp32 operations (2 per element of kernel 7, 3
    per element pair of kernel 8) over the fp32 rate outside the tensor
    cores."""
    nbytes = n * c * sum(itemsizes) + 2 * c * 4
    flops = (2 if len(itemsizes) == 1 else 3) * n * c
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bn_bare_ms(which: str, a, b, iters: int) -> float:
    """Milliseconds per launch of kernel 7 (on b, which="fwd") or 8 (on a, b)
    launched back to back through its C entry point alone, from a workspace
    and tickets made once: the device's time wherever it exceeds the one
    ctypes call left on the host."""
    import ctypes

    import torch

    from imagenet_models_tpu_torch.ops import _kernels
    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    ops = [b] if which == "fwd" else [a, b]
    lib = _kernels.bn_moments_library() if which == "fwd" else _kernels.bn_dot_sums_library()
    fn = lib.imt_bn_moments if which == "fwd" else lib.imt_bn_dot_sums
    c = b.shape[-1]
    n = b.numel() // c
    sizes = (ctypes.c_longlong * 2)()
    lib.imt_bn_plan(n, c, sizes)
    work = torch.empty(sizes[0], dtype=torch.float32, device="cuda")
    tickets = torch.zeros(sizes[1], dtype=torch.int32, device="cuda")
    args = []
    for t in ops:
        args += [t.data_ptr(), bn_ops._row_stride(t), bn_ops._DTYPES[t.dtype]]
    args += [n, c, work.data_ptr(), tickets.data_ptr(), torch.cuda.current_stream().cuda_stream]
    return cuda_ms(lambda: fn(*args), iters)


def compare_bn(a, b, tag: str) -> dict:
    """Kernels 7 (on a) and 8 (on a, b) against their twins and float64 sums;
    raises past BN_SUM_RTOL of the per-channel sum of |terms|, or if kernel
    8 gives other bits on a second run, or on a third after a call on
    another shape (a stale last-block ticket would show there)."""
    import torch

    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    c = a.shape[-1]
    a64, b64 = a.reshape(-1, c).double(), b.reshape(-1, c).double()
    checks = {}
    for name, got, twin, exact, size in (
            ("moments", bn_ops.fused_channel_moments(a), bn_ops.plain_channel_moments(a),
             (a64.sum(0), (a64 * a64).sum(0)), (a64.abs().sum(0), (a64 * a64).sum(0))),
            ("dot_sums", bn_ops.fused_channel_dot_sums(a, b), bn_ops.plain_channel_dot_sums(a, b),
             (a64.sum(0), (a64 * b64).sum(0)), (a64.abs().sum(0), (a64 * b64).abs().sum(0)))):
        torch.cuda.synchronize()
        worst_exact = max(((g.double() - e).abs() / s.clamp_min(1e-30)).max().item()
                          for g, e, s in zip(got, exact, size))
        worst_twin = max(((g.double() - t.double()).abs() / s.clamp_min(1e-30)).max().item()
                         for g, t, s in zip(got, twin, size))
        checks[name] = {"vs_fp64": worst_exact, "vs_twin": worst_twin,
                        "max_abs_err": max(rel_err(g, t) for g, t in zip(got, twin))}
    again = bn_ops.fused_channel_dot_sums(a, b)
    first = bn_ops.fused_channel_dot_sums(a, b)
    other = torch.ones(3, 5, 7, 24, device=a.device, dtype=a.dtype)  # another plan
    bn_ops.fused_channel_dot_sums(other, other)
    after = bn_ops.fused_channel_dot_sums(a, b)
    same = all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(again, first, after))
    log(f"[kernels] bn {tag}: |kernel - fp64| / sum|terms| moments "
        f"{checks['moments']['vs_fp64']:.3g}, dot_sums {checks['dot_sums']['vs_fp64']:.3g}; vs "
        f"twin {checks['moments']['vs_twin']:.3g}, {checks['dot_sums']['vs_twin']:.3g} (tol "
        f"{BN_SUM_RTOL}); dot sums bit-equal across runs and after another shape: {same}")
    bad = [k for k, v in checks.items() if not (v["vs_fp64"] <= BN_SUM_RTOL
                                               and v["vs_twin"] <= BN_SUM_RTOL)]
    if bad or not same:
        raise AssertionError(f"BatchNorm kernels disagree {tag} in {bad}, or kernel 8 moved "
                             f"between runs ({same})")
    return {"tag": tag, **checks}


def bn_shape_times(census, gen, card: str):
    """Kernels 7 and 8 at each (shape, dtype) of a BatchNorm census: held to
    their twins and float64 sums in bf16 and fp32 (`compare_bn`), then per
    launch in turns (twin, kernel, kernel, twin) in bf16 beside the bound,
    one PyTorch call per kernel (`torch.batch_norm_stats`,
    `torch.batch_norm_backward_reduce` on the NCHW channels_last view, never
    called by the port), each kernel's device time per launch from the
    profiler, and its time launched back to back through the C entry point
    alone (`bn_bare_ms`); (check rows, {"fwd": rows, "bwd": rows})."""
    import torch

    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    rows, times = [], {"fwd": [], "bwd": []}
    for (shape, dt), count in census.items():
        n, c = shape[0] * shape[1] * shape[2], shape[3]
        a = (torch.randn(*shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        b = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(compare_bn(a, b, f"{shape} {dt}"))
        rows.append(compare_bn(a.float(), b.float(), f"{shape} float32"))
        iters = max(5, min(100, 400_000_000 // (n * c)))
        an, bn = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)  # channels_last NCHW views
        mean, invstd = torch.batch_norm_stats(an, 1e-5)
        weight = torch.ones(c, device="cuda")
        for which, kern, plain, lib, sizes in (
                ("fwd", lambda: bn_ops.fused_channel_moments(a),
                 lambda: bn_ops.plain_channel_moments(a),
                 lambda: torch.batch_norm_stats(an, 1e-5), (2,)),
                ("bwd", lambda: bn_ops.fused_channel_dot_sums(b, a),
                 lambda: bn_ops.plain_channel_dot_sums(b, a),
                 lambda: torch.batch_norm_backward_reduce(bn, an, mean, invstd, weight,
                                                          False, True, True), (2, 2))):
            with torch.inference_mode():
                t = in_turns({"kernel": kern, "plain": plain}, iters)
                try:
                    lib_ms = cuda_ms(lib, iters)
                except RuntimeError as e:  # the yardstick only: the port never calls it
                    log(f"[kernels] library call for {shape} failed: {e}")
                    lib_ms = None
            bound, by = bn_bound_ms(n, c, sizes)
            device = device_ms_by_kernel(kern, 10, "channel_sums_kernel", per_launch=True)
            row = {"shape": list(shape), "count": count, "ms": sum(t["kernel"]) / 2,
                   "plain_ms": sum(t["plain"]) / 2, "library_ms": lib_ms, "bound_ms": bound,
                   "bound_by": by, "device_ms": device.get("channel_sums_kernel"),
                   "bare_ms": bn_bare_ms(which, b, a, iters), "turns": t}
            times[which].append(row)
            log(f"[kernels] bn_{'moments' if which == 'fwd' else 'dot_sums'} {shape} bf16 "
                f"(x{count} per step): kernel {row['ms']:.4f} ms (device {row['device_ms']} ms, "
                f"bare launches {row['bare_ms']:.4f} ms), "
                f"twin {row['plain_ms']:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), library {lib_ms} ms "
                f"(twin,kernel,kernel,twin: {t['plain'][0]:.4f},{t['kernel'][0]:.4f},"
                f"{t['kernel'][1]:.4f},{t['plain'][1]:.4f}) on {card}")
        del a, b, an, bn
    return rows, times


def check_bn(card: str):
    """Phase 14: kernels 7 and 8 against their twins and float64 sums at
    every BatchNorm shape that takes them in map_resnet50's B=128, 224 px
    train step (found by a census of one training forward), in bf16 as the
    path gives them and in fp32, and at an odd row count, C = 40 and mixed
    operand types; per launch in turns (twin, kernel, kernel, twin) at the
    path's bf16 shapes, beside the bound and one PyTorch call per kernel
    (`torch.batch_norm_stats`, `torch.batch_norm_backward_reduce` on the
    NCHW channels_last view), never called by the port; each kernel's
    device time per launch from the profiler, and its time launched back to
    back through the C entry point alone (`bn_bare_ms`), beside them, so
    that host and device time stand apart."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    model = create_model(RESNET, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    images = torch.randn(TRAIN_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    census = bn_census(model, images)
    del model, images
    torch.cuda.empty_cache()
    log(f"[kernels] {RESNET} B={TRAIN_BATCH} {IMG}px: {sum(census.values())} BatchNorms per "
        f"forward take kernels 7 and 8, at {len(census)} shapes: "
        + ", ".join(f"{s}x{n}" for (s, _), n in census.items()))
    rows, times = bn_shape_times(census, gen, card)
    # an odd row count, C not a multiple of 8, mixed operand types, a channel
    # slice (rows 3C apart, 2 bytes off a 16-byte boundary)
    for shape, (ta, tb) in (((3, 37, 41, 40), ("bfloat16", "float32")),
                            ((7, 13, 11, 64), ("float32", "bfloat16")),
                            ((5, 9, 9, 96), ("bfloat16", "bfloat16"))):
        a = (torch.randn(*shape, generator=gen, device="cuda") * 2 + 0.5).to(getattr(torch, ta))
        b = torch.randn(*shape, generator=gen, device="cuda").to(getattr(torch, tb))
        rows.append(compare_bn(a, b, f"{shape} {ta}/{tb}"))
    wide = torch.randn(5, 9, 9, 3 * 96, generator=gen, device="cuda").to(torch.bfloat16)
    rows.append(compare_bn(wide[..., 1:97], wide[..., 96:192], "(5, 9, 9, 96) channel slices"))
    totals = {w: {k: (sum(r["count"] * r[k] for r in times[w])
                      if all(r[k] is not None for r in times[w]) else None)
                  for k in ("ms", "device_ms", "bare_ms", "plain_ms", "library_ms", "bound_ms")}
              for w in times}
    log(f"[kernels] per {RESNET} train step (ms, weighted by launches): kernel 7 {totals['fwd']}; "
        f"kernel 8 {totals['bwd']} on {card}")
    torch.cuda.empty_cache()
    return census, rows, times, totals


def serve_bn(name: str, card: str, tag: str, arms=None) -> dict:
    """Phases 15, 17 and 30: four uint8 requests through `make_serving_fn`
    with the switch on: eval reads the running statistics, so kernels 7 and
    8 are not launched; logits against the plain path and, loosely, an fp32
    model with the same weights; one eval step; eval img/s at B=256 in two
    runs, or with the switch `arms` at "1" and "0" in turns."""
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops
    from imagenet_models_tpu_torch.serving import make_serving_fn
    from imagenet_models_tpu_torch.train.state import make_eval_step

    t0 = time.perf_counter()
    model = create_model(name, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    if not next(model.parameters()).is_cuda:
        raise AssertionError("create_model did not build on the GPU by default")
    log(f"[{tag}-serving] {name} built: {sum(p.numel() for p in model.parameters())} params, bf16 "
        f"compute, {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    requests = [torch.randint(0, 256, (REQUEST_BATCH, IMG, IMG, 3), generator=gen,
                              device="cuda", dtype=torch.uint8) for _ in range(REQUESTS)]
    serve_fn = make_serving_fn(model)
    bn_ops.fused_channel_moments.launches = bn_ops.fused_channel_dot_sums.launches = 0
    t0 = time.perf_counter()
    outputs = [serve_fn(images) for images in requests]
    torch.cuda.synchronize()
    launches = bn_ops.fused_channel_moments.launches + bn_ops.fused_channel_dot_sums.launches
    log(f"[{tag}-serving] {REQUESTS} requests of {REQUEST_BATCH} in {time.perf_counter() - t0:.3f} s "
        f"(first includes warm-up), switch {bn_ops._PALLAS_BN_MODE!r}: {launches} launches of "
        f"kernels 7 and 8 (eval reads the running statistics)")
    if launches:
        raise AssertionError("the eval forward launched the BatchNorm statistics kernels")
    for logits in outputs:
        if logits.shape != (REQUEST_BATCH, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"malformed logits {tuple(logits.shape)}")
    plain = make_serving_fn(model, use_kernel=False)(requests[0])
    scale = plain.abs().max().item()
    err = (outputs[0] - plain).abs().max().item()
    fp32 = create_model(name, generator=torch.Generator().manual_seed(SEED))
    ref = make_serving_fn(fp32)(requests[0])
    del fp32
    err32 = (outputs[0] - ref).abs().max().item() / ref.abs().max().item()
    agree = (outputs[0].argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[{tag}-serving] logits vs the plain path: max|diff| {err:.4g} (tol "
        f"{LOGITS_RTOL * scale:.4g}, max|plain| {scale:.4g}); vs an fp32 model with the same "
        f"weights: max|diff|/max|fp32| {err32:.4g} (tol {BN_FP32_RTOL}), top-1 agreement "
        f"{agree:.3f}")
    if not (err <= LOGITS_RTOL * scale and err32 <= BN_FP32_RTOL):
        raise AssertionError(f"{name} serving logits disagree with the plain path or fp32")
    step = make_eval_step(model)
    cfg = default_cfg(name)
    mean, std = (torch.tensor(cfg[k], device="cuda") for k in ("mean", "std"))
    x = (requests[1].float() / 255.0 - mean) / std
    targets = torch.randint(0, 1000, (REQUEST_BATCH,), generator=gen, device="cuda")
    logits, top1, top5 = step(x, targets)
    if not (logits - outputs[1]).abs().max().item() <= 1e-3 * scale:
        raise AssertionError("eval step logits differ from the serving logits on the same images")
    if not (top1 <= top5).all() or top1.shape != (REQUEST_BATCH,):
        raise AssertionError("eval step top-1/top-5 flags are malformed")
    if arms is not None:
        bench, runs = eval_arms(model, arms, card, name)
    else:
        x = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
        with torch.inference_mode():
            runs = [BENCH_BATCH * 1000.0 / cuda_ms(lambda: model(x), BENCH_ITERS)
                    for _ in range(2)]
        bench = sum(runs) / 2
        log(f"[throughput] {name} eval B={BENCH_BATCH} {IMG}px bf16: {bench:.1f} img/s (runs "
            f"{runs[0]:.1f}, {runs[1]:.1f}; no kernel at eval) on {card}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "max_abs_plain": scale, "fp32_rel": err32,
            "fp32_top1": agree, "eval_img_s": bench, "eval_img_s_runs": runs}


def bn_trainer(name: str, dtype, recipe: dict, **model_kw):
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state

    model = create_model(name, dtype=dtype, generator=torch.Generator().manual_seed(SEED),
                         **model_kw)
    opt = FirstGrads(create_optimizer("lamb", **recipe["opt"]))
    return create_train_state(model, opt), opt, create_loss_fn(**recipe["loss"])


def bf16_drift(name: str, images) -> dict:
    """How far a bf16 training forward of `name` lies from an fp32 one with
    the same weights and batch, block by block (stem, stage blocks, head
    outputs; L2 relative, in the order they run): why the bf16 pair of
    `train_bn` is not held together by group. Plain path, no drop-path or
    dropout, on fresh models."""
    import torch

    from imagenet_models_tpu_torch import create_model

    def tensors(o):
        if isinstance(o, torch.Tensor):
            return [o.float().flatten()]
        return [t for x in o for t in tensors(x)] if isinstance(o, (tuple, list)) else []

    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = create_model(name, dtype=dtype,
                             generator=torch.Generator().manual_seed(SEED)).train()
        seen = outs[dtype] = {}

        def keep(mod, args, out, seen=seen):
            seen[mod.drift_name] = torch.cat(tensors(out))
        for mod_name, mod in model.named_modules():
            if re.fullmatch(r"stem\.\d+|layer[1-4]\.\d+|layers\.\d+\.\d+|patch_embed|"
                            r"levels\.\d+\.blocks\.\d+|head|fc", mod_name):
                mod.drift_name = mod_name
                mod.register_forward_hook(keep)
        with torch.no_grad():
            model(images, use_kernel=False)
        del model
    drift = {n: rel_l2(outs[torch.bfloat16][n], ref) for n, ref in outs[torch.float32].items()}
    log(f"[{name}] bf16 training forward vs fp32, same weights, L2 relative by block: "
        + ", ".join(f"{n} {v:.3g}" for n, v in drift.items()))
    torch.cuda.empty_cache()
    return drift


def train_bn(name: str, recipe: dict, steps: int, img: int, tag: str, batch: int = TRAIN_BATCH,
             zero_kinds=(), **model_kw):
    """Phases 16, 17 and 30: `steps` kernel-path steps of `recipe` at `batch`
    with the switch at "full" (launches of kernels 7 and 8 per step, finite
    metrics; with
    more than one step, a falling loss on a fixed batch), then the first
    step again on the plain path (use_kernel=False: no launch) from a deep
    copy of the first state with the same drop-path and dropout draws, and
    both paths' first step of an fp32 model with the same weights; checked
    by `compare_grads`, the fp32 pair by group and the bf16 pair by its
    distance to fp32 (see `bf16_drift`), the groups of `zero_kinds` held
    there as having a true gradient of zero, and the loss and grad norm
    within TRAIN_LOSS_RTOL (fp32; the loss in bf16)."""
    import torch

    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops
    from imagenet_models_tpu_torch.train.state import make_train_step

    torch.cuda.reset_peak_memory_stats()
    state, kernel_opt, loss_fn = bn_trainer(name, torch.bfloat16, recipe, **model_kw)
    plain_state = copy.deepcopy(state)
    plain_opt = FirstGrads(kernel_opt.opt)
    step = make_train_step(state.model, kernel_opt, loss_fn, dec_lam=-0.8)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, dec_lam=-0.8,
                                 use_kernel=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    images = torch.randn(batch, img, img, 3, generator=gen, device="cuda")
    targets = torch.rand(batch, 1000, generator=gen, device="cuda")
    if not recipe["loss"].get("bce_loss"):  # a cross-entropy takes mixup's distributions
        targets = targets / targets.sum(-1, keepdim=True)
    census = bn_census(state.model, images)
    per_forward = sum(census.values())

    bn_ops.fused_channel_moments.launches = bn_ops.fused_channel_dot_sums.launches = 0
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        torch.manual_seed(SEED + 10 + i)  # the head's dropout masks
        before = (bn_ops.fused_channel_moments.launches, bn_ops.fused_channel_dot_sums.launches)
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10 + i))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append((bn_ops.fused_channel_moments.launches - before[0],
                         bn_ops.fused_channel_dot_sums.launches - before[1]))
    torch.cuda.synchronize()
    launches = {"fwd": bn_ops.fused_channel_moments.launches,
                "bwd": bn_ops.fused_channel_dot_sums.launches}
    log(f"[{tag}-train] {steps} steps of B={batch} {img}px in {time.perf_counter() - t0:.2f} s "
        f"(first includes warm-up), switch 'full'; (kernel 7, kernel 8) launches per step: "
        f"{per_step}")
    log(f"[{tag}-train] loss per step: " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
        + "; grad_norm per step: " + ", ".join(f"{m['grad_norm']:.6f}" for m in metrics))
    if per_step != [(per_forward, per_forward)] * steps or not per_forward:
        raise AssertionError(f"expected {per_forward} launches of each kernel per step, got "
                             f"{per_step}")
    for m in metrics:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite train metrics: {metrics}")
    if steps > 1 and not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError(f"the loss did not fall over {steps} steps on a fixed batch")

    def first_step(st, opt, use_kernel):
        """One step from `st` with the first step's draws; (metrics, fp32
        gradients, launches of kernels 7 and 8)."""
        before = (bn_ops.fused_channel_moments.launches, bn_ops.fused_channel_dot_sums.launches)
        fn = make_train_step(st.model, opt, loss_fn, dec_lam=-0.8, use_kernel=use_kernel)
        torch.manual_seed(SEED + 10)
        _, m = fn(st, images, targets, gen.manual_seed(SEED + 10))
        after = (bn_ops.fused_channel_moments.launches, bn_ops.fused_channel_dot_sums.launches)
        grads, opt.grads = opt.grads, None
        return ({k: v.item() for k, v in m.items()}, grads,
                (after[0] - before[0], after[1] - before[1]))

    before = (bn_ops.fused_channel_moments.launches, bn_ops.fused_channel_dot_sums.launches)
    torch.manual_seed(SEED + 10)
    plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
    pm = {k: v.item() for k, v in pm.items()}
    if (bn_ops.fused_channel_moments.launches, bn_ops.fused_channel_dot_sums.launches) != before:
        raise AssertionError("the plain path (use_kernel=False) launched kernel 7 or 8")
    fp32_state, fp32_opt, _ = bn_trainer(name, torch.float32, recipe, **model_kw)
    fp32_base = copy.deepcopy(fp32_state)
    k32 = first_step(fp32_state, fp32_opt, None)
    p32 = first_step(fp32_base, FirstGrads(fp32_opt.opt), False)
    del fp32_state, fp32_base
    first = {"bf16": (metrics[0], pm), "fp32": (k32[0], p32[0])}
    rel = {prec: {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
           for prec, (a, b) in first.items()}
    log(f"[{tag}-train] first step, kernel vs plain path (use_kernel=False), loss and grad norm: "
        + "; ".join(f"{prec} {a['loss']:.6f} vs {b['loss']:.6f} (rel {rel[prec]['loss']:.3g}), "
                    f"{a['grad_norm']:.6f} vs {b['grad_norm']:.6f} (rel {rel[prec]['grad_norm']:.3g})"
                    for prec, (a, b) in first.items())
        + f"; tol {TRAIN_LOSS_RTOL} for both in fp32, for the loss in bf16; plain-path launches "
          f"{p32[2]} (fp32), the kernel path's {k32[2]}")
    if p32[2] != (0, 0) or k32[2] != (per_forward, per_forward):
        raise AssertionError(f"launches of kernels 7 and 8: plain path {p32[2]}, kernel path "
                             f"{k32[2]}, expected none and {per_forward}")
    if not (rel["fp32"]["loss"] <= TRAIN_LOSS_RTOL and rel["fp32"]["grad_norm"] <= TRAIN_GNORM_RTOL
            and rel["bf16"]["loss"] <= TRAIN_LOSS_RTOL):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    grads = {"fp32": compare_grads(k32[1], p32[1], None, f"{tag}-fp32-", zero_kinds,
                                   gates=("apart",), zero_by_stage=True),
             "bf16": compare_grads(kernel_opt.grads, plain_opt.grads, p32[1], f"{tag}-bf16-",
                                   zero_kinds, gates=("ratio",), zero_by_stage=True)}
    kernel_opt.grads = plain_opt.grads = {}
    torch.cuda.empty_cache()
    check = {"census": {f"{s}": n for (s, _), n in census.items()},
             "losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
             "first_step": first, "first_step_rel": rel, "grads_rel": grads,
             "bf16_drift": bf16_drift(name, images)}
    return (state, step), (plain_state, plain_step), images, targets, launches, check


def switch_attr(switch: str):
    """(module, attribute) that holds a switch of the port, read once from the
    environment at import: IMTPU_PALLAS_BN (`ops.batch_norm._PALLAS_BN_MODE`),
    IMTPU_DW_WGRAD (`ops.dw_conv._DW_WGRAD`), IMTPU_FLASH_ATTN
    (`ops.flash_attention._FLASH_ATTN`) and IMTPU_TLNMLP
    (`ops.convnext_block._TLNMLP`)."""
    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops
    from imagenet_models_tpu_torch.ops import convnext_block as cb_ops
    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops
    from imagenet_models_tpu_torch.ops import flash_attention as fa_ops

    return {"IMTPU_PALLAS_BN": (bn_ops, "_PALLAS_BN_MODE"), "IMTPU_DW_WGRAD": (dw_ops, "_DW_WGRAD"),
            "IMTPU_FLASH_ATTN": (fa_ops, "_FLASH_ATTN"), "IMTPU_TLNMLP": (cb_ops, "_TLNMLP")}[switch]


def switch_arms(switch: str, kernel, plain, images, targets, card: str, what: str,
                arms, iters: int = TRAIN_ITERS, warmup: int = TRAIN_WARMUP) -> dict:
    """Train img/s of the arms of a switch in turns of `iters` steps, after
    `warmup` steps each: `switch` names one of `switch_attr`'s; `arms` lists
    (value, "kernel" or "plain" path). The arms share one model and batch of
    each path; each sets the switch before its step, which is left at the
    first arm's value."""
    import torch

    module, attr = switch_attr(switch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    steps = {"kernel": kernel, "plain": plain}
    fns = {}
    for mode, which in arms:
        st, step = steps[which]

        def run(st=st, step=step, mode=mode):
            setattr(module, attr, mode)
            step(st, images, targets, gen)
        fns[f"{mode}/{which}"] = run
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    t = in_turns(fns, iters, order=tuple(fns))
    setattr(module, attr, arms[0][0])
    batch = images.shape[0]
    runs = {k: [batch * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[train-throughput] {what} train B={batch} {images.shape[1]}px bf16, by {switch} "
        f"arm: " + "; ".join(f"{k} {result[k]:.1f} img/s (turns "
                             + ",".join(f"{r:.1f}" for r in runs[k]) + ")" for k in runs)
        + f" on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {"img_s": result, "turns": runs}


def code_report(build, tag: str) -> dict:
    """What the compiler made of a kernel library: ptxas's registers and
    spills of each kernel function (from its nvcc log, `-Xptxas -v`) and the
    SASS instruction count of each (`cuobjdump -sass`), with the counts of
    SASS_OPCODES. Logged; a tool that is missing or a reused build (no log)
    reads "not measured"."""
    import os
    import shutil
    from collections import Counter

    report = {"ptxas": {}, "sass": {}}
    current = None
    for line in build.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            spill = re.search(r"(\d+) bytes spill stores", build.log[build.log.find(current):])
            report["ptxas"][current] = {"registers": int(m.group(1)),
                                        "spill_stores": int(spill.group(1)) if spill else None}
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    try:
        text = subprocess.run([tool, "-sass", str(build.path)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"[code] {tag}: SASS not measured ({e})")
        text = ""
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        ops = Counter(o.split(".")[0] for o in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", body))
        report["sass"][name] = {"instructions": sum(ops.values()),
                                **{k: ops[k] for k in SASS_OPCODES if ops[k]}}
    for name in sorted(set(report["ptxas"]) | set(report["sass"])):
        regs = report["ptxas"].get(name, {})
        code = report["sass"].get(name, {})
        log(f"[code] {tag} {name}: "
            + (f"{regs['registers']} registers, {regs['spill_stores']} bytes spilled; "
               if regs else "registers not measured; ")
            + (", ".join(f"{k} {v}" for k, v in code.items()) if code else "SASS not measured"))
    return report


def k12_digest(run) -> str:
    """The SHA-256 of kernel 12's fp32 outputs (their bits) at fixed inputs
    made with numpy: GA-CSWin's stage-3 windows (98 tokens) with a per-window
    bias, a ragged 50 x 24 without one and 256 tokens of 128 channels with
    one. `run(q, k, v, bias)` launches a build of kernel 12."""
    import hashlib

    import numpy as np
    import torch

    digest = hashlib.sha256()
    rng = np.random.default_rng(1212)
    draw = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    for bw, n, d, with_bias in ((256, 98, 32, True), (64, 50, 24, False), (16, 256, 128, True)):
        q, k, v = draw(bw, n, d) * d ** -0.5, draw(bw, n, d), draw(bw, n, d)
        bias = (0.5 * draw(bw, n, n)).cuda() if with_bias else None
        out = run(q.cuda(), k.cuda(), v.cuda(), bias)
        torch.cuda.synchronize()
        digest.update(out.view(torch.int32).cpu().numpy().tobytes())
    return digest.hexdigest()


# ---------------------------------------------------------------- GA-ConvNeXt

def dw_bound_ms(b: int, h: int, w: int, c: int, itemsize: int) -> tuple:
    """The least time of one launch of kernel 9 on a (b, h, w, c) map: the
    larger of its bytes (x and dy read once, the 49C fp32 taps written once)
    over the memory rate and its operations (a multiply and an add per tap
    and element pair) over the bf16 tensor-core peak. Beside it, the CUDA-core
    floor: the 49 multiply-adds per element pair at the fp32 rate outside the
    tensor cores (a per-channel reduction has no tensor-core shape)."""
    n = b * h * w * c
    nbytes = 2 * n * itemsize + 49 * c * 4
    flops = 2 * 49 * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    core_ms = flops / PEAK_FP32_FLOPS * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")) + (core_ms,)


def dw_fp64(x, dy):
    """float64 tap sums of the products of x and dy (each rounded to bf16 when
    both are bf16), and the tap sums of |terms|, both (C, 1, 7, 7)."""
    import torch

    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x.double(), (0, 0, 3, 3, 3, 3))
    dyd = dy.double()
    exact, size = [], []
    for ky in range(7):
        for kx in range(7):
            prod = xp[:, ky:ky + h, kx:kx + w] * dyd
            if x.dtype == torch.bfloat16 and dy.dtype == torch.bfloat16:
                prod = prod.float().bfloat16().double()
            exact.append(prod.sum((0, 1, 2)))
            size.append(prod.abs().sum((0, 1, 2)))
    return (torch.stack(exact, 1).reshape(c, 1, 7, 7), torch.stack(size, 1).reshape(c, 1, 7, 7))


def compare_dw(x, dy, tag: str) -> dict:
    """Kernel 9 against float64 sums and its twin; raises past DW_SUM_RTOL
    of the tap's sum of |terms|, or if a second run gives other bits."""
    import torch

    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops

    got = dw_ops.fused_dw7_wgrad(x, dy)
    again = dw_ops.fused_dw7_wgrad(x, dy)
    twin = dw_ops.plain_dw7_wgrad(x, dy)
    torch.cuda.synchronize()
    exact, size = dw_fp64(x, dy)
    size = size.clamp_min(1e-30)
    vs_fp64 = ((got.double() - exact).abs() / size).max().item()
    vs_twin = ((got.double() - twin.double()).abs() / size).max().item()
    twin_fp64 = ((twin.double() - exact).abs() / size).max().item()
    same = torch.equal(got, again)
    ok = (got.shape == (x.shape[-1], 1, 7, 7) and got.dtype == torch.float32
          and bool(torch.isfinite(got).all()))
    log(f"[kernels] dw7_wgrad {tag}: |kernel - fp64| / sum|terms| {vs_fp64:.3g}, vs twin "
        f"{vs_twin:.3g} (twin vs fp64 {twin_fp64:.3g}; tol {DW_SUM_RTOL}); bit-equal across "
        f"runs: {same}")
    if not (ok and vs_fp64 <= DW_SUM_RTOL and vs_twin <= DW_SUM_RTOL and same):
        raise AssertionError(f"kernel 9 disagrees {tag}: vs fp64 {vs_fp64}, vs twin {vs_twin}, "
                             f"bit-equal {same}, well-formed {ok}")
    return {"tag": tag, "vs_fp64": vs_fp64, "vs_twin": vs_twin, "twin_vs_fp64": twin_fp64,
            "max_abs_err": (got - twin).abs().max().item(), "bit_equal": same}


def check_dw(card: str, build):
    """Phase 18: kernel 9 against its twin and float64 sums at the five B=128
    shapes of ga_convnext_tiny's train step, in bf16 (as the path gives them)
    and fp32, and at C = 688, a non-square map and an odd batch; per launch
    in turns (twin, kernel, kernel, twin) at the path's bf16 shapes, beside
    the bound, and cuDNN's depthwise weight gradient (`torch.nn.grad.
    conv2d_weight`, and the weight-only `aten.convolution_backward`, on the
    channels_last NCHW views), never called by the port; the sums per train
    step weighted by launches, and the kernel's over cuDNN's; the library's
    code report (registers, SASS counts)."""
    import torch

    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    rows, times = [], []
    for name, b, h, w, c, count in DW_SHAPES:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
        dy = (0.1 * torch.randn(b, h, w, c, generator=gen, device="cuda")).to(torch.bfloat16)
        rows.append(compare_dw(x, dy, f"{name} {(b, h, w, c)} bfloat16"))
        rows.append(compare_dw(x.float(), dy.float(), f"{name} {(b, h, w, c)} float32"))
        n = b * h * w * c
        iters = max(3, min(50, 300_000_000 // n))
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)   # channels_last views
        weight = torch.zeros(c, 1, 7, 7, device="cuda", dtype=torch.bfloat16)
        with torch.inference_mode():
            t = in_turns({"kernel": lambda: dw_ops.fused_dw7_wgrad(x, dy),
                          "plain": lambda: dw_ops.plain_dw7_wgrad(x, dy)}, iters)
            lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                xn, weight.shape, dyn, padding=3, groups=c), iters)
            aten_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                dyn, xn, weight, None, [1, 1], [3, 3], [1, 1], False, [0, 0], c,
                [False, True, False]), iters)
        bound, by, core = dw_bound_ms(b, h, w, c, 2)
        row = {"name": name, "shape": [b, h, w, c], "count": count,
               "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2, "library_ms": lib_ms,
               "aten_weight_only_ms": aten_ms, "bound_ms": bound, "bound_by": by,
               "fp32_core_floor_ms": core, "turns": t}
        times.append(row)
        log(f"[kernels] dw7_wgrad {name} {(b, h, w, c)} bf16 (x{count} per step): kernel "
            f"{row['ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}; "
            f"CUDA-core floor {core:.4f}), cuDNN conv2d_weight {lib_ms:.4f} ms, weight-only "
            f"convolution_backward {aten_ms:.4f} ms (twin,kernel,kernel,twin: "
            f"{t['plain'][0]:.4f},{t['kernel'][0]:.4f},{t['kernel'][1]:.4f},{t['plain'][1]:.4f}) "
            f"on {card}")
        del x, dy, xn, dyn
    for shape in DW_EXTRA:
        x = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
        dy = (0.1 * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)
        rows.append(compare_dw(x, dy, f"{shape} bfloat16"))
        rows.append(compare_dw(x.float(), dy.float(), f"{shape} float32"))
    keys = ("ms", "plain_ms", "library_ms", "aten_weight_only_ms", "bound_ms", "fp32_core_floor_ms")
    totals = {k: sum(r["count"] * r[k] for r in times) for k in keys}
    totals["over_library"] = totals["ms"] / totals["library_ms"]
    log(f"[kernels] per {GA_CONVNEXT} train step (ms, weighted by launches): "
        + ", ".join(f"{k} {v:.4f}" for k, v in totals.items()) + f" on {card}")
    log(f"[kernels] kernel 9 over cuDNN's conv2d_weight per step: {totals['over_library']:.3f}; by "
        f"shape: " + ", ".join(f"{r['name']} {r['ms'] / r['library_ms']:.3f}" for r in times))
    totals["code"] = code_report(build, "dw7_wgrad")
    torch.cuda.empty_cache()
    return rows, times, totals


def launch_counts():
    """(kernel 1, kernel 2, kernel 9) launches so far."""
    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops
    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd

    return fused_ln_mlp.launches, fused_ln_mlp_bwd.launches, dw_ops.fused_dw7_wgrad.launches


def train_ga():
    """Phase 20: six kernel-path steps of the GA recipe with IMTPU_DW_WGRAD at
    "1" and the launches of kernels 1, 2 and 9 per step, and one plain-path
    step from a deep copy of the first state (no launch), whose loss, grad
    norm and gradients must agree with the kernel path's first step and an
    fp32 model's, as in phase 6."""
    import torch

    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops
    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd
    from imagenet_models_tpu_torch.train.state import make_train_step

    dw_ops._DW_WGRAD = "1"
    torch.cuda.reset_peak_memory_stats()
    state, kernel_opt, loss_fn = ga_trainer(GA_CONVNEXT, torch.bfloat16, **GA_TRAIN_KW)
    plain_state = copy.deepcopy(state)
    off_states = [copy.deepcopy(state), copy.deepcopy(state)]  # two steps at "0"
    plain_opt = FirstGrads(kernel_opt.opt)
    first = {k: p.detach().clone() for k, p in state.params().items()}
    kw = dict(dec_lam=-0.8, ema_decay=GA_EMA)
    step = make_train_step(state.model, kernel_opt, loss_fn, **kw)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, use_kernel=False, **kw)
    images, targets = train_batch()
    gen = torch.Generator(device="cuda")
    captured, real_wgrad = [], dw_ops.dw7_wgrad

    def capture(x, dy):  # the first step's inputs and outputs of kernel 9
        out = real_wgrad(x, dy)
        captured.append((x.detach(), dy.detach(), out.detach()))
        return out

    fused_ln_mlp.launches = fused_ln_mlp_bwd.launches = dw_ops.fused_dw7_wgrad.launches = 0
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        dw_ops.dw7_wgrad = capture if i == 0 else real_wgrad
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10 + i))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append(tuple(a - b for a, b in zip(launch_counts(), before)))
    dw_ops.dw7_wgrad = real_wgrad
    torch.cuda.synchronize()
    launches = dict(zip(("fwd", "bwd", "dw_wgrad"), launch_counts()))
    log(f"[ga-train] {TRAIN_STEPS} steps of B={TRAIN_BATCH} in {time.perf_counter() - t0:.2f} s "
        f"(first includes warm-up); (kernel 1, kernel 2, kernel 9) launches per step: {per_step}")
    log("[ga-train] loss per step: " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
        + "; grad_norm per step: " + ", ".join(f"{m['grad_norm']:.6f}" for m in metrics))
    if per_step != [(GA_LAUNCHES,) * 3] * TRAIN_STEPS:
        raise AssertionError(f"expected {GA_LAUNCHES} launches of each kernel per step, "
                             f"got {per_step}")
    for m in metrics:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite train metrics: {metrics}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise AssertionError("the loss did not fall over six steps on a fixed batch")
    ema_moved = max((state.ema_params[k] - first[k]).abs().max().item() for k in first)
    moved = max((p.detach() - first[k]).abs().max().item() for k, p in state.params().items())
    log(f"[ga-train] largest move from the initial weights: params {moved:.4g}, EMA shadow "
        f"{ema_moved:.4g}")
    if not 0.0 < ema_moved < moved:
        raise AssertionError("the EMA shadow did not move, or moved as far as the params")

    before = launch_counts()
    plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
    if launch_counts() != before:
        raise AssertionError("the plain path launched a kernel")
    pm = {k: v.item() for k, v in pm.items()}
    loss_rel = abs(metrics[0]["loss"] - pm["loss"]) / abs(pm["loss"])
    gnorm_rel = abs(metrics[0]["grad_norm"] - pm["grad_norm"]) / abs(pm["grad_norm"])
    log(f"[ga-train] first step, kernel vs plain path: loss {metrics[0]['loss']:.6f} vs "
        f"{pm['loss']:.6f} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}); grad_norm "
        f"{metrics[0]['grad_norm']:.6f} vs {pm['grad_norm']:.6f} (rel {gnorm_rel:.3g}, not gated)")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    fp32_state, fp32_opt, _ = ga_trainer(GA_CONVNEXT, torch.float32, **GA_TRAIN_KW)
    fp32_step = make_train_step(fp32_state.model, fp32_opt, loss_fn, use_kernel=False, **kw)
    fp32_step(fp32_state, images, targets, gen.manual_seed(SEED + 10))
    del fp32_state
    grads = compare_grads(kernel_opt.grads, plain_opt.grads, fp32_opt.grads, "ga-", GA_ZERO_GRAD,
                          gates=("ratio",))
    on_path = check_path_dw(captured)
    del captured
    switch = compare_switch(off_states, kernel_opt, loss_fn, metrics[0], images, targets, gen)
    kernel_opt.grads = plain_opt.grads = fp32_opt.grads = {}
    del off_states
    torch.cuda.empty_cache()
    check = {"losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
             "plain_loss": pm["loss"], "plain_grad_norm": pm["grad_norm"], "loss_rel": loss_rel,
             "grad_norm_rel": gnorm_rel, "grads_rel": grads, "dw_on_path": on_path,
             "switch": switch, "ema_moved": ema_moved, "params_moved": moved,
             "per_step": per_step}
    return (state, step), (plain_state, plain_step), images, targets, launches, check


def check_path_dw(captured) -> dict:
    """Kernel 9 on the path: each (x, dy) the first train step gave it,
    against float64 sums of the (rounded) products and the twin, within
    DW_SUM_RTOL of the tap's sum of |terms|."""
    import torch

    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops

    worst = {"vs_fp64": 0.0, "vs_twin": 0.0}
    shapes = []
    for x, dy, got in captured:
        exact, size = dw_fp64(x, dy)
        size = size.clamp_min(1e-30)
        twin = dw_ops.plain_dw7_wgrad(x, dy)
        worst["vs_fp64"] = max(worst["vs_fp64"], ((got.double() - exact).abs() / size).max().item())
        worst["vs_twin"] = max(worst["vs_twin"],
                               ((got.double() - twin.double()).abs() / size).max().item())
        shapes.append(f"{tuple(x.shape)} {str(x.dtype).replace('torch.', '')}")
        del exact, size, twin
    counts = {k: shapes.count(k) for k in dict.fromkeys(shapes)}
    log(f"[ga-train] kernel 9 on the first step's own inputs ({len(captured)} launches: "
        + ", ".join(f"{k} x{n}" for k, n in counts.items())
        + f"): |kernel - fp64| / sum|terms| at most {worst['vs_fp64']:.3g}, vs twin "
        f"{worst['vs_twin']:.3g} (tol {DW_SUM_RTOL})")
    if len(captured) != GA_LAUNCHES or not (worst["vs_fp64"] <= DW_SUM_RTOL
                                            and worst["vs_twin"] <= DW_SUM_RTOL):
        raise AssertionError(f"kernel 9 disagrees on the path's inputs: {worst}, "
                             f"{len(captured)} launches")
    torch.cuda.empty_cache()
    return {**worst, "launches": len(captured), "shapes": counts}


def compare_switch(off_states, kernel_opt, loss_fn, first_metrics, images, targets, gen) -> dict:
    """The kernel path's first step with IMTPU_DW_WGRAD at "0" (cuDNN's dw
    weight gradient), twice, from the same state and draws as phase 20's
    first step at "1": kernels 1 and 2 launch as at "1", kernel 9 not at all;
    loss and grad norm within DW_SWITCH_RTOL of the step at "1"; by group, the
    distance of "1" from "0" beside that of the two "0" steps (logged)."""
    import torch

    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops
    from imagenet_models_tpu_torch.train.state import make_train_step

    dw_ops._DW_WGRAD = "0"
    runs = []
    for st in off_states:
        opt = FirstGrads(kernel_opt.opt)
        step = make_train_step(st.model, opt, loss_fn, dec_lam=-0.8, ema_decay=GA_EMA)
        before = launch_counts()
        _, m = step(st, images, targets, gen.manual_seed(SEED + 10))
        runs.append((tuple(a - b for a, b in zip(launch_counts(), before)),
                     {k: v.item() for k, v in m.items()}, opt.grads))
    dw_ops._DW_WGRAD = "1"
    on = kernel_opt.grads
    (launched, m, off), (launched2, _, off2) = runs
    rows = []
    for (stage, kind), keys in grad_groups(on).items():
        cat = lambda g: torch.cat([g[k].float().flatten() for k in keys])
        rows.append({"stage": stage, "kind": kind, "on_vs_off": rel_l2(cat(on), cat(off)),
                     "off_vs_off": rel_l2(cat(off2), cat(off))})

    def worst(rows, key):
        r = max(rows, key=lambda r: r[key])
        return f"{r[key]:.4g} (stage {r['stage']} {r['kind']})"

    dw_rows = [r for r in rows if r["kind"].startswith("conv_dw.")]
    other = [r for r in rows if not r["kind"].startswith("conv_dw.")]
    loss_rel = abs(first_metrics["loss"] - m["loss"]) / abs(m["loss"])
    gnorm_rel = abs(first_metrics["grad_norm"] - m["grad_norm"]) / abs(m["grad_norm"])
    log(f"[ga-train] first step, kernel path at IMTPU_DW_WGRAD '1' vs '0' (launches at '0': "
        f"{launched}, {launched2}): loss {loss_rel:.3g}, grad_norm {gnorm_rel:.3g} (tol "
        f"{DW_SWITCH_RTOL}); by group (L2, logged), dw conv groups '1' vs '0' at most "
        f"{worst(dw_rows, 'on_vs_off')}, '0' vs '0' {worst(dw_rows, 'off_vs_off')}; other "
        f"groups '1' vs '0' {worst(other, 'on_vs_off')}, '0' vs '0' {worst(other, 'off_vs_off')}")
    if launched != (GA_LAUNCHES, GA_LAUNCHES, 0) or launched2 != launched:
        raise AssertionError(f"at '0' expected ({GA_LAUNCHES}, {GA_LAUNCHES}, 0) launches, "
                             f"got {launched}, {launched2}")
    if not (loss_rel <= DW_SWITCH_RTOL and gnorm_rel <= DW_SWITCH_RTOL):
        raise AssertionError("the kernel path's step at IMTPU_DW_WGRAD '1' disagrees with '0'")
    return {"groups": rows, "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
            "launches_at_0": launched}


def convnext_dw_arms(card: str) -> dict:
    """map_convnext_tiny's train img/s with IMTPU_DW_WGRAD at "1" against "0",
    one pair of turns, on phase 6's recipe (its 18 blocks take kernel 9 at
    "1")."""
    import torch

    from imagenet_models_tpu_torch.train.state import make_train_step

    state, opt, loss_fn = make_trainer()
    step = make_train_step(state.model, opt, loss_fn, dec_lam=-0.8, ema_decay=0.9999)
    images, targets = train_batch()
    out = switch_arms("IMTPU_DW_WGRAD", (state, step), None, images, targets, card,
                      "map_convnext_tiny (LAMB, EMA)", (("1", "kernel"), ("0", "kernel")))
    del state, step, images, targets
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- the opt-in routes

def flash_args(kernel: str, bw: int, heads: int, n: int, d: int, bias: bool, dtype, gen):
    """q, k, v and the bias of one launch: kernel "13" (bw, heads, n, d) with
    an (heads, n, n) bias, kernel "12" (bw * heads, n, d) with an optional
    (bw * heads, n, n) bias; q pre-scaled as the routes scale it."""
    import torch

    shape = (bw, heads, n, d) if kernel == "13" else (bw * heads, n, d)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    q = q * torch.tensor(d ** -0.5, dtype=dtype, device="cuda")
    b = None
    if bias:
        b = 0.5 * torch.randn((heads, n, n) if kernel == "13" else (bw * heads, n, n),
                              generator=gen, device="cuda")
    return q, k, v, b


def flash_bound_ms(kernel: str, bw: int, heads: int, n: int, d: int, bias: bool,
                   itemsize: int) -> tuple:
    """The least time of one launch: the larger of its operations (4 n^2 d
    per window and head) over the peak of its type and its bytes (q, k, v
    read once and out written once; the bias per window for kernel 12, once
    per head for kernel 13) over the memory rate."""
    pairs = bw * heads
    nbytes = 4 * pairs * n * d * itemsize
    if bias:
        nbytes += (heads if kernel == "13" else pairs) * n * n * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = 4 * pairs * n * n * d / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_fp64(kernel: str, q, k, v, b):
    """The float64 function of kernel 12's ("12") or 13's inputs: softmax(q
    k^T [+ bias]) v, the bias per window for kernel 12, per head for 13."""
    import torch

    s = torch.matmul(q.double(), k.double().transpose(-1, -2))
    if b is not None:
        s = s + (b.double()[None] if kernel == "13" else b.double())
    return torch.matmul(torch.softmax(s, -1), v.double())


def check_flash(card: str, builds):
    """Phase 21: kernels 12 and 13 against their twins at the paths' shapes
    (MaxViT's four eval stages at B=256 for kernel 13, GA-CSWin's six shapes
    at B=128 for kernel 12) and off them (FLASH_EXTRA), in bf16 and fp32, each
    bit-equal between two runs, in bf16 also against the float64 function of
    their inputs (each error at most FLASH_FP64_RATIO times the twin's);
    kernel 12's fp32 bits against its CUDA-core build (K12_FP32_DIGEST);
    per-launch times at the path shapes in bf16, in turns (twin, kernel,
    SDPA, SDPA, kernel, twin), beside the bound, their sums per forward and
    the kernels' over SDPA's; both kernels' code reports, with HMMA asserted
    in every bf16 (tensor-core) instance. SDPA
    (`F.scaled_dot_product_attention` with the bias as its mask) is the
    library yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from imagenet_models_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    cases = ([("13", BENCH_BATCH * w, h, 49, FLASH_D, True, tag)
              for tag, w, h, _ in MAXVIT_FLASH_SHAPES]
             + [("12", TRAIN_BATCH * w, 1, n, FLASH_D, False, tag)
                for tag, w, n, _ in CSWIN_FLASH_SHAPES]
             + [(*e, "extra") for e in FLASH_EXTRA])
    rows, times = [], {"12": [], "13": []}
    for kernel, bw, heads, n, d, bias, tag in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, b = flash_args(kernel, bw, heads, n, d, bias, dtype, gen)
            fused, twin = ((fa.fused_window_attention_heads, fa.plain_fused_window_attention_heads)
                           if kernel == "13" else
                           (fa.fused_window_attention, fa.plain_fused_window_attention))
            with torch.inference_mode():
                got = fused(q, k, v, b)
                again = fused(q, k, v, b)
                ref = twin(q, k, v, b)
                torch.cuda.synchronize()
            ratio = rel_err(got, ref)
            tol = KERNEL_RTOL if dtype == torch.bfloat16 else FLASH_FP32_RTOL
            same = torch.equal(got, again)
            shape = tuple(q.shape)
            fp64 = ""
            if dtype == torch.bfloat16:
                with torch.inference_mode():
                    exact = flash_fp64(kernel, q, k, v, b)
                    e_kernel = (got.double() - exact).abs().max().item()
                    e_twin = (ref.double() - exact).abs().max().item()
                del exact
                fp64 = (f", max|err| vs float64 kernel {e_kernel:.4g} twin {e_twin:.4g} (ratio "
                        f"{e_kernel / max(e_twin, 1e-30):.3f}, limit {FLASH_FP64_RATIO})")
            log(f"[kernels] window_attn{'_heads' if kernel == '13' else ''}_fwd {tag} {shape} "
                f"{str(dtype)[6:]}{' bias' if bias else ''}: max|kernel-twin|/max|twin| = "
                f"{ratio:.4g} (tol {tol}), bit-equal between runs: {same}{fp64}")
            if not (ratio <= tol and same and torch.isfinite(got.float()).all()):
                raise AssertionError(f"kernel {kernel} disagrees with its twin at {shape} "
                                     f"{dtype}: {ratio}, bit-equal {same}")
            if fp64 and not e_kernel <= FLASH_FP64_RATIO * e_twin:
                raise AssertionError(f"kernel {kernel} is farther from float64 than its twin at "
                                     f"{shape}: {e_kernel} against {e_twin}")
            rows.append({"kernel": kernel, "tag": tag, "shape": list(shape), "dtype": str(dtype),
                         "bias": bias, "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                         "err_over_max_twin": ratio,
                         **({"fp64_err": e_kernel, "twin_fp64_err": e_twin} if fp64 else {})})
            if tag == "extra" or dtype != torch.bfloat16:
                continue
            mask = None if b is None else (b[None] if kernel == "13" else b).to(dtype)
            with torch.inference_mode():
                t = in_turns({"plain": lambda: twin(q, k, v, b), "kernel": lambda: fused(q, k, v, b),
                              "library": lambda: F.scaled_dot_product_attention(
                                  q, k, v, attn_mask=mask, scale=1.0)},
                             20, order=("plain", "kernel", "library"))
            bound, by = flash_bound_ms(kernel, bw, heads, n, d, bias, 2)
            row = {"tag": tag, "shape": list(shape), "ms": sum(t["kernel"]) / 2,
                   "plain_ms": sum(t["plain"]) / 2, "library_ms": sum(t["library"]) / 2,
                   "bound_ms": bound, "bound_by": by, "turns": t}
            times[kernel].append(row)
            log(f"[kernels]   {tag} {shape}: kernel {row['ms']:.4f} ms, twin "
                f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, bound {bound:.4f} ms "
                f"({by}) on {card}")
            del q, k, v, b, got, again, ref
    for kernel, weights, what in (("13", MAXVIT_FLASH_WEIGHTS, f"{MAXVIT} eval forward, B=256"),
                                  ("12", CSWIN_FLASH_WEIGHTS, f"{GA_CSWIN} forward, B=128")):
        over = weighted(times[kernel], "ms", weights) / weighted(times[kernel], "library_ms", weights)
        by_shape = ", ".join(f"{r['tag']} {r['ms'] / r['library_ms']:.3f}" for r in times[kernel])
        log(f"[kernels] kernel {kernel} per {what}: " + ", ".join(
            f"{key} {weighted(times[kernel], key, weights):.3f} ms"
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"))
            + f"; kernel over SDPA {over:.3f} (by shape {by_shape})")
    digest = k12_digest(fa.fused_window_attention)
    log(f"[kernels] kernel 12's fp32 bits at k12_digest's inputs: {digest}; the CUDA-core "
        f"build's: {K12_FP32_DIGEST}")
    if digest != K12_FP32_DIGEST:
        raise AssertionError("kernel 12's fp32 instance no longer gives its CUDA-core build's bits")
    code = {}
    for name in ("window_attn_fwd", "window_attn_heads_fwd"):
        report = code[name] = code_report(builds[name], name)
        mma = {k: v.get("HMMA", 0) for k, v in report["sass"].items() if "_mma" in k}
        log(f"[code] {name}: HMMA in each of its {len(mma)} bf16 instances: "
            + ", ".join(f"{v}" for v in mma.values()))
        if report["sass"] and not (mma and all(mma.values())):
            raise AssertionError(f"{name}'s bf16 instances hold no mma instruction: {mma}")
    torch.cuda.empty_cache()
    return rows, times, {"k12_fp32_digest": digest, "code": code}


def flash_maxvit(card: str) -> dict:
    """Phase 22: map_maxvit_tiny_tf_224 with IMTPU_FLASH_ATTN at "1" (the
    caller sets it): serving with 22 launches of kernel 13 per request (and
    none of kernels 3, 4 and 12), logits against the plain path and an fp32
    model, one eval step, eval img/s at "1" and "0" in turns; three train
    steps (OPT_IN_STEPS) of the maxvit recipe with 4 launches of kernel 13 per step beside
    the 18 each of kernels 3 and 4, one plain-path step checked as in phase
    10; train img/s at "1" and "0" in turns. "launches" is kernel 13's count
    over the whole phase, set to 0 before it."""
    import torch

    from imagenet_models_tpu_torch.ops import flash_attention as fa
    from imagenet_models_tpu_torch.ops import partition_attention as pa

    heads = fa.fused_window_attention_heads
    heads.launches = 0
    served, serve = serve_branches(
        card, MAXVIT, (heads, pa.fused_partition_attention, pa.fused_partition_attention_bwd,
                       fa.fused_window_attention), MAXVIT_FLASH_LAUNCHES, "maxvit-flash-",
        arms="IMTPU_FLASH_ATTN")
    phase_launches = heads.launches  # the trainer sets the counts to 0
    kernel, plain, images, targets, launches, check = train_maxvit(
        ((pa.fused_partition_attention, MAXVIT_LAUNCHES),
         (pa.fused_partition_attention_bwd, MAXVIT_LAUNCHES),
         (heads, MAXVIT_FLASH_TRAIN_LAUNCHES)), steps=OPT_IN_STEPS, tag="maxvit-flash-")
    del plain
    arms = switch_arms("IMTPU_FLASH_ATTN", kernel, None, images, targets, card,
                       f"{MAXVIT} (LAMB, clip 1.0, drop-path 0.2)", (("1", "kernel"), ("0", "kernel")),
                       **OPT_IN_TURNS)
    del kernel, images, targets
    torch.cuda.empty_cache()
    return {"serving": serve, "serving_launches": served, "train": check,
            "train_launches": launches, "train_arms": arms,
            "launches": phase_launches + heads.launches}


def flash_cswin(card: str) -> dict:
    """Phase 23: ga_cswin_tiny with IMTPU_FLASH_ATTN at "1" (the caller sets
    it): serving with one launch of kernel 12 per LePEAttention call (61,
    counted from the model) and none of kernels 5, 6 and 13, logits against
    the plain path and an fp32 model, one eval step, eval img/s at "1" and
    "0" in turns; three train steps (OPT_IN_STEPS) of the benchkit recipe
    with 61 launches of kernel 12 per step and none of kernels 5 and 6, one plain-path step
    checked as in phase 13; train img/s at "1" and "0" in turns. "launches"
    is kernel 12's count over the whole phase, set to 0 before it."""
    import torch

    from imagenet_models_tpu_torch.ops import cswin_attention as ca
    from imagenet_models_tpu_torch.ops import flash_attention as fa
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    window = fa.fused_window_attention
    window.launches = 0
    served, serve = serve_branches(
        card, GA_CSWIN, (window, sa.fused_stripe_attention, sa.fused_stripe_attention_bwd,
                         fa.fused_window_attention_heads), CSWIN_FLASH_LAUNCHES, "cswin-flash-",
        arms="IMTPU_FLASH_ATTN", calls=ca.LePEAttention)
    phase_launches = window.launches  # the trainer sets the counts to 0
    kernel, plain, images, targets, launches, check = train_cswin(
        ((sa.fused_stripe_attention, 0), (sa.fused_stripe_attention_bwd, 0),
         (window, CSWIN_FLASH_LAUNCHES)), steps=OPT_IN_STEPS, tag="cswin-flash-")
    del plain
    arms = switch_arms("IMTPU_FLASH_ATTN", kernel, None, images, targets, card,
                       f"{GA_CSWIN} (LAMB, EMA)", (("1", "kernel"), ("0", "kernel")),
                       **OPT_IN_TURNS)
    del kernel, images, targets
    torch.cuda.empty_cache()
    return {"serving": serve, "serving_launches": served, "train": check,
            "train_launches": launches, "train_arms": arms,
            "launches": phase_launches + window.launches}


def tlnmlp_arms(card: str) -> dict:
    """Phase 24: IMTPU_TLNMLP at "1" (the caller sets it; IMTPU_FLASH_ATTN at
    "0") on map_maxvit_tiny_tf_224 and ga_cswin_tiny: two train steps each
    with kernels 1 and 2 launched once per eligible MLP (22 and 31) beside
    the attention kernels, one eval forward with one launch of kernel 1 per
    MLP, the first step against the plain path and an fp32 model as in
    phases 10 and 13 but by TLNMLP_GRAD_GATES; train img/s at "1" and "0",
    one pair of turns, and a profile of one step at each, with the device
    time of the elementwise kernels (the fast GELU's chains among them) and
    of kernels 1 and 2."""
    import torch

    from imagenet_models_tpu_torch.models.maxvit import PartitionAttention
    from imagenet_models_tpu_torch.ops import cswin_attention as ca
    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    fwd, bwd = cb.fused_ln_mlp, cb.fused_ln_mlp_bwd
    out = {}
    for name, train, attn, mlps, is_mlp, what in (
            (MAXVIT, train_maxvit, (pa.fused_partition_attention, pa.fused_partition_attention_bwd,
                                    MAXVIT_LAUNCHES), MAXVIT_MLPS,
             lambda m: isinstance(m, PartitionAttention), "(LAMB, clip 1.0, drop-path 0.2)"),
            (GA_CSWIN, train_cswin, (sa.fused_stripe_attention, sa.fused_stripe_attention_bwd,
                                     CSWIN_LAUNCHES), CSWIN_MLPS,
             lambda m: isinstance(m, ca.CSWinBlock) and m.mlp_groups == 1, "(LAMB, EMA)")):
        tag = "maxvit-tlnmlp-" if name == MAXVIT else "cswin-tlnmlp-"
        a_fwd, a_bwd, a_n = attn
        kernel, plain, images, targets, launches, check = train(
            ((a_fwd, a_n), (a_bwd, a_n), (fwd, mlps), (bwd, mlps)), steps=2, tag=tag,
            gates=TLNMLP_GRAD_GATES[name])
        del plain
        model = kernel[0].model
        found = sum(map(is_mlp, model.modules()))
        before = fwd.launches
        model.eval()
        with torch.inference_mode():
            model(images[:REQUEST_BATCH])
        eval_launches = fwd.launches - before
        model.train()
        log(f"[{tag}train] {found} eligible MLPs; one eval forward launched kernel 1 "
            f"{eval_launches} times")
        if not found == mlps == eval_launches:
            raise AssertionError(f"{name}: {found} eligible MLPs, {eval_launches} launches of "
                                 f"kernel 1 in an eval forward, {mlps} expected")
        arms = switch_arms("IMTPU_TLNMLP", kernel, None, images, targets, card, f"{name} {what}",
                           (("1", "kernel"), ("0", "kernel")), **OPT_IN_TURNS)
        profiles = {}
        for mode in ("1", "0"):
            cb._TLNMLP = mode
            profiles[mode] = profile_step(kernel, images, targets,
                                          f"{name} (IMTPU_TLNMLP {mode!r})", top=8)
        cb._TLNMLP = "1"
        log(f"[{tag}profile] IMTPU_TLNMLP 0 -> 1: elementwise kernels "
            f"{profiles['0']['elementwise_ms']:.2f} -> {profiles['1']['elementwise_ms']:.2f} ms, "
            f"kernels 1 and 2 {profiles['0']['ln_mlp_ms']:.2f} -> "
            f"{profiles['1']['ln_mlp_ms']:.2f} ms, device busy {profiles['0']['busy_ms']:.2f} -> "
            f"{profiles['1']['busy_ms']:.2f} ms")
        out[name] = {"train": check, "train_launches": launches, "eval_launches": eval_launches,
                     "train_arms": arms, "profiles": profiles}
        del kernel, images, targets, model
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- the fused ConvNeXt branch

def branch_args(b: int, h: int, w: int, c: int, dtype, gen):
    """x, a cotangent g (both `dtype`) and the branch's parameters in the
    port's layout (fp32; the wrappers cast the weights to x's dtype) for one
    launch on a (b, h, w, c) map, hidden 4c."""
    import torch

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    x = randn(b, h, w, c).to(dtype)
    g = randn(b, h, w, c).to(dtype)
    params = [randn(c, 1, 7, 7, scale=0.1), randn(c, scale=0.1), randn(c, scale=0.1, shift=1.0),
              randn(c, scale=0.1), randn(4 * c, c, scale=c ** -0.5), randn(4 * c, scale=0.1),
              randn(c, 4 * c, scale=(4 * c) ** -0.5), randn(c, scale=0.1), randn(c)]
    return x, g, params


def branch_bound_ms(b: int, h: int, w: int, c: int, backward: bool) -> tuple:
    """The least time of one bf16 launch of kernel 10 (or 11) on a (b, h, w, c)
    map, hidden 4c: the larger of its operations over the bf16 peak and its
    bytes (each input read once, each output written once) over the memory
    rate. Operations: the products, 2 N C 4C each (two in the forward; five in
    the backward: pre1, dhmid, dln, dW1 and G = g^T hmid, which gives dW2 =
    gamma * G and dgamma = sum_j W2 * G + b2 * sum_t g, so pre2 need not be
    formed, as bound_ms counts kernel 2), and the conv's 49 multiply-adds per
    element (once in the forward; the recomputed conv, dx and the tap
    gradient in the backward)."""
    n, hid = b * h * w, 4 * c
    product, conv = 2 * n * c * hid, 2 * 49 * n * c
    vectors = (hid + 5 * c) * 4  # dw_b, ln_s, ln_b, b1, b2, gamma
    if backward:
        flops = 5 * product + 3 * conv
        nbytes = 3 * n * c * 2 + 2 * hid * c * (2 + 4) + 2 * 49 * c * 4 + 2 * vectors
    else:
        flops = 2 * product + conv
        nbytes = 2 * n * c * 2 + 2 * hid * c * 2 + 49 * c * 4 + vectors
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare_branch(x, g, params, tag: str) -> dict:
    """Kernels 10 and 11 against their twins on the same inputs, every output
    (out; GRAD_NAMES), each kernel run twice and bit-equal between the runs;
    raises past KERNEL_RTOL (bf16) or BRANCH_FP32_RTOL (fp32). In fp32 the
    twin with TF32 on (one-pass products) is read against the exact twin too,
    and must fall outside BRANCH_FP32_RTOL: the limit has to catch a kernel
    that lost the 3xTF32 precision."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    tol = KERNEL_RTOL if x.dtype == torch.bfloat16 else BRANCH_FP32_RTOL
    with torch.inference_mode():
        run = lambda: ((cbr.fused_convnext_branch(x, *params),)
                       + cbr.fused_convnext_branch_bwd(x, g, *params))
        got, again = run(), run()
        torch.cuda.synchronize()
        twin = lambda: ((cbr.plain_convnext_branch(x, *params),)
                        + cbr.plain_convnext_branch_bwd(x, g, *params))
        ref = twin()
        tf32 = None
        if x.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                one_pass = twin()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            tf32 = max(rel_err(o, r) for o, r in zip(one_pass, ref))
            del one_pass
    names = ("out",) + cbr.GRAD_NAMES
    ratios, errs, same = {}, {}, {}
    for name, o, a, r in zip(names, got, again, ref):
        if o.shape != r.shape or o.dtype != r.dtype or not torch.isfinite(o.float()).all():
            raise AssertionError(f"branch kernel output {name} {tag}: {tuple(o.shape)} {o.dtype}, "
                                 f"twin {tuple(r.shape)} {r.dtype}, or not finite")
        ratios[name] = rel_err(o, r)
        errs[name] = (o.float() - r.float()).abs().max().item()
        same[name] = torch.equal(o, a)
    log(f"[branch] {tag}: max|kernel-twin|/max|twin| " + " ".join(f"{k}={v:.3g}"
                                                                for k, v in ratios.items())
        + f" (tol {tol}); bit-equal between runs: {all(same.values())}"
        + ("" if tf32 is None else f"; the TF32 twin's worst {tf32:.3g}"))
    bad = [k for k in names if not ratios[k] <= tol]
    unequal = [k for k in names if not same[k]]
    if bad or unequal:
        raise AssertionError(f"branch kernels {tag}: outside the tolerance {bad}, not bit-equal "
                             f"between runs {unequal}")
    if tf32 is not None and not tf32 > tol:
        raise AssertionError(f"branch kernels {tag}: one-pass TF32 products read {tf32:.3g}, "
                             f"within the fp32 tolerance {tol}: it cannot tell them from 3xTF32")
    return {"tag": tag, "ratios": ratios, "bit_equal": True, "tf32_twin_worst": tf32,
            "max_abs_err": {"fwd": errs["out"], "bwd": max(errs[k] for k in cbr.GRAD_NAMES)}}


def block_route_fns(x, g, params):
    """The block route's forward and backward on the branch's inputs: the
    same work as the calls the default ConvNeXt block makes today. Forward,
    cuDNN's depthwise conv (`dw_conv7`) and kernel 1 with the exact GELU;
    backward, kernel 2 (exact GELU) on the saved conv output and cuDNN's
    depthwise data and weight gradients (`aten.convolution_backward`)."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd
    from imagenet_models_tpu_torch.ops.dw_conv import dw_conv7

    b, h, w, c = x.shape
    n = b * h * w
    dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma = params
    mlp = (ln_s, ln_b, w1, b1, w2, b2, gamma)
    xn, weight = x.permute(0, 3, 1, 2), dw_w.to(x.dtype)
    hmap = dw_conv7(x, dw_w, dw_b).contiguous().reshape(n, c)  # the saved conv output
    g2 = g.reshape(n, c)

    def block_fwd():
        return fused_ln_mlp(dw_conv7(x, dw_w, dw_b).reshape(n, c), *mlp, gelu_impl="exact")

    def block_bwd():
        dh = fused_ln_mlp_bwd(hmap, g2, *mlp, gelu_impl="exact")[0]
        return torch.ops.aten.convolution_backward(
            dh.reshape(b, h, w, c).permute(0, 3, 1, 2), xn, weight, [c], [1, 1], [3, 3], [1, 1],
            False, [0, 0], c, [True, True, True])

    return block_fwd, block_bwd


def branch_times(x, g, params, count: int, card: str, tag: str) -> tuple:
    """Per-launch times of kernels 10 and 11 at one bf16 path shape in turns
    (twin, kernel, block route, block route, kernel, twin), beside the bound
    and the block route (`block_route_fns`). No single PyTorch call computes
    the branch, so there is no library time."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    b, h, w, c = x.shape
    n = b * h * w
    block_fwd, block_bwd = block_route_fns(x, g, params)
    order = ("plain", "kernel", "block")
    rows = []
    with torch.inference_mode():
        for what, fns, iters in (
                ("fwd", {"plain": lambda: cbr.plain_convnext_branch(x, *params),
                         "kernel": lambda: cbr.fused_convnext_branch(x, *params),
                         "block": block_fwd}, max(3, min(20, 4_000_000 // n))),
                ("bwd", {"plain": lambda: cbr.plain_convnext_branch_bwd(x, g, *params),
                         "kernel": lambda: cbr.fused_convnext_branch_bwd(x, g, *params),
                         "block": block_bwd}, max(3, min(10, 2_000_000 // n)))):
            t = in_turns(fns, iters, order=order)
            # each stage of the kernel's bf16 pipeline alone
            run, names = ((cbr.convnext_branch_fwd_pipeline(x, *params), cbr.FWD_STAGES)
                          if what == "fwd" else
                          (cbr.convnext_branch_bwd_pipeline(x, g, *params), cbr.BWD_STAGES))
            stages = {st: cuda_ms(lambda s=s: run(s, s + 1), iters) for s, st in enumerate(names)}
            bound, by = branch_bound_ms(b, h, w, c, what == "bwd")
            row = {"tag": tag, "shape": [b, h, w, c], "count": count, "ms": sum(t["kernel"]) / 2,
                   "plain_ms": sum(t["plain"]) / 2, "block_ms": sum(t["block"]) / 2,
                   "library_ms": None, "bound_ms": bound, "bound_by": by, "stages_ms": stages,
                   "turns": t}
            rows.append(row)
            log(f"[branch] kernel {10 if what == 'fwd' else 11} {tag} {(b, h, w, c)} bf16 "
                f"(x{count} per {'forward' if what == 'fwd' else 'step'}): kernel "
                f"{row['ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, block route "
                f"{row['block_ms']:.4f} ms, bound {bound:.4f} ms ({by})"
                + "; stages alone " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                + " (turns twin,kernel,block,"
                f"block,kernel,twin: " + ",".join(f"{v:.4f}" for v in (
                    t["plain"][0], t["kernel"][0], t["block"][0], t["block"][1], t["kernel"][1],
                    t["plain"][1])) + f") on {card}")
    return rows[0], rows[1]


def device_ms_by_kernel(fn, calls: int = 3, want: str = "", per_launch: bool = False) -> dict:
    """Device milliseconds per call of `fn` by kernel name, from torch.profiler
    over `calls` calls (after one to warm up); up to two more windows while
    a window caught no device event (or none of the kernel `want`). Empty if
    none did. `per_launch`: milliseconds per launch the profiler caught
    instead (it may miss launches of a short kernel called many times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        out = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = ev.self_cuda_time_total
                name = re.split(r"[<(]", ev.key.replace("(anonymous namespace)::", ""))[0]
                name = name.split("::")[-1].replace("void ", "").strip()
                share = ev.count if per_launch else calls
                out[name] = out.get(name, 0.0) + dev_us / 1e3 / share
        if out and (not want or want in out):
            break
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def check_branch(card: str):
    """Phase 25 (a) and (b): kernels 10 and 11 against their twins in bf16 and
    fp32 at the four B=128 stage shapes of map_convnext_tiny and at
    BRANCH_EXTRA, bit-equal between runs; their fp32 bits (`k1011_digest`)
    against K1011_FP32_DIGEST; per-launch times at the path's bf16 shapes
    beside the bound, the twin and the block route, and their sums per
    forward (18 launches of kernel 10) and per train step (18 of each)."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    digest = k1011_digest(lambda x, p: cbr.fused_convnext_branch(x, *p),
                          lambda x, g, p: cbr.fused_convnext_branch_bwd(x, g, *p))
    log(f"[branch] kernels 10 and 11's fp32 bits at k1011_digest's inputs: {digest}; the first "
        f"design's build: {K1011_FP32_DIGEST}")
    if digest != K1011_FP32_DIGEST:
        raise AssertionError("the fp32 instances of kernels 10 and 11 moved from their bits")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    rows, times = [], {"fwd": [], "bwd": []}
    cases = ([(name, b, h, w, c, count) for name, b, h, w, c, count in BRANCH_SHAPES]
             + [(name, b, h, w, c, 0) for name, b, h, w, c in BRANCH_EXTRA])
    for name, b, h, w, c, count in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x, g, params = branch_args(b, h, w, c, dtype, gen)
            rows.append(compare_branch(x, g, params, f"{name} {(b, h, w, c)} {str(dtype)[6:]}"))
            if count and dtype == torch.bfloat16:
                fwd, bwd = branch_times(x, g, params, count, card, name)
                with torch.inference_mode():
                    fwd["device_ms"] = device_ms_by_kernel(lambda: cbr.fused_convnext_branch(
                        x, *params))
                    bwd["device_ms"] = device_ms_by_kernel(lambda: cbr.fused_convnext_branch_bwd(
                        x, g, *params))
                by_kernel = lambda ms: (", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                                        or "not captured by the profiler")
                log(f"[branch]   {name} device ms by kernel: kernel 10 "
                    f"{by_kernel(fwd['device_ms'])}; kernel 11 {by_kernel(bwd['device_ms'])}")
                times["fwd"].append(fwd)
                times["bwd"].append(bwd)
            del x, g, params
            torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "block_ms", "bound_ms")
    totals = {"forward": {k: weighted(times["fwd"], k, STAGE_DEPTHS) for k in keys},
              "step": {k: weighted(times["fwd"], k, STAGE_DEPTHS)
                       + weighted(times["bwd"], k, STAGE_DEPTHS) for k in keys}}
    for what, t in totals.items():
        log(f"[branch] per map_convnext_tiny {what} at B={TRAIN_BATCH} (ms, weighted by "
            f"launches): " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()) + f" on {card}")
    totals["fp32_digest"] = digest
    return rows, times, totals


def check_branch_code(builds) -> dict:
    """Kernels 10 and 11's code reports, where cuobjdump could read them:
    their bf16 GEMM stages (kernels 1 and 2's GEMM kernels, compiled into
    these libraries) must hold wgmma (HGMMA) and TMA loads (UTMALDG), and no
    function of a bf16 instance may hold an mma (HMMA) instruction: the first design's
    wmma products of bf16 operands are gone. The fp32 instances keep their
    3xTF32 wmma products (HMMA), counted apart."""
    codes = {name: code_report(builds[name], name)
             for name in ("convnext_branch_fwd", "convnext_branch_bwd")}
    summary = {}
    for name, code in codes.items():
        sass = code["sass"]
        if not sass:
            continue
        gemms = {k: (v.get("HGMMA", 0), v.get("UTMALDG", 0)) for k, v in sass.items()
                 if "_gemm_kernel" in k}
        bf16_mma = {k: v["HMMA"] for k, v in sass.items() if "bfloat16" in k and v.get("HMMA")}
        fp32_mma = sum(v.get("HMMA", 0) for k, v in sass.items() if "bfloat16" not in k)
        log(f"[code] {name}: (HGMMA, UTMALDG) in its {len(gemms)} bf16 GEMM stages: "
            + ", ".join(f"{a}/{b}" for a, b in gemms.values())
            + f"; HMMA in bf16 instances: {sum(bf16_mma.values())}; HMMA (3xTF32) in the fp32 "
            f"instances: {fp32_mma}")
        if not gemms or not all(a and b for a, b in gemms.values()) or bf16_mma:
            raise AssertionError(f"{name}: a bf16 GEMM stage without wgmma or TMA loads, or an "
                                 f"mma instruction in a bf16 instance: {gemms}, {bf16_mma}")
        summary[name] = {"gemm_hgmma_utmaldg": gemms, "bf16_hmma": bf16_mma,
                         "fp32_hmma": fp32_mma}
    return {"codes": codes, "summary": summary}


def branch_route():
    """The route of phase 25(c): a stand-in for the name `models/convnext.py`
    calls, `convnext_block_apply`, that drops `training` and calls
    `convnext_branch_apply` (the branch takes the exact GELU in training
    too). The phase binds it and restores the block route afterwards, as
    phases 15-24 set their switches; no switch enters the package."""
    from imagenet_models_tpu_torch.ops.convnext_branch import convnext_branch_apply

    def route(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps=1e-6, use_kernel=None,
              training=False):
        return convnext_branch_apply(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps,
                                     use_kernel)
    return route


def branch_counts():
    """(kernel 10, kernel 11, kernel 1, kernel 2) launches so far."""
    from imagenet_models_tpu_torch.ops import convnext_branch as cbr
    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd

    return (cbr.fused_convnext_branch.launches, cbr.fused_convnext_branch_bwd.launches,
            fused_ln_mlp.launches, fused_ln_mlp_bwd.launches)


def branch_serve(card: str, cx, route, block) -> dict:
    """Phase 25(c), serving on the branch route: four requests with 18
    launches of kernel 10 each and none of kernel 1, logits against the same
    route with use_kernel=False (the plain composition) and an fp32 model;
    one eval step; eval img/s at B=256, block route and branch route in
    turns."""
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.serving import make_serving_fn
    from imagenet_models_tpu_torch.train.state import make_eval_step

    n_blocks = sum(STAGE_DEPTHS)
    model = create_model("map_convnext_tiny", dtype=torch.bfloat16, ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    requests = [torch.randint(0, 256, (REQUEST_BATCH, IMG, IMG, 3), generator=gen,
                              device="cuda", dtype=torch.uint8) for _ in range(REQUESTS)]
    serve_fn = make_serving_fn(model)
    outputs, per_request = [], []
    for images in requests:
        before = branch_counts()
        outputs.append(serve_fn(images))
        per_request.append(tuple(a - b for a, b in zip(branch_counts(), before)))
    torch.cuda.synchronize()
    log(f"[branch-serving] {REQUESTS} requests of {REQUEST_BATCH}; (kernel 10, kernel 11, "
        f"kernel 1, kernel 2) launches per request: {per_request}")
    if per_request != [(n_blocks, 0, 0, 0)] * REQUESTS:
        raise AssertionError(f"expected {n_blocks} launches of kernel 10 per request and none of "
                             f"the others, got {per_request}")
    for logits in outputs:
        if logits.shape != (REQUEST_BATCH, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"malformed logits {tuple(logits.shape)}")
    before = branch_counts()
    plain = make_serving_fn(model, use_kernel=False)(requests[0])
    fp32 = create_model("map_convnext_tiny", ls_init_value=1.0,
                        generator=torch.Generator().manual_seed(SEED))
    ref = make_serving_fn(fp32, use_kernel=False)(requests[0])
    del fp32
    if branch_counts() != before:
        raise AssertionError("the branch route's plain composition launched a kernel")
    scale = plain.abs().max().item()
    err = (outputs[0] - plain).abs().max().item()
    err32 = (outputs[0] - ref).abs().max().item() / ref.abs().max().item()
    agree = (outputs[0].argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[branch-serving] logits vs the plain composition: max|diff| {err:.4g} (tol "
        f"{LOGITS_RTOL * scale:.4g}, max|plain| {scale:.4g}); vs an fp32 model on the route: "
        f"max|diff|/max|fp32| {err32:.4g} (tol {BRANCH_FP32_LOGITS_RTOL}), top-1 agreement "
        f"{agree:.3f}")
    if not (err <= LOGITS_RTOL * scale and err32 <= BRANCH_FP32_LOGITS_RTOL):
        raise AssertionError("branch-route logits disagree with the plain composition or fp32")
    step = make_eval_step(model)
    cfg = default_cfg("map_convnext_tiny")
    mean, std = (torch.tensor(cfg[k], device="cuda") for k in ("mean", "std"))
    x = (requests[1].float() / 255.0 - mean) / std
    targets = torch.randint(0, 1000, (REQUEST_BATCH,), generator=gen, device="cuda")
    before = branch_counts()[0]
    logits, top1, top5 = step(x, targets)
    if branch_counts()[0] - before != n_blocks:
        raise AssertionError("the eval step did not run every block through kernel 10")
    if not (logits - outputs[1]).abs().max().item() <= 1e-3 * scale:
        raise AssertionError("eval step logits differ from the serving logits on the same images")
    if not (top1 <= top5).all() or top1.shape != (REQUEST_BATCH,):
        raise AssertionError("eval step top-1/top-5 flags are malformed")

    xb = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    model.eval()

    def arm(apply):
        def run():
            cx.convnext_block_apply = apply
            model(xb)
        return run

    with torch.inference_mode():
        t = in_turns({"block": arm(block), "branch": arm(route)}, BENCH_ITERS,
                     order=("block", "branch"))
    cx.convnext_block_apply = route
    runs = {k: [BENCH_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[branch-throughput] map_convnext_tiny eval B={BENCH_BATCH} {IMG}px bf16: branch route "
        f"{result['branch']:.1f} img/s, block route {result['block']:.1f} img/s (turns block,"
        f"branch,branch,block: {runs['block'][0]:.1f},{runs['branch'][0]:.1f},"
        f"{runs['branch'][1]:.1f},{runs['block'][1]:.1f}) on {card}")
    del model, xb
    torch.cuda.empty_cache()
    return {"per_request": per_request, "max_abs_err": err, "max_abs_plain": scale,
            "fp32_rel": err32, "fp32_top1": agree, "eval_img_s": result, "eval_img_s_turns": runs}


def branch_train(card: str, cx, route, block) -> dict:
    """Phase 25(c), training on the branch route with phase 6's recipe at
    B=128: six steps with 18 launches each of kernels 10 and 11 (none of
    kernels 1 and 2), finite metrics, a moving EMA; one step of the same route
    with use_kernel=False (the plain composition under autograd, no launch)
    from a deep copy of the first state, held as phase 6 holds its plain step
    (loss, grad norm, the group gates against an fp32 model on the route);
    train img/s of the block and the branch route in turns, and each route's
    peak memory over one step. Returns the launch counts after the six steps
    (`branch_counts`) and the measurements."""
    import torch

    from imagenet_models_tpu_torch.train.state import make_train_step

    n_blocks = sum(STAGE_DEPTHS)
    state, opt, loss_fn = make_trainer()
    plain_state = copy.deepcopy(state)
    first = {k: p.detach().clone() for k, p in state.params().items()}
    kernel_opt, plain_opt = FirstGrads(opt), FirstGrads(opt)
    kw = dict(dec_lam=-0.8, ema_decay=0.9999)
    step = make_train_step(state.model, kernel_opt, loss_fn, **kw)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, use_kernel=False, **kw)
    images, targets = train_batch()
    gen = torch.Generator(device="cuda")
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        torch.manual_seed(SEED + 10 + i)  # the head's dropout masks
        before = branch_counts()
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10 + i))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append(tuple(a - b for a, b in zip(branch_counts(), before)))
    torch.cuda.synchronize()
    log(f"[branch-train] {TRAIN_STEPS} steps of B={TRAIN_BATCH} in "
        f"{time.perf_counter() - t0:.2f} s (first includes warm-up); (kernel 10, kernel 11, "
        f"kernel 1, kernel 2) launches per step: {per_step}")
    log("[branch-train] loss per step: " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
        + "; grad_norm per step: " + ", ".join(f"{m['grad_norm']:.6f}" for m in metrics))
    if per_step != [(n_blocks, n_blocks, 0, 0)] * TRAIN_STEPS:
        raise AssertionError(f"expected {n_blocks} launches each of kernels 10 and 11 per step "
                             f"and none of kernels 1 and 2, got {per_step}")
    for m in metrics:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite train metrics: {metrics}")
    ema_moved = max((state.ema_params[k] - first[k]).abs().max().item() for k in first)
    moved = max((p.detach() - first[k]).abs().max().item() for k, p in state.params().items())
    log(f"[branch-train] largest move from the initial weights: params {moved:.4g}, EMA shadow "
        f"{ema_moved:.4g}")
    if not 0.0 < ema_moved < moved:
        raise AssertionError("the EMA shadow did not move, or moved as far as the params")
    path_launches = branch_counts()

    torch.manual_seed(SEED + 10)
    plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
    if branch_counts() != path_launches:
        raise AssertionError("the branch route's plain composition launched a kernel")
    pm = {k: v.item() for k, v in pm.items()}
    loss_rel = abs(metrics[0]["loss"] - pm["loss"]) / abs(pm["loss"])
    gnorm_rel = abs(metrics[0]["grad_norm"] - pm["grad_norm"]) / abs(pm["grad_norm"])
    log(f"[branch-train] first step, kernels vs plain composition: loss {metrics[0]['loss']:.6f} "
        f"vs {pm['loss']:.6f} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}); grad_norm "
        f"{metrics[0]['grad_norm']:.6f} vs {pm['grad_norm']:.6f} (rel {gnorm_rel:.3g}, tol "
        f"{TRAIN_GNORM_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL):
        raise AssertionError("the branch route's train step disagrees with the plain composition")
    grads = compare_grads(kernel_opt.grads, plain_opt.grads, fp32_grads(loss_fn, images, targets),
                          "branch-")
    kernel_opt.grads = plain_opt.grads = {}
    del plain_state, plain_step
    torch.cuda.empty_cache()

    tgen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def arm(apply):
        def run():
            cx.convnext_block_apply = apply
            step(state, images, targets, tgen)
        return run

    fns = {"block": arm(block), "branch": arm(route)}
    peak = {}
    for name, fn in fns.items():
        for _ in range(TRAIN_WARMUP):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    t = in_turns(fns, TRAIN_ITERS, order=("block", "branch"))
    cx.convnext_block_apply = route
    runs = {k: [TRAIN_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[branch-train-throughput] map_convnext_tiny (LAMB, EMA) train B={TRAIN_BATCH} {IMG}px "
        f"bf16: branch route {result['branch']:.1f} img/s, block route {result['block']:.1f} img/s "
        f"(turns block,branch,branch,block: {runs['block'][0]:.1f},{runs['branch'][0]:.1f},"
        f"{runs['branch'][1]:.1f},{runs['block'][1]:.1f}); peak memory over one step: branch "
        f"{peak['branch']:.2f} GiB, block {peak['block']:.2f} GiB on {card}")
    del state, step, images, targets
    torch.cuda.empty_cache()
    return path_launches, {
        "per_step": per_step, "losses": [m["loss"] for m in metrics],
        "grad_norms": [m["grad_norm"] for m in metrics], "plain_loss": pm["loss"],
        "plain_grad_norm": pm["grad_norm"], "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
        "grads_rel": grads, "ema_moved": ema_moved, "params_moved": moved,
        "train_img_s": result, "train_img_s_turns": runs, "peak_memory_gib": peak}


def branch_path(card: str) -> dict:
    """Phase 25(c): map_convnext_tiny's blocks on the branch route
    (`branch_route`), serving then training; the counts of kernels 10 and
    11 are set to 0 just before the route is driven and read after the six
    train steps (serving, the eval timing turns and the train steps). The
    block route is restored at the end, whatever happens."""
    from imagenet_models_tpu_torch.models import convnext as cx
    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    block, route = cx.convnext_block_apply, branch_route()
    cbr.fused_convnext_branch.launches = cbr.fused_convnext_branch_bwd.launches = 0
    try:
        cx.convnext_block_apply = route
        serving = branch_serve(card, cx, route, block)
        launches, train = branch_train(card, cx, route, block)
    finally:
        cx.convnext_block_apply = block
    return {"serving": serving, "train": train,
            "launches": {"fwd": launches[0], "bwd": launches[1]}}


# ---------------------------------------------------------------- fp32 models

# phase 26: an fp32 model (dtype None, the factories' default, as JAX's CLI
# computes without --amp) of each family whose path holds kernels 1-6, at a
# small batch under the default dispatch, which sends its fp32 CUDA tensors to
# the kernels' fp32 instances: (model, the wrappers that must launch in its
# eval forward, and in its train step). MaxViT's eval forward takes the
# composition route, not kernel 3.
FP32_BATCH = 2
FP32_MODELS = (
    ("map_convnext_tiny", ("fused_ln_mlp",), ("fused_ln_mlp", "fused_ln_mlp_bwd")),
    (GA_CONVNEXT, ("fused_ln_mlp",), ("fused_ln_mlp", "fused_ln_mlp_bwd")),
    (GA_CSWIN, ("fused_stripe_attention",),
     ("fused_stripe_attention", "fused_stripe_attention_bwd")),
    (MAXVIT, (), ("fused_partition_attention", "fused_partition_attention_bwd")))
# an fp32 instance against its twin: exact fp32 products on both sides, fp32
# sums in other orders (the weight gradients over up to 6272 tokens here)
FP32_KERNEL_RTOL = 1e-4
# fp32 serving logits and train loss through the kernels' fp32 instances
# against the plain path's: the same fp32 function, its sums in other orders
# through the depth of the model
FP32_DISPATCH_RTOL = 1e-4


def fp32_kernel_counters():
    """Kernels 1-6's wrappers, by name."""
    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    return {f.__name__: f for f in (cb.fused_ln_mlp, cb.fused_ln_mlp_bwd,
                                    pa.fused_partition_attention,
                                    pa.fused_partition_attention_bwd,
                                    sa.fused_stripe_attention, sa.fused_stripe_attention_bwd)}


def check_fp32_kernels(card: str) -> list:
    """The fp32 instances of kernels 1-6 against their twins at the shapes of
    phase 26's models (B=2): kernel 1 with both GELUs and kernel 2 with the
    training one at map_convnext_tiny's four stage shapes and ga_convnext's
    gram layers, kernels 3 and 4 at MaxViT's three stage shapes (block and
    grid), kernels 5 and 6 at GA-CSWin's stripes that take them; every output
    within FP32_KERNEL_RTOL of the twin's largest |value|, kernel 2's outputs
    bit-equal between two runs; and each timed per launch in turns with its
    twin (twin, kernel, kernel, twin)."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    rows = []

    def hold(kernel, tag, kern, plain, rerun=False):
        got, ref = kern(), plain()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        same = not rerun or all(torch.equal(a, b) for a, b in zip(got, kern()))
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        ok = same and all(a.dtype == b.dtype == f32 and a.shape == b.shape and e <= FP32_KERNEL_RTOL
                          for a, b, e in zip(got, ref, errs))
        del got, ref
        t = in_turns({"kernel": kern, "plain": plain}, 10)
        ms = {k: sum(v) / 2 for k, v in t.items()}
        log(f"[fp32] {kernel} fp32 instance {tag}: max|kernel-twin|/max|twin| per output "
            + ", ".join(f"{e:.3g}" for e in errs) + f" (tol {FP32_KERNEL_RTOL})"
            + ("" if same else "; NOT bit-equal across two runs")
            + f"; kernel {ms['kernel']:.4f} ms, twin {ms['plain']:.4f} ms (twin,kernel,kernel,"
            f"twin: {t['plain'][0]:.4f},{t['kernel'][0]:.4f},{t['kernel'][1]:.4f},"
            f"{t['plain'][1]:.4f}) on {card}")
        if not ok:
            raise AssertionError(f"the fp32 instance of {kernel} disagrees with its twin at {tag}")
        rows.append({"kernel": kernel, "tag": tag, "err_over_max_twin": errs, "ms": ms["kernel"],
                     "plain_ms": ms["plain"], "turns": t})

    with torch.no_grad():
        for n, c in stage_shapes(FP32_BATCH) + [(FP32_BATCH * 14 * 14, 192)]:
            args = ln_mlp_args(n, c, gen, dtype=f32)
            g = torch.randn(n, c, generator=gen, device="cuda")
            for gi in ("exact", "fast"):
                hold("ln_mlp_fwd", f"N={n} C={c} [{gi}]",
                     lambda: cb.fused_ln_mlp(*args, gelu_impl=gi),
                     lambda: cb.plain_ln_mlp(*args, gelu_impl=gi))
            hold("ln_mlp_bwd", f"N={n} C={c} [fast]",
                 lambda: cb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast"),
                 lambda: cb.plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast"), True)
        for side, c, nh in MAXVIT_STAGES:
            qkv, bias, g = attn_args(FP32_BATCH, side, side, nh, PS, gen, dtype=f32)
            for part in ("block", "grid"):
                tag = f"B={FP32_BATCH} {side}x{side} C={c} [{part}]"
                hold("partition_attn_fwd", tag,
                     lambda: pa.fused_partition_attention(qkv, bias, part, PS, nh),
                     lambda: pa.plain_partition_attention(qkv, bias, part, PS, nh))
                hold("partition_attn_bwd", tag,
                     lambda: pa.fused_partition_attention_bwd(qkv, bias, g, part, PS, nh),
                     lambda: pa.plain_partition_attention_bwd(qkv, bias, g, part, PS, nh), True)
        for name, side, ws, c, nh, launches in CSWIN_STRIPES:
            if not launches:
                continue
            q, k, v, w9, wb, g = stripe_args(FP32_BATCH, side, side, c, gen, dtype=f32)
            scale = (c // nh) ** -0.5
            tag = f"{name} B={FP32_BATCH} {side}x{side} ws={ws} C={c}"
            hold("stripe_attn_fwd", tag,
                 lambda: sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale),
                 lambda: sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale))
            hold("stripe_attn_bwd", tag,
                 lambda: sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale),
                 lambda: sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=ws, nh=nh,
                                                       scale=scale), True)
    return rows


def fp32_dispatch(card: str) -> dict:
    """Phase 26: the fp32 instances against their twins (`check_fp32_kernels`),
    then per model of FP32_MODELS, one serving call (eval forward) and one
    train step (the GA recipe's LAMB and loss) under the default dispatch,
    each beside the same call on the plain path (use_kernel=False) from the
    same weights: logits and loss finite and within FP32_DISPATCH_RTOL of the
    plain path's, a finite grad norm, and each of the model's kernels
    launched (every counter set to 0 just before the call, read just
    after)."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.serving import make_serving_fn
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state, make_train_step

    checks = check_fp32_kernels(card)
    counters = fp32_kernel_counters()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    request = torch.randint(0, 256, (FP32_BATCH, IMG, IMG, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
    images = torch.randn(FP32_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    targets = torch.rand(FP32_BATCH, 1000, generator=gen, device="cuda")
    loss_fn = create_loss_fn(bce_loss=True, smoothing=0.1, mixup_active=True)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        return out, {k: c.launches for k, c in counters.items() if c.launches}

    result = {"kernel_checks": checks}
    for name, eval_kernels, train_kernels in FP32_MODELS:
        runs = {}
        for path, use_kernel in (("kernel", None), ("plain", False)):
            model = create_model(name, generator=torch.Generator().manual_seed(SEED))
            if next(model.parameters()).dtype != torch.float32:
                raise AssertionError(f"{name} was not built as an fp32 model by default")
            logits, eval_launches = counted(
                lambda: make_serving_fn(model, use_kernel=use_kernel)(request))
            opt = create_optimizer("lamb", **GA_RECIPE)
            state = create_train_state(model, opt)
            step = make_train_step(model, opt, loss_fn, dec_lam=-0.8, use_kernel=use_kernel)
            torch.cuda.manual_seed(SEED)  # the heads' dropouts draw from the default generator
            (state, m), train_launches = counted(
                lambda: step(state, images, targets,
                             torch.Generator(device="cuda").manual_seed(SEED)))
            runs[path] = {"logits": logits, "eval_launches": eval_launches,
                          "train_launches": train_launches,
                          **{k: v.item() for k, v in m.items()}}
            del model, state, step, opt
            torch.cuda.empty_cache()
        k, p = runs["kernel"], runs["plain"]
        err = rel_err(k["logits"], p["logits"])
        loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        log(f"[fp32] {name}, fp32 compute, default dispatch, B={FP32_BATCH}: serving logits "
            f"{tuple(k['logits'].shape)} {k['logits'].dtype}, vs the plain path "
            f"max|diff|/max|plain| {err:.3g}; train step loss {k['loss']:.6f} (plain "
            f"{p['loss']:.6f}, rel diff {loss_err:.3g}; tol {FP32_DISPATCH_RTOL}), grad_norm "
            f"{k['grad_norm']:.6f} (plain {p['grad_norm']:.6f}); launches at eval "
            f"{k['eval_launches']}, in the train step {k['train_launches']}; plain path "
            f"{p['eval_launches']}, {p['train_launches']} on {card}")
        finite = all(v == v and abs(v) != float("inf") for r in runs.values()
                     for key, v in r.items() if key in ("loss", "grad_norm"))
        ok = (k["logits"].shape == (FP32_BATCH, 1000) and torch.isfinite(k["logits"]).all().item()
              and finite and err <= FP32_DISPATCH_RTOL and loss_err <= FP32_DISPATCH_RTOL
              and all(k["eval_launches"].get(w) for w in eval_kernels)
              and all(k["train_launches"].get(w) for w in train_kernels)
              and not p["eval_launches"] and not p["train_launches"])
        if not ok:
            raise AssertionError(f"the fp32 {name} failed under the default dispatch, or did not "
                                 f"launch its kernels: {err}, {loss_err}, {k['eval_launches']}, "
                                 f"{k['train_launches']}, plain {p['eval_launches']}, "
                                 f"{p['train_launches']}")
        result[name] = {"logits_vs_plain": err, "loss_vs_plain": loss_err,
                        **{f"{path}_{key}": v for path, r in runs.items()
                           for key, v in r.items() if key != "logits"}}
    return result


# ---------------------------------------------------------------- the train and validate entries

# phase 27: map_convnext_tiny through the port's CLI entries. synthetic:384 is
# three batches of 128 in each split, so no epoch is cut short
ENTRY_IMAGES = 384
ENTRY_STEPS = ENTRY_IMAGES // TRAIN_BATCH
ENTRY_RECIPE = ["--model", "map_convnext_tiny", "--input-size", "3", "224", "224",
                "-b", str(TRAIN_BATCH), "--opt", "lamb", "--lr", "5e-3", "--weight-decay", "0.05",
                "--smoothing", "0.1", "--bce-loss", "--dec-lam", "-0.8", "--model-ema",
                "--model-ema-decay", "0.9999", "--drop-path", "0.1", "--cooldown-epochs", "0",
                "--max-steps-per-epoch", str(ENTRY_STEPS)]
ENTRY_DIR = Path("output") / "chip_smoke_entry"  # checkpoints: ~0.8 GB each, deleted after


def host_cpu() -> str:
    """The host's CPU model from /proc/cpuinfo; where a virtual machine hides
    the name ("unknown"), its vendor, family and model numbers."""
    try:
        info = {}
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    except OSError:
        return "unknown"
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"unknown model name ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')})")


class ResidentLoader:
    """Random NHWC float32 batches made once in memory, the host loader's
    geometry (len, batch_size, set_epoch, mixup_enabled; a process's shard
    of each batch): the stand-in phases 27 and 28 bind where Pillow is
    absent."""
    decoder = "in-memory (no Pillow)"

    def __init__(self, dataset, input_size, batch_size, is_training, num_shards=1, **kw):
        import numpy as np

        self.n = len(dataset) // batch_size if is_training else -(-len(dataset) // batch_size)
        batch_size //= num_shards
        self.batch_size, self.is_training = batch_size, is_training
        self.mixup_enabled = False
        rng = np.random.default_rng(SEED + 27)
        self.images = rng.standard_normal((batch_size, input_size, input_size, 3), np.float32)
        self.targets = (np.arange(batch_size) % dataset.num_classes).astype(np.int64)

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            yield self.images, self.targets


def bind_resident_loader(mods, tag: str, images: int = ENTRY_IMAGES) -> dict:
    """Bind `create_dataset`/`create_loader` of the entry modules `mods` to
    ResidentLoader (where Pillow is absent), `images` in each split; returns
    what to put back."""
    from imagenet_models_tpu_torch.data.dataset import SyntheticDataset

    bound = {}
    for mod in mods:
        bound[mod] = (mod.create_dataset, mod.create_loader)
        mod.create_dataset = lambda name, split="train", num_classes=1000, image_size=224, \
            class_map=None: SyntheticDataset(images, num_classes, image_size)
        mod.create_loader = ResidentLoader
    log(f"[{tag}] Pillow is absent: create_dataset/create_loader of the entries bound to "
        "ResidentLoader (random batches made once, the same geometry) for this phase")
    return bound


def entry_counts(reset: bool = False) -> dict:
    from imagenet_models_tpu_torch.ops import convnext_block as cb

    if reset:
        cb.fused_ln_mlp.launches = cb.fused_ln_mlp_bwd.launches = 0
    return {"fwd": cb.fused_ln_mlp.launches, "bwd": cb.fused_ln_mlp_bwd.launches}


def train_entry(card: str, resident_train_img_s: float) -> dict:
    """Phase 27 (module docstring): the train entry, its resume, the validate
    entry and an fp32 epoch, with the kernels' launch counts of each run
    (set to 0 just before it, read just after)."""
    import gc
    import importlib.util
    import os
    import shutil

    import torch

    from imagenet_models_tpu_torch.cli import train as cli_train
    from imagenet_models_tpu_torch.cli import validate as cli_validate

    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "yaml")}
    cpu = host_cpu()
    workers = min(8, os.cpu_count() or 1)
    log(f"[entry] host: {cpu}, {os.cpu_count()} cores; Pillow "
        f"{'present' if have['PIL'] else 'ABSENT'}, PyYAML "
        f"{'present' if have['yaml'] else 'absent (needed only for -c)'}")
    bound = bind_resident_loader((cli_train, cli_validate), "entry") if not have["PIL"] else {}
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    base = [f"synthetic:{ENTRY_IMAGES}", *ENTRY_RECIPE, "-j", str(workers),
            "--output", str(ENTRY_DIR)]
    checks = {"host_cpu": cpu, "cores": os.cpu_count(), "pillow": have["PIL"],
              "pyyaml": have["yaml"]}

    def counted(fn):
        entry_counts(reset=True)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        return out, entry_counts()

    def loops(result, tag):
        rows = []
        for e in result["epochs"]:
            tr, ev = e["train_stats"], e.get("eval_stats")
            # the loop's time not spent waiting for the loader, a step: the
            # step's own time, the device's included (the epoch's last step
            # waits for the device when it fetches the loss)
            step_s = (tr.seconds - tr.data_seconds) / tr.steps
            rows.append({"epoch": e["epoch"], "train_img_s": tr.img_s,
                         "train_data_s_per_step": tr.data_per_step,
                         "train_other_s_per_step": step_s, "train_steps": tr.steps,
                         "train_seconds": tr.seconds, "loss": e["train"]["loss"],
                         "eval_img_s": ev.img_s if ev else None,
                         "eval_ema_img_s": e["eval_ema_stats"].img_s if "eval_ema_stats" in e
                         else None, "eval": e["eval"]})
            log(f"[entry] {tag} epoch {e['epoch']}: loss {e['train']['loss']:.6f}; train loop "
                f"{tr.img_s:.1f} img/s over {tr.steps} steps ({tr.seconds:.3f} s), data "
                f"{tr.data_per_step * 1e3:.1f} ms a step, the rest {step_s * 1e3:.1f} ms a "
                f"step ({e['train_stats'].images / tr.steps / step_s:.1f} img/s); eval loop "
                + (f"{ev.img_s:.1f} img/s (EMA {e['eval_ema_stats'].img_s:.1f}), data "
                   f"{ev.data_per_step * 1e3:.1f} ms a batch" if ev else "not run")
                + f"; eval {e['eval']}; decoder {result['decoder']}; {card}")
        return rows

    def eval_batches(result):
        return sum(e[k].steps for e in result["epochs"] for k in ("eval_stats", "eval_ema_stats")
                   if k in e)

    try:
        # (a) train: two epochs of three steps, bf16
        first, n = counted(lambda: cli_train.main([*base, "--amp", "--epochs", "2",
                                                   "--experiment", "bf16"]))
        run = Path(first["output_dir"])
        steps = sum(e["train_stats"].steps for e in first["epochs"])
        forwards = steps + eval_batches(first)
        with open(run / "summary.csv") as f:
            summary = f.read().splitlines()
        files = sorted(os.listdir(run))
        losses = [e["train"]["loss"] for e in first["epochs"]]
        ok = (first["exit"] == "done" and steps == 2 * ENTRY_STEPS
              and n == {"fwd": 18 * forwards, "bwd": 18 * steps}
              and all(v == v and abs(v) != float("inf") for v in losses)
              and len(summary) == 3
              and {"checkpoint-0", "checkpoint-1", "last", "model_best"} <= set(files))
        checks["train"] = {"launches": n, "steps": steps, "forwards": forwards,
                           "summary": summary, "files": files, "loops": loops(first, "bf16")}
        log(f"[entry] train entry, map_convnext_tiny B={TRAIN_BATCH} 224px bf16, 2 epochs: "
            f"{steps} steps, {forwards} forwards (eval included); launches {n} (want "
            f"{18 * forwards} and {18 * steps}: 18 + 18 a step, 18 an eval forward); losses "
            f"{losses}; summary.csv {len(summary) - 1} rows; {files}")
        if not ok:
            raise AssertionError(f"phase 27: the train entry failed its checks: {checks['train']}")

        # (b) resume from last for a third epoch
        resumed, n = counted(lambda: cli_train.main([*base, "--amp", "--epochs", "3",
                                                     "--experiment", "resumed",
                                                     "--resume", str(run / "last")]))
        rsteps = sum(e["train_stats"].steps for e in resumed["epochs"])
        ok = (resumed["start_epoch"] == 2 and [e["epoch"] for e in resumed["epochs"]] == [2]
              and n["bwd"] == 18 * rsteps and resumed["exit"] == "done")
        checks["resume"] = {"start_epoch": resumed["start_epoch"], "launches": n,
                            "loops": loops(resumed, "resumed")}
        log(f"[entry] resumed from {run / 'last'}: starts at epoch {resumed['start_epoch']}, "
            f"launches {n}")
        if not ok:
            raise AssertionError(f"phase 27: the resume failed its checks: {checks['resume']}")

        # (c) the validate entry on model_best, against the engine's eval of it
        best = first["epochs"][first["best_epoch"]]["eval"]
        val = [f"synthetic:{ENTRY_IMAGES}", "--model", "map_convnext_tiny", "--amp",
               "-b", str(TRAIN_BATCH), "-j", str(workers), "--checkpoint", str(run / "model_best")]
        checks["validate"] = {}
        for use_ema, want in ((True, (best["top1"], best["top5"])),
                              (False, (best["raw_top1"], best["raw_top5"]))):
            [res], n = counted(lambda: cli_validate.main(val + (["--use-ema"] if use_ema else [])))
            batches = -(-ENTRY_IMAGES // TRAIN_BATCH)
            got = (res["top1"], res["top5"])
            ok = got == (round(want[0], 4), round(want[1], 4)) and n == {"fwd": 18 * batches,
                                                                          "bwd": 0}
            checks["validate"]["ema" if use_ema else "raw"] = {"result": res, "engine": want,
                                                                "launches": n}
            log(f"[entry] validate entry on model_best (epoch {first['best_epoch']})"
                f"{' --use-ema' if use_ema else ''}: top-1 {res['top1']} top-5 {res['top5']}, "
                f"the engine's {want}; {res['images_per_sec']} img/s; launches {n} over "
                f"{batches} forwards")
            if not ok:
                raise AssertionError(f"phase 27: the validate entry disagrees with the engine or "
                                     f"missed kernel 1: {checks['validate']}")

        # (d) one fp32 epoch of two steps: kernels 1 and 2's fp32 instances
        fp32, n = counted(lambda: cli_train.main([*base, "--epochs", "1", "--max-steps-per-epoch",
                                                  "2", "--experiment", "fp32"]))
        fsteps = sum(e["train_stats"].steps for e in fp32["epochs"])
        ok = (fp32["exit"] == "done" and fsteps == 2 and n["bwd"] == 18 * fsteps
              and n["fwd"] == 18 * (fsteps + eval_batches(fp32)))
        checks["fp32"] = {"launches": n, "loops": loops(fp32, "fp32")}
        if not ok:
            raise AssertionError(f"phase 27: the fp32 epoch failed its checks: {checks['fp32']}")
    finally:
        for mod, (ds, ld) in bound.items():
            mod.create_dataset, mod.create_loader = ds, ld
        shutil.rmtree(ENTRY_DIR, ignore_errors=True)
        gc.collect()
    last = checks["train"]["loops"][-1]
    log(f"[entry] map_convnext_tiny B={TRAIN_BATCH} bf16 train entry {last['train_img_s']:.1f} "
        f"img/s (epoch 1, {last['train_steps']} steps, data {last['train_data_s_per_step'] * 1e3:.1f}"
        f" ms a step, decoder {first['decoder']}) beside the resident-batch step of phase 7 "
        f"{resident_train_img_s:.1f} img/s; host {cpu}; {card}")
    torch.cuda.empty_cache()
    return checks


# ---------------------------------------------------------------- data parallelism

# phase 28: the multi-process paths, in child processes of this script
# (`--phase28 ...`), so that no process group outlives the phase here
DP_DIR = Path("output") / "chip_smoke_dp"  # 28a's run directory, deleted after
DP_OUT = OUT_DIR / "phase28"
DP_CONVNEXT_BATCH, DP_RESNET_BATCH = 64, 32  # 28b's rows per rank at 224 px
DP_TIMED_STEPS = 8
# 28b's running statistics against the one-process step: means in units of
# the running standard deviation, variances relative
DP_STAT_RTOL = 1e-3
DP_TIMEOUT = 300


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_children(*argvs) -> list:
    """Run `chip_smoke.py --phase28 <argv>` once per argv, all at once; log
    each one's output, raise if any fails, return what each wrote."""
    import os

    DP_OUT.mkdir(parents=True, exist_ok=True)
    outs = [DP_OUT / f"{'-'.join(a)}.json" for a in argvs]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--phase28", *a,
                               str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for a, out in zip(argvs, outs)]
    failed = []
    try:
        for a, proc in zip(argvs, procs):
            text, _ = proc.communicate(timeout=DP_TIMEOUT)
            for line in text.splitlines():
                log(f"  [{' '.join(a)}] {line}")
            if proc.returncode:
                failed.append((a, proc.returncode))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError(f"phase 28: child processes failed: {failed}")
    return [json.loads(out.read_text()) for out in outs]


def finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def snapshot_state(state):
    """A one-process copy of a train state (its model deep-copied, its
    BatchNorms not synchronised), for the reference step."""
    from imagenet_models_tpu_torch.nn.layers import set_bn_sync
    from imagenet_models_tpu_torch.train.state import TrainState

    ref = TrainState(step=state.step, model=copy.deepcopy(state.model),
                     opt_state=copy.deepcopy(state.opt_state),
                     ema_params=copy.deepcopy(state.ema_params),
                     ema_batch_stats=copy.deepcopy(state.ema_batch_stats))
    set_bn_sync(ref.model, None)
    return ref


def bits_equal(a: dict, b: dict) -> list:
    """The keys whose tensors differ in any bit."""
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def dp_entry_child(port: str, timing_port: str, out: str) -> None:
    """28a (child): the train entry over NCCL at world 1 with --zero1, its
    first step held to a one-process step from a copy of the same state on
    the same batch and generators, bit for bit; then the step time under
    NCCL beside the non-distributed step, and the reduction's share."""
    import importlib.util
    import shutil

    import torch

    from imagenet_models_tpu_torch.cli import train as cli_train
    from imagenet_models_tpu_torch.parallel import mesh
    from imagenet_models_tpu_torch.train import state as state_mod

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # the bit-equality gate needs each step deterministic: cuDNN's
    # deterministic algorithms (the depthwise convolutions' gradients)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    bound = {} if importlib.util.find_spec("PIL") else bind_resident_loader((cli_train,), "dp")
    make_step = state_mod.make_train_step
    rec = {"per_step": [], "first": None, "ref_launches": {"fwd": 0, "bwd": 0}}

    def recording(*args, **kw):
        step = make_step(*args, **kw)
        if kw.get("group") is None:
            return step

        def wrapped(state, images, targets, generator=None):
            first = rec["first"] is None
            if first:
                ref, plain = snapshot_state(state), snapshot_state(state)
                rngs = (generator.get_state(), torch.cuda.get_rng_state())
            before = entry_counts()
            state, m = step(state, images, targets, generator)
            torch.cuda.synchronize()
            after = entry_counts()
            rec["per_step"].append([after["fwd"] - before["fwd"], after["bwd"] - before["bwd"]])
            if first:
                got = {"loss": m["loss"].clone(), "grad_norm": m["grad_norm"].clone(),
                       "params": {k: p.detach().clone() for k, p in state.params().items()},
                       "ema": {k: v.clone() for k, v in state.ema_params.items()},
                       "mu": {k: v.clone() for k, v in state.opt_state["mu"].items()},
                       "nu": {k: v.clone() for k, v in state.opt_state["nu"].items()}}
                resume = (generator.get_state(), torch.cuda.get_rng_state())
                res = []
                for st in (ref, plain):  # twice: the one-process step's own determinism
                    gen = torch.Generator(device=images.device)
                    gen.set_state(rngs[0])
                    torch.cuda.set_rng_state(rngs[1])
                    one = make_step(st.model, *args[1:], **{**kw, "group": None, "zero1": False})
                    c0 = entry_counts()
                    st, rm = one(st, images, targets, gen)
                    c1 = entry_counts()
                    for k in ("fwd", "bwd"):
                        rec["ref_launches"][k] += c1[k] - c0[k]
                    res.append({"loss": rm["loss"], "grad_norm": rm["grad_norm"],
                                "params": st.params(), "ema": st.ema_params,
                                "mu": st.opt_state["mu"], "nu": st.opt_state["nu"]})
                generator.set_state(resume[0])
                torch.cuda.set_rng_state(resume[1])
                diff = lambda a, b: {
                    "loss": torch.equal(a["loss"], b["loss"]),
                    "grad_norm": torch.equal(a["grad_norm"], b["grad_norm"]),
                    **{part: bits_equal(a[part], b[part]) for part in ("params", "ema", "mu", "nu")}}
                rec["first"] = {"loss": got["loss"].item(), "one_process_loss": res[0]["loss"].item(),
                                "grad_norm": got["grad_norm"].item(),
                                "vs_one_process": diff(got, res[0]),
                                "one_process_vs_itself": diff(res[0], res[1]),
                                "max_param_diff": max((got["params"][k].float()
                                                       - res[0]["params"][k].float()).abs().max().item()
                                                      for k in got["params"])}
                del ref, plain, res, got
                torch.cuda.empty_cache()
            return state, m

        return wrapped

    state_mod.make_train_step = recording
    shutil.rmtree(DP_DIR, ignore_errors=True)
    argv = [f"synthetic:{ENTRY_IMAGES}", *ENTRY_RECIPE, "--amp", "--epochs", "1", "-j", "8",
            "--zero1", "--dist-coordinator", f"127.0.0.1:{port}", "--dist-num-processes", "1",
            "--dist-process-id", "0", "--experiment", "zero1", "--output", str(DP_DIR)]
    try:
        entry_counts(reset=True)
        t0 = time.perf_counter()
        result = cli_train.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        total = entry_counts()
        run = Path(result["output_dir"])
        files = sorted(p.name for p in run.iterdir())
        summary = (run / "summary.csv").read_text().splitlines()
    finally:
        state_mod.make_train_step = make_step
        for mod, (ds, ld) in bound.items():
            mod.create_dataset, mod.create_loader = ds, ld
        shutil.rmtree(DP_DIR, ignore_errors=True)
    e = result["epochs"][0]
    evals = sum(e[k].steps for k in ("eval_stats", "eval_ema_stats") if k in e)
    launches = {k: total[k] - rec["ref_launches"][k] for k in total}
    check = {"exit": result["exit"], "world": result["world"], "device": result["device"],
             "loss": e["train"]["loss"], "steps": e["train_stats"].steps, "eval_forwards": evals,
             "launches": launches, "per_step": rec["per_step"], "first": rec["first"],
             "files": files, "summary_rows": len(summary) - 1, "seconds": seconds,
             "train_img_s": e["train_stats"].img_s}
    log(f"train entry over NCCL at world 1, --zero1: {check}")

    # the step under NCCL at world 1 (replicated, and ZeRO-1 with its
    # synchronised statistics and broadcast) against the one-process step,
    # and the reduction's share of it
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    mesh.init_distributed(f"127.0.0.1:{timing_port}", 1, 0, device=torch.device("cuda"))
    try:
        group = mesh.data_group()
        images, targets = train_batch()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        states, fns = {}, {}
        arms = (("one_process", None, None), ("nccl_replicated", group, False),
                ("nccl_zero1", group, None))
        for arm, g, zero1 in arms:
            recipe = None if zero1 is None else {
                "opt": dict(learning_rate=5e-3, weight_decay=0.05),
                "loss": dict(bce_loss=True, smoothing=0.1, mixup_active=True), "zero1": zero1}
            states[arm], step = dp_trainer(g, recipe=recipe)
            fns[arm] = lambda step=step, arm=arm: states.__setitem__(
                arm, step(states[arm], images, targets, gen)[0])
            for _ in range(2):  # warm-up: cuDNN's autotuning, the allocator
                fns[arm]()
        times = in_turns(fns, DP_TIMED_STEPS, order=[a for a, _, _ in arms])
        st = states["nccl_zero1"]
        params = st.params()
        grads = [torch.randn_like(p) for p in params.values()] + [torch.zeros((), device="cuda")]
        reduce = lambda: mesh.all_reduce_mean(grads, group)
        bcast = lambda: mesh.broadcast_from_owners(params, st.owners, group)
        reduce_ms, bcast_ms = cuda_ms(reduce, 10), cuda_ms(bcast, 10)
        host_ms = {}  # the host's wall time a call: where it is near the events', the host holds it
        for what, fn in (("all_reduce", reduce), ("broadcast", bcast)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            host_ms[what] = (time.perf_counter() - t0) * 100
            torch.cuda.synchronize()
            host_ms[what + "_synchronized"] = (time.perf_counter() - t0) * 100
    finally:
        mesh.destroy()
    step_ms = sum(times["nccl_zero1"]) / 2
    check["timing"] = {"step_ms": times, "all_reduce_ms": reduce_ms, "broadcast_ms": bcast_ms,
                       "host_ms": host_ms,
                       "reduction_share": (reduce_ms + bcast_ms) / step_ms,
                       "grad_elements": sum(p.numel() for p in params.values())}
    Path(out).write_text(json.dumps(check))


def dp_trainer(group, name: str = "map_convnext_tiny", recipe=None, ema: float = 0.9999,
               grad_accum: int = 1, model=None, dtype="bf16"):
    """(state, step) of bench.py's recipe (or `recipe`) on a fresh `name` in
    bf16 (or fp32: dtype None), or on `model`, over `group` (None: one
    process), ZeRO-1 when grouped unless the recipe says otherwise; the
    optimizer keeps its first update's gradients (`.grads`)."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state, make_train_step

    recipe = recipe or {"opt": dict(learning_rate=5e-3, weight_decay=0.05),
                        "loss": dict(bce_loss=True, smoothing=0.1, mixup_active=True)}
    if model is None:
        kw = {"ls_init_value": 1.0} if "convnext" in name else {}
        model = create_model(name, dtype=torch.bfloat16 if dtype == "bf16" else dtype,
                             generator=torch.Generator().manual_seed(SEED), **kw)
    opt = FirstGrads(create_optimizer("lamb", **recipe["opt"]))
    zero1 = group is not None and recipe.get("zero1", True)
    state = create_train_state(model, opt, ema_decay=ema, group=group, zero1=zero1)
    step = make_train_step(model, opt, create_loss_fn(**recipe["loss"]), dec_lam=-0.8,
                           ema_decay=ema, grad_accum=grad_accum, group=group, zero1=zero1)
    step.opt = opt
    return state, step


def group_distances(got: dict, ref: dict) -> dict:
    """L2 distance relative to `ref` of every (stage, block parameter) group
    of gradients (`grad_groups`), the worst group's, and all leaves'."""
    import torch

    groups = {}
    for key, names in grad_groups(ref).items():
        cat = lambda g: torch.cat([g[k].float().flatten() for k in names])
        groups[f"{key[0]} {key[1]}"] = rel_l2(cat(got), cat(ref))
    cat = lambda g: torch.cat([g[k].float().flatten() for k in ref])
    worst = max(groups, key=groups.get)
    return {"worst_group": worst, "worst": groups[worst], "all": rel_l2(cat(got), cat(ref)),
            "groups": len(groups)}


def dp_gloo_child(rank: str, port: str, out: str) -> None:
    """28b (child): rank `rank` of two processes on the one card over gloo,
    drop-path 0 and no dropout. (1) map_convnext_tiny's replicated step at
    B=64 a rank, bf16; (2) map_resnet50's ZeRO-1 step with synchronised
    BatchNorm statistics at B=32 a rank, in fp32 as phase 16 holds its
    plain path: two bf16 runs of the BatchNorm family that differ only in
    rounding (here cuDNN's algorithms at 32 and 64 rows) give gradients
    about 0.4 apart, as far as bf16 lies from fp32 (§6 of PERF.md). Rank 0
    then runs the one-process steps on the global batch and holds the
    ranks' step to them."""
    import torch
    import torch.distributed as dist

    from imagenet_models_tpu_torch.nn.layers import set_bn_sync
    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    r = int(rank)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=r)
    counts = lambda: {**entry_counts(), "bn_fwd": bn_ops.fused_channel_moments.launches,
                      "bn_bwd": bn_ops.fused_channel_dot_sums.launches}
    report = {"rank": r}
    cases = (("map_convnext_tiny", DP_CONVNEXT_BATCH, None, 0.9999, "bf16"),
             ("map_resnet50", DP_RESNET_BATCH, {**RESNET_RECIPE, "zero1": True}, 0.0, None))
    try:
        for name, rows, recipe, ema, dtype in cases:
            replicated = recipe is None
            recipe = recipe or {"opt": dict(learning_rate=5e-3, weight_decay=0.05),
                                "loss": dict(bce_loss=True, smoothing=0.1, mixup_active=True),
                                "zero1": False}
            state, step = dp_trainer(dist.group.WORLD, name, recipe, ema, dtype=dtype)
            for m in state.model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
            # rank 0's one-process copies of the initial model, their BatchNorms
            # not synchronised
            refs = [copy.deepcopy(state.model) for _ in range(2 if replicated else 1)] if r == 0 \
                else []
            for ref in refs:
                set_bn_sync(ref, None)
            g = torch.Generator(device="cuda").manual_seed(SEED + 28)
            images = torch.randn(2 * rows, IMG, IMG, 3, generator=g, device="cuda")
            targets = torch.rand(2 * rows, 1000, generator=g, device="cuda")
            mine = slice(r * rows, (r + 1) * rows)
            c0 = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, images[mine], targets[mine],
                            torch.Generator(device="cuda").manual_seed(SEED + r))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            c1 = counts()
            rec = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                   "launches": {k: c1[k] - c0[k] for k in c0}, "seconds": seconds,
                   "formulation": "replicated" if replicated else "zero1",
                   "dtype": "bf16" if dtype else "fp32"}
            if r == 0:
                # replicated: the one-process step with two microbatches of 64
                # (each normalised by its own statistics, as each rank is) is
                # the same function, and is gated; the one over all 128 rows
                # (whole-batch statistics) is reported. ZeRO-1: whole-batch
                # statistics, gated.
                arms = [("microbatches", 2), ("whole", 1)] if replicated else [("whole", 1)]
                for (arm, accum), model in zip(arms, refs):
                    rst, rstep = dp_trainer(None, name, recipe, ema, grad_accum=accum, model=model)
                    rst, rm = rstep(rst, images, targets,
                                    torch.Generator(device="cuda").manual_seed(SEED))
                    loss_rel = abs(rec["loss"] - rm["loss"].item()) / abs(rm["loss"].item())
                    gnorm_rel = abs(rec["grad_norm"] - rm["grad_norm"].item()) / rm["grad_norm"].item()
                    row = {"loss": rm["loss"].item(), "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
                           "grads": group_distances(step.opt.grads, rstep.opt.grads),
                           "gated": arm == arms[0][0]}
                    if not replicated:
                        # a mean's difference in units of its feature's
                        # (running) standard deviation, a variance's relative:
                        # the means of a BatchNorm's centred input are ~0
                        live, one = state.batch_stats(), rst.batch_stats()
                        scale = lambda k: (one[k[:-4] + "var"].sqrt() if k.endswith("mean")
                                           else one[k])
                        rel = {k: ((live[k] - one[k]).abs() / scale(k)).max().item() for k in one}
                        row["running_stats_worst"] = max(rel, key=rel.get)
                        row["running_stats_rel"] = rel[row["running_stats_worst"]]
                    rec[arm] = row
                    log(f"[dp] {name} {rec['dtype']} {rec['formulation']} step, 2 ranks of {rows} over "
                        f"gloo, vs one process on {2 * rows} rows ({arm}{', gated' if row['gated'] else ', reported'}):"
                        f" loss rel {loss_rel:.3g} (tol {TRAIN_LOSS_RTOL}), grad norm rel "
                        f"{gnorm_rel:.3g} (tol {TRAIN_GNORM_RTOL}), worst of {row['grads']['groups']} "
                        f"gradient groups {row['grads']['worst']:.3g} ({row['grads']['worst_group']}; "
                        f"tol {TRAIN_GRAD_RTOL}), all leaves {row['grads']['all']:.3g}"
                        + (f", running statistics {row['running_stats_rel']:.3g} "
                           f"({row['running_stats_worst']}; tol {DP_STAT_RTOL})"
                           if "running_stats_rel" in row else ""))
                    if row["gated"] and not (
                            loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL
                            and row["grads"]["worst"] <= TRAIN_GRAD_RTOL
                            and row.get("running_stats_rel", 0.0) <= DP_STAT_RTOL):
                        raise AssertionError(f"phase 28b: {name}'s two-rank step disagrees with "
                                             f"one process: {row}")
                    del rst, rstep
            report[name] = rec
            del state, step, refs
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(report))


def phase28_child(argv) -> int:
    """`chip_smoke.py --phase28 a <port> <port> <out>` or `... b <rank>
    <port> <out>`: one child process of phase 28."""
    kind, *rest = argv
    {"a": dp_entry_child, "b": dp_gloo_child}[kind](*rest)
    return 0


def data_parallel(card: str) -> dict:
    """Phase 28 (module docstring): 28a in one child process, then 28b in
    two; the gates on what they report, and their timings beside the card."""
    t0 = time.perf_counter()
    [a] = dp_children(("a", str(free_port()), str(free_port())))
    port = str(free_port())
    b = dp_children(("b", "0", port), ("b", "1", port))
    seconds = time.perf_counter() - t0
    first = a["first"]
    steps, blocks = a["steps"], sum(STAGE_DEPTHS)
    equal = lambda d: d["loss"] and d["grad_norm"] and not any(d[p] for p in ("params", "ema", "mu",
                                                                                "nu"))
    ok = (a["exit"] == "done" and a["world"] == 1 and steps == ENTRY_STEPS
          and a["per_step"] == [[blocks, blocks]] * steps
          and a["launches"] == {"fwd": blocks * (steps + a["eval_forwards"]), "bwd": blocks * steps}
          and finite([a["loss"], first["loss"]]) and a["summary_rows"] == 1
          and {"last", "checkpoint-0", "model_best"} <= set(a["files"]))
    log(f"[dp] 28a: train entry over NCCL at world 1, --zero1, map_convnext_tiny B={TRAIN_BATCH} "
        f"bf16: {steps} steps, launches a step {a['per_step']}, {a['launches']} in the run "
        f"(eval forwards {a['eval_forwards']}); loss {a['loss']:.6f}; files {a['files']}; first "
        f"step against one process: {first['vs_one_process']} (max |param diff| "
        f"{first['max_param_diff']:.3g}); the one-process step against itself: "
        f"{first['one_process_vs_itself']}")
    if not ok:
        raise AssertionError(f"phase 28a: the entry's run failed its checks: {a}")
    if not equal(first["vs_one_process"]):
        raise AssertionError(f"phase 28a: the world-1 ZeRO-1 step is not the one-process step's "
                             f"bits: {first}")
    for rank in b:
        for name, want in (("map_convnext_tiny", {"fwd": blocks, "bwd": blocks}),
                           ("map_resnet50", {"fwd": 0, "bwd": 0})):
            got = rank[name]["launches"]
            if {k: got[k] for k in ("fwd", "bwd")} != want or got["bn_fwd"] or got["bn_bwd"]:
                raise AssertionError(f"phase 28b: rank {rank['rank']} {name} launches {got}, want "
                                     f"{want} of kernels 1 and 2 and none of kernels 7 and 8")
    t = a["timing"]
    one, repl, nccl = (sum(t["step_ms"][k]) / 2
                       for k in ("one_process", "nccl_replicated", "nccl_zero1"))
    log(f"[dp] map_convnext_tiny B={TRAIN_BATCH} bf16 train step, in turns: one process "
        f"{one:.2f} ms ({t['step_ms']['one_process']}), under NCCL at world 1 replicated "
        f"{repl:.2f} ms ({t['step_ms']['nccl_replicated']}) and with ZeRO-1 {nccl:.2f} ms "
        f"({t['step_ms']['nccl_zero1']}); the gradient all-reduce of {t['grad_elements']} fp32 "
        f"elements {t['all_reduce_ms']:.3f} ms and the owners' broadcast {t['broadcast_ms']:.3f} "
        f"ms (host wall time a call {t['host_ms']}), {100 * t['reduction_share']:.2f}% of the "
        f"step; 28b launches per rank "
        f"{[{n: r[n]['launches'] for n in ('map_convnext_tiny', 'map_resnet50')} for r in b]}; "
        f"phase {seconds:.1f} s; {card}")
    return {"entry_world1": a, "gloo_ranks": b, "seconds": seconds}


# ---------------------------------------------------------------- PiT and FasterViT

def pit_shapes(batch: int):
    """(tokens, C) of map_pit_s's three stages at `batch`."""
    return [(batch * s * s, c) for s, c, _ in PIT_STAGES]


def time_ln_mlp(args, g, gelu_impl: str, card: str, tag: str) -> dict:
    """Kernel 1 (`g` None) or kernel 2 per launch in turns with its twin
    (twin, kernel, kernel, twin), beside the bound and, as a yardstick of the
    tensor cores and not the same function, its products as torch.matmul
    calls at the same shapes (which the port never calls)."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import (
        fused_ln_mlp, fused_ln_mlp_bwd, plain_ln_mlp, plain_ln_mlp_bwd)

    n, c = args[0].shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    h, w1, w2 = args[0], args[3], args[5]
    mid = torch.randn(n, 4 * c, generator=gen, device="cuda").to(torch.bfloat16)
    if g is None:
        fns = {"kernel": lambda: fused_ln_mlp(*args, gelu_impl=gelu_impl),
               "plain": lambda: plain_ln_mlp(*args, gelu_impl=gelu_impl)}
        products = (lambda: h @ w1.t(), lambda: mid @ w2.t())
        iters = max(3, min(50, 2_000_000 // n))
    else:
        fns = {"kernel": lambda: fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl),
               "plain": lambda: plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)}
        products = (lambda: h @ w1.t(), lambda: g @ w2, lambda: mid @ w1, lambda: mid.t() @ h,
                    lambda: g.t() @ mid)
        iters = max(3, min(30, 1_000_000 // n))
    with torch.no_grad():
        t = in_turns(fns, iters)
        matmul_ms = cuda_ms(lambda: [p() for p in products], iters)
    bound, by = bound_ms(n, c, backward=g is not None)
    row = {"n": n, "c": c, "gelu": gelu_impl, "ms": sum(t["kernel"]) / 2,
           "plain_ms": sum(t["plain"]) / 2, "matmul_ms": matmul_ms, "bound_ms": bound,
           "bound_by": by, "library_ms": None, "turns": t}
    log(f"[kernels] ln_mlp_{'fwd' if g is None else 'bwd'}[{gelu_impl}] {tag}N={n} C={c}: kernel "
        f"{row['ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, {len(products)} torch.matmul "
        f"products {matmul_ms:.4f} ms, bound {bound:.4f} ms ({by}) (twin,kernel,kernel,twin: "
        f"{t['plain'][0]:.4f},{t['kernel'][0]:.4f},{t['kernel'][1]:.4f},{t['plain'][1]:.4f}) "
        f"on {card}")
    return row


def check_pit_widths(card: str):
    """Phase 3 at map_pit_s's widths (C = 144, 288, 576; hidden 4C) and its
    stage token counts at B=128 and B=256: kernel 1 with both GELUs and
    kernel 2 with both against their twins by phase 3's gates (KERNEL_RTOL,
    bit-equal across two runs); kernel 1 timed at B=256 with the exact GELU
    (the eval batch) and at B=128 with the fast one, kernel 2 at B=128 with
    the fast one (the train batch), each summed over one PiT forward or
    step (2, 6 and 4 launches a stage)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    rows, times = [], {"fwd_b256": [], "fwd_b128": [], "bwd_b128": []}
    for batch in (TRAIN_BATCH, BENCH_BATCH):
        for n, c in pit_shapes(batch):
            args = ln_mlp_args(n, c, gen)
            g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
            for gelu_impl in ("exact", "fast"):
                rows.append({"kernel": 1, **compare_forward(args, gelu_impl, f"PiT B={batch} ")})
                rows.append({"kernel": 2, **compare_backward(args, g, gelu_impl,
                                                            f"PiT B={batch} ")})
            tag = f"PiT B={batch} "
            if batch == BENCH_BATCH:
                times["fwd_b256"].append(time_ln_mlp(args, None, "exact", card, tag))
            else:
                times["fwd_b128"].append(time_ln_mlp(args, None, "fast", card, tag))
                times["bwd_b128"].append(time_ln_mlp(args, g, "fast", card, tag))
            del args, g
    per = {k: {m: weighted(v, m, PIT_DEPTHS) for m in ("ms", "plain_ms", "matmul_ms", "bound_ms")}
           for k, v in times.items()}
    for k, v in per.items():
        log(f"[kernels] {k} per {PIT} forward or step ({PIT_MLPS} launches): kernel "
            f"{v['ms']:.4f} ms, twin {v['plain_ms']:.4f} ms, torch.matmul products "
            f"{v['matmul_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms on {card}")
    torch.cuda.empty_cache()
    return rows, times, per


def pit_b256_arms(card: str) -> dict:
    """map_pit_s serving at B=256 at both IMTPU_TLNMLP arms: one eval forward
    each with 12 launches of kernel 1 at "1" and none at "0", the logits of
    the two within LOGITS_RTOL (the "0" arm's MLPs are the plain modules)."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.serving import make_serving_fn

    model = create_model(PIT, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    serve_fn = make_serving_fn(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    images = torch.randint(0, 256, (BENCH_BATCH, IMG, IMG, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    logits, launches = {}, {}
    for mode in ("1", "0"):
        cb._TLNMLP = mode
        before = cb.fused_ln_mlp.launches
        logits[mode] = serve_fn(images)
        torch.cuda.synchronize()
        launches[mode] = cb.fused_ln_mlp.launches - before
    cb._TLNMLP = "1"
    scale = logits["0"].abs().max().item()
    err = (logits["1"] - logits["0"]).abs().max().item()
    finite = all(bool(torch.isfinite(v).all()) and v.shape == (BENCH_BATCH, 1000)
                 for v in logits.values())
    log(f"[pit-serving] B={BENCH_BATCH}: kernel 1 launches at IMTPU_TLNMLP 1 / 0: "
        f"{launches['1']} / {launches['0']}; logits 1 vs 0 max|diff| {err:.4g} (tol "
        f"{LOGITS_RTOL * scale:.4g}, max|logit| {scale:.4g}); finite {finite}")
    if launches != {"1": PIT_MLPS, "0": 0} or not finite or not err <= LOGITS_RTOL * scale:
        raise AssertionError(f"{PIT} B={BENCH_BATCH} serving: launches {launches}, logits apart "
                             f"{err}, finite {finite}")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "max_abs_logit": scale}


def heads_item(card: str) -> dict:
    """Phase 29(c), the heads that raised until this slice: map_convnext_tiny
    with `split_norm=True, drop_rate=0.1` (SplitNormHeads) and
    map_maxvit_tiny_tf_224 with `drop_rate=0.1` (the fc dropout of its org
    and self-distill heads), bf16: one eval forward each (18 launches of
    kernel 1 in ConvNeXt's, none of kernel 3 in MaxViT's: its eval takes the
    composition) and one train step at B=HEADS_BATCH of the GA recipe (18 +
    18 launches of kernels 1 and 2, of kernels 3 and 4), finite logits and
    losses."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.nn.heads import SplitNormHead
    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state, make_train_step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    images = torch.randn(HEADS_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    targets = torch.rand(HEADS_BATCH, 1000, generator=gen, device="cuda")
    out = {}
    for name, kw, (fwd, bwd), eval_launches, launches in (
            ("map_convnext_tiny", dict(split_norm=True, drop_rate=0.1, ls_init_value=1.0),
             (cb.fused_ln_mlp, cb.fused_ln_mlp_bwd), sum(STAGE_DEPTHS), sum(STAGE_DEPTHS)),
            (MAXVIT, dict(drop_rate=0.1),
             (pa.fused_partition_attention, pa.fused_partition_attention_bwd), 0,
             MAXVIT_LAUNCHES)):
        model = create_model(name, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(SEED), **kw)
        heads = model.head.heads
        if name == MAXVIT:
            drops = {heads[0].drop.p, model.head.self_dt_heads[0].drop.p}
            if drops != {0.1}:
                raise AssertionError(f"{name}: the heads' fc dropout is {drops}, not 0.1")
        elif not all(isinstance(h, SplitNormHead) for h in heads):
            raise AssertionError(f"{name} with split_norm built no SplitNormHeads")
        opt = create_optimizer("lamb", **GA_RECIPE)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, create_loss_fn(bce_loss=True, smoothing=0.1,
                                                          mixup_active=True), dec_lam=-0.8)
        fwd.launches = bwd.launches = 0
        with torch.inference_mode():
            logits = model(images)
        got_eval = fwd.launches
        finite = all(bool(torch.isfinite(t).all()) for t in logits)
        fwd.launches = bwd.launches = 0
        torch.manual_seed(SEED + 31)  # the heads' dropout masks
        state, m = step(state, images, targets, gen)
        got = (fwd.launches, bwd.launches)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        log(f"[heads] {name} {kw}: {type(heads[0]).__name__} heads; eval forward "
            f"{got_eval} launches of {fwd.__name__}, finite logits {finite}; one train step at "
            f"B={HEADS_BATCH}: ({fwd.__name__}, {bwd.__name__}) launches {got}, loss {loss:.6f}, "
            f"grad norm {gnorm:.6f}")
        if not (got_eval == eval_launches and got == (launches, launches) and finite
                and loss == loss and abs(loss) != float("inf") and gnorm == gnorm):
            raise AssertionError(f"{name}: eval launches {got_eval} (want {eval_launches}), step "
                                 f"launches {got} (want {launches} each), finite logits "
                                 f"{finite}, loss {loss}, grad norm {gnorm}")
        out[name] = {"eval_launches": got_eval, "step_launches": got, "loss": loss,
                     "grad_norm": gnorm}
        del model, state, step, opt
        torch.cuda.empty_cache()
    return out


def pit_path(card: str) -> dict:
    """Phase 29: map_pit_s (full width and depth, random weights from SEED,
    bf16, 224 px) with IMTPU_TLNMLP at "1" (`ops.convnext_block._TLNMLP`; the
    phase sets it and puts it back at "0"): serving (four requests with 12
    launches of kernel 1 each, none of kernel 2; logits against the plain
    path and an fp32 model; one eval step; eval img/s at B=256 at "1" and
    "0" in turns), B=256 serving at both arms (`pit_b256_arms`); two train
    steps of the GA recipe at B=128 with 12 + 12 launches of kernels 1 and 2
    a step, the first against the plain path and an fp32 model by
    `compare_grads`' default gates ("apart" and "ratio"); train img/s at
    "1" and "0" in turns; then the
    heads item (`heads_item`). "launches" are kernels 1 and 2's counts over
    the PiT runs, set to 0 before them."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb

    fwd, bwd = cb.fused_ln_mlp, cb.fused_ln_mlp_bwd
    t0 = time.perf_counter()
    cb._TLNMLP = "1"
    served, serve = serve_branches(card, PIT, (fwd, bwd), PIT_MLPS, "pit-", arms="IMTPU_TLNMLP")
    served_bwd = bwd.launches
    b256 = pit_b256_arms(card)
    served += b256["launches"]["1"]
    kernel, plain, images, targets, launches, check = train_cswin(
        ((fwd, PIT_MLPS), (bwd, PIT_MLPS)), steps=2, tag="pit-", name=PIT,
        zero_grad=PIT_ZERO_GRAD, noisy=())
    del plain
    arms = switch_arms("IMTPU_TLNMLP", kernel, None, images, targets, card, f"{PIT} (GA recipe)",
                       (("1", "kernel"), ("0", "kernel")))
    total = {"fwd": served + launches[fwd.__name__], "bwd": served_bwd + launches[bwd.__name__]}
    del kernel, images, targets
    cb._TLNMLP = "0"
    torch.cuda.empty_cache()
    heads = heads_item(card)
    log(f"[pit] phase 29 in {time.perf_counter() - t0:.1f} s; kernel 1 and 2 launches on "
        f"{PIT}: {total}")
    return {"serving": serve, "serving_b256": b256, "train": check, "train_launches": launches,
            "train_arms": arms, "heads": heads, "launches": total}


def fastervit_repeat(images, targets) -> dict:
    """Two bf16 train steps of FasterViT from one state (a deep copy), with
    the same drop-path and dropout draws, at IMTPU_PALLAS_BN "full": every
    gradient must be bit-equal (no step of the path adds by atomics: the
    TokenInitializer's average pool, the bias gather's one-hot product,
    kernels 7 and 8)."""
    import torch

    from imagenet_models_tpu_torch.train.state import make_train_step

    state, opt, loss_fn = bn_trainer(FASTERVIT, torch.bfloat16, FASTERVIT_RECIPE,
                                     **FASTERVIT_DROPS)
    runs = [(state, opt), (copy.deepcopy(state), FirstGrads(opt.opt))]
    grads = []
    for st, o in runs:
        step = make_train_step(st.model, o, loss_fn, dec_lam=-0.8)
        torch.manual_seed(SEED + 10)
        step(st, images, targets, torch.Generator(device="cuda").manual_seed(SEED + 10))
        grads.append(o.grads)
    leaves = len(grads[0])
    differ = sorted(k for k in grads[0] if not torch.equal(grads[0][k], grads[1][k]))
    log(f"[fastervit-train] two bf16 steps from one state: {leaves - len(differ)} of {leaves} "
        f"gradients bit-equal" + (f"; differ: {differ[:8]}" if differ else ""))
    if differ:
        raise AssertionError(f"{FASTERVIT}: {len(differ)} gradients differ between two steps "
                             f"from the same state: {differ[:8]}")
    del runs, grads, state
    torch.cuda.empty_cache()
    return {"leaves": leaves, "differ": differ}


def fastervit_path(card: str) -> dict:
    """Phase 30: map_faster_vit_3_224 (full width and depth, random weights
    from SEED, bf16, 224 px) with IMTPU_PALLAS_BN at "full"
    (`ops.batch_norm._PALLAS_BN_MODE`; the phase sets it and puts it back at
    "0"): serving as phase 15 (no launch at eval; logits against the plain
    path and an fp32 model; eval img/s at B=256 at "full" and "0" in turns);
    FASTERVIT_STEPS train steps of the faster_vit_3 recipe at B=128 with
    kernels 7 and 8 launched once per training BatchNorm (a census of the
    model), the first against the plain path and an fp32 model by phase 16's
    gates (`train_bn`); two steps from one state with bit-equal gradients
    (`fastervit_repeat`); train img/s at "full" and "0" in turns; kernels 7
    and 8 against their twins and timed per launch at the census's shapes
    (`bn_shape_times`). "launches" are kernels 7 and 8's counts over the
    train steps."""
    import torch

    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    t0 = time.perf_counter()
    bn_ops._PALLAS_BN_MODE = "full"
    serve = serve_bn(FASTERVIT, card, "fastervit", arms="IMTPU_PALLAS_BN")
    bn_ops._PALLAS_BN_MODE = "full"
    kernel, plain, images, targets, launches, check = train_bn(
        FASTERVIT, FASTERVIT_RECIPE, FASTERVIT_STEPS, IMG, "fastervit",
        zero_kinds=FASTERVIT_ZERO_GRAD, **FASTERVIT_DROPS)
    del plain
    census = bn_census(kernel[0].model, images)
    arms = switch_arms("IMTPU_PALLAS_BN", kernel, None, images, targets, card,
                       f"{FASTERVIT} (LAMB, clip 5.0, drop-path 0.3)",
                       (("full", "kernel"), ("0", "kernel")))
    del kernel
    torch.cuda.empty_cache()
    bn_ops._PALLAS_BN_MODE = "full"
    repeat = fastervit_repeat(images, targets)
    del images, targets
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    rows, times = bn_shape_times(census, gen, card)
    totals = {w: {k: (sum(r["count"] * r[k] for r in times[w])
                      if all(r[k] is not None for r in times[w]) else None)
                  for k in ("ms", "device_ms", "bare_ms", "plain_ms", "library_ms", "bound_ms")}
              for w in times}
    log(f"[kernels] per {FASTERVIT} train step (ms, weighted by launches): kernel 7 "
        f"{totals['fwd']}; kernel 8 {totals['bwd']} on {card}")
    bn_ops._PALLAS_BN_MODE = "0"
    torch.cuda.empty_cache()
    log(f"[fastervit] phase 30 in {time.perf_counter() - t0:.1f} s; census "
        + ", ".join(f"{s}x{n}" for (s, _), n in census.items()))
    return {"serving": serve, "train": check, "train_launches": launches, "train_arms": arms,
            "repeat": repeat, "census": {f"{s}": n for (s, _), n in census.items()},
            "checks": rows, "times": times, "per_step_ms": totals, "launches": launches}


# ---------------------------------------------------------------- fine-tuning at 384 px

# phase 31: the fine-tune flow (module docstring). (a) and (b) start
# maxvit_tiny_tf_384 from a maxvit_tiny_tf_224 .pth.tar that the port writes
FT_SOURCE, FT_MODEL = "maxvit_tiny_tf_224", "maxvit_tiny_tf_384"
FT_IMG, FT_BATCH = 384, 32
FT_PS = (12, 12)
# maxvit_tiny_tf_384's stages that take kernels 3 and 4 (map side, C, heads):
# 12x12 windows of T = 144 on the 96, 48 and 24 px maps of stages 0-2 (2, 2
# and 5 blocks, a block and a grid attention each: 18 launches a step); stage
# 3's 12x12 map is one window
FT_STAGES = ((96, 64, 2), (48, 128, 4), (24, 256, 8))
FT_LAUNCHES_STEP = sum(MAXVIT_STAGE_LAUNCHES)
FT_ENTRY_IMAGES, FT_ENTRY_BATCH, FT_ENTRY_STEPS = 64, 16, 2
FT_DIR = Path("output") / "chip_smoke_finetune"
# (c) MaxViT's eval forward with IMTPU_PART_ATTN at "all": kernel 3 on the
# B=256 stage shapes of phase 8, once per block and grid attention
# (d) ga_cswin_tiny with IMTPU_STRIPE_MAXH at 56: stage 1 (56 rows, ws = 1,
# one block) and stage 2 (28 rows, ws = 2, two blocks) take kernels 5 and 6
# too
STRIPE_MAXH_WIDE = 56
WIDE_STRIPES = tuple(s for s in CSWIN_STRIPES if not s[-1])
WIDE_LAUNCHES = (1, 2)
MAXH_LAUNCHES = CSWIN_LAUNCHES + sum(WIDE_LAUNCHES)


def write_source_checkpoint(path: Path) -> dict:
    """The 224 px checkpoint of phase 31: a maxvit_tiny_tf_224 `.pth.tar`
    from seed-0 weights, written by `ckpt.saver.export_pth_tar`. Its TF
    rel-pos tables start at zero, so they are drawn trunc-normal from a seed
    first, or their re-resolution would move nothing."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.ckpt.saver import export_pth_tar
    from imagenet_models_tpu_torch.nn.layers import trunc_normal_

    model = create_model(FT_SOURCE, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 31)
    tables = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                tables[name] = trunc_normal_(p, generator=gen).clone()
    path.parent.mkdir(parents=True, exist_ok=True)
    export_pth_tar(model, str(path))
    return tables


def finetune_trainer(path: Path, tables: dict):
    """maxvit_tiny_tf_384 in bf16 with the maxvit_tiny recipe
    (`maxvit_trainer`'s), its weights from the 224 px `.pth.tar` through the
    reference-file load, which re-resolves each rel-pos table 13x13 -> 23x23;
    the loaded tables checked against `convert.resize_rel_pos_table` of the
    written ones."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.ckpt.convert import resize_rel_pos_table
    from imagenet_models_tpu_torch.ckpt.saver import resume_checkpoint
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state

    model = create_model(FT_MODEL, dtype=torch.bfloat16, drop_path_rate=MAXVIT_DROP_PATH,
                         generator=torch.Generator().manual_seed(SEED + 1))
    resume_checkpoint(str(path), model)
    own = model.state_dict()
    errs = []
    for k, t in tables.items():
        want = resize_rel_pos_table(t, own[k].shape, k)
        errs.append((own[k].cpu() - want).abs().max().item())
    shapes = sorted({tuple(own[k].shape[1:]) for k in tables})
    log(f"[finetune] {FT_MODEL} loaded from {path.name} ({FT_SOURCE}): {len(tables)} rel-pos "
        f"tables re-resolved {sorted({tuple(t.shape[1:]) for t in tables.values()})} -> {shapes}, "
        f"largest |diff| from resize_rel_pos_table {max(errs):.3g}")
    if shapes != [(23, 23)] or max(errs) != 0.0:
        raise AssertionError(f"phase 31: the rel-pos tables were not re-resolved on load: "
                             f"{shapes}, {max(errs)}")
    opt = FirstGrads(create_optimizer("lamb", **MAXVIT_RECIPE))
    return create_train_state(model, opt), opt, create_loss_fn(bce_loss=True, smoothing=0.1,
                                                               mixup_active=True)


def finetune_checkpointing(path: Path, tables: dict, card: str) -> dict:
    """31a: one B=32 train step of maxvit_tiny_tf_384 from one state, with
    grad_checkpointing off and on: loss, grad norm, every gradient, every
    BatchNorm running statistic and the next DropPath draw bit-equal; kernel
    3 launched 18 times a step without checkpointing and 36 with (the
    recompute), kernel 4 18 times in both; each arm's peak memory, and its
    img/s in turns."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.train.state import make_train_step

    state, opt, loss_fn = finetune_trainer(path, tables)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    images = torch.randn(FT_BATCH, FT_IMG, FT_IMG, 3, generator=gen, device="cuda")
    targets = torch.rand(FT_BATCH, 1000, generator=gen, device="cuda")
    arms = {}
    for name, on in (("plain", False), ("checkpointed", True)):
        st = copy.deepcopy(state)
        st.model.grad_checkpointing = on
        arm_opt = FirstGrads(opt.opt)
        arms[name] = {"state": st, "opt": arm_opt,
                      "step": make_train_step(st.model, arm_opt, loss_fn, dec_lam=-0.8)}
    del state
    torch.cuda.empty_cache()
    out = {}
    for name, arm in arms.items():
        pa.fused_partition_attention.launches = pa.fused_partition_attention_bwd.launches = 0
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(SEED + 31)
        gen.manual_seed(SEED + 32)
        arm["state"], m = arm["step"](arm["state"], images, targets, gen)
        torch.cuda.synchronize()
        out[name] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                     "launches": [pa.fused_partition_attention.launches,
                                  pa.fused_partition_attention_bwd.launches],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "step_peak_gib": (torch.cuda.max_memory_allocated() - start) / 2 ** 30,
                     "next_draw": torch.rand(8, generator=gen, device="cuda")}
    p, c = arms["plain"], arms["checkpointed"]
    grads = [k for k in p["opt"].grads if not torch.equal(p["opt"].grads[k], c["opt"].grads[k])]
    stats_p, stats_c = p["state"].batch_stats(), c["state"].batch_stats()
    stats = [k for k in stats_p if not torch.equal(stats_p[k], stats_c[k])]
    differ = {"loss": out["plain"]["loss"] != out["checkpointed"]["loss"],
              "grad_norm": out["plain"]["grad_norm"] != out["checkpointed"]["grad_norm"],
              "gradients": grads, "batch_stats": stats,
              "next_draw": not torch.equal(out["plain"]["next_draw"],
                                           out["checkpointed"]["next_draw"])}
    bad = {k: v for k, v in differ.items() if v}
    log(f"[finetune] 31a {FT_MODEL} B={FT_BATCH} {FT_IMG}px bf16, one step from one state, "
        f"grad_checkpointing off / on: loss {out['plain']['loss']:.6f} / "
        f"{out['checkpointed']['loss']:.6f}, grad_norm {out['plain']['grad_norm']:.6f} / "
        f"{out['checkpointed']['grad_norm']:.6f}; {len(p['opt'].grads)} gradients, "
        f"{len(stats_p)} BatchNorm statistics and the next DropPath draw "
        + ("bit-equal" if not bad else f"NOT bit-equal: {bad}")
        + f"; kernels 3, 4 launches {out['plain']['launches']} / {out['checkpointed']['launches']}"
        f"; peak memory {out['plain']['peak_gib']:.2f} / {out['checkpointed']['peak_gib']:.2f} "
        f"GiB ({out['plain']['step_peak_gib']:.2f} / {out['checkpointed']['step_peak_gib']:.2f} "
        f"GiB over the step's start) on {card}")
    if bad:
        raise AssertionError(f"phase 31a: the checkpointed step differs from the plain one in {bad}")
    if out["plain"]["launches"] != [FT_LAUNCHES_STEP, FT_LAUNCHES_STEP] or \
            out["checkpointed"]["launches"] != [2 * FT_LAUNCHES_STEP, FT_LAUNCHES_STEP]:
        raise AssertionError(f"phase 31a: kernel 3 and 4 launches {out}, want 18, 18 without "
                             f"checkpointing and 36, 18 with")
    for arm in arms.values():
        arm["opt"].grads = {}
    fns = {name: (lambda arm=arm: arm["step"](arm["state"], images, targets, gen))
           for name, arm in arms.items()}
    for fn in fns.values():
        fn()
    t = in_turns(fns, 2, order=("plain", "checkpointed"))
    img_s = {k: [FT_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    log(f"[finetune] 31a train img/s in turns (plain,checkpointed,checkpointed,plain): "
        f"{img_s['plain'][0]:.1f},{img_s['checkpointed'][0]:.1f},{img_s['checkpointed'][1]:.1f},"
        f"{img_s['plain'][1]:.1f} on {card}")
    segments = {name: memory_segments(arm["state"].model, fns[name]) for name, arm in arms.items()}
    del arms, fns
    torch.cuda.empty_cache()
    for arm in out.values():
        arm.pop("next_draw")
    return {"arms": out, "img_s": img_s, "memory_segments": segments,
            "launches": {"fwd": out["plain"]["launches"][0] + out["checkpointed"]["launches"][0],
                         "bwd": out["plain"]["launches"][1] + out["checkpointed"]["launches"][1]}}



def memory_segments(model, run) -> dict:
    """Where one train step (`run()`) reaches its peak memory: a mark at the
    start, at the stem's and the head's ends and at each block's start and
    end, each mark the bytes allocated there and the peak since the mark
    before (the peak statistic is reset at each). A checkpointed block's
    start fires again when the backward recomputes it, so in the backward
    the segment from one recompute's start to the next is that block's
    recompute and backward. Logged: the step's largest segment, the bytes
    the forward keeps for the backward, and the block whose forward takes
    the most over its start."""
    import torch

    marks = []

    def mark(label):
        marks.append({"at": label, "allocated": torch.cuda.memory_allocated(),
                      "peak_since_last": torch.cuda.max_memory_allocated()})
        torch.cuda.reset_peak_memory_stats()

    seen = {}

    def starts(name):
        def hook(module, args):
            seen[name] = seen.get(name, 0) + 1
            mark(f"{name} {'recompute' if seen[name] > 1 else 'forward'} start")
        return hook

    handles = []
    for name, m in model.named_modules():
        if name.count(".") == 3 and name.startswith("stages.") and ".blocks." in name:
            handles += [m.register_forward_pre_hook(starts(name)),
                        m.register_forward_hook(lambda m, a, o, name=name: mark(f"{name} end"))]
    handles += [model.stem.register_forward_hook(lambda m, a, o: mark("stem end")),
                model.head.register_forward_hook(lambda m, a, o: mark("head end"))]
    try:
        torch.cuda.synchronize()
        mark("step start")
        run()
        torch.cuda.synchronize()
        mark("step end")
    finally:
        for h in handles:
            h.remove()
    base = marks[0]["allocated"]
    gib = 2 ** 30
    # segment i: from mark i-1 to mark i, named by both
    segs = [{"from": a["at"], "to": b["at"], "start_gib": (a["allocated"] - base) / gib,
             "peak_gib": (b["peak_since_last"] - base) / gib} for a, b in zip(marks, marks[1:])]
    top = max(segs, key=lambda g: g["peak_gib"])
    kept = next(m for m in marks if m["at"] == "head end")["allocated"] - base
    fwd = [g for g in segs if g["from"].endswith("forward start")]
    widest = max(fwd, key=lambda g: g["peak_gib"] - g["start_gib"])
    log(f"[finetune] 31a memory, {'checkpointed' if seen and max(seen.values()) > 1 else 'plain'}"
        f" step, over the step's start: peak {top['peak_gib']:.2f} GiB from '{top['from']}' to "
        f"'{top['to']}' (held at its start {top['start_gib']:.2f}); kept by the forward for the "
        f"backward {kept / gib:.2f}; the widest block forward {widest['from'].split()[0]}, "
        f"{widest['peak_gib'] - widest['start_gib']:.2f} over its start")
    return {"segments": segs, "peak": top, "kept_gib": kept / gib, "widest_forward": widest}


class _Records(logging.Handler):
    """The messages of one logger, kept."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def finetune_entry(path: Path, card: str) -> dict:
    """31b: the train entry with -fp on maxvit_tiny_tf_384 (synthetic:64,
    B=16, one epoch of two steps, --amp, the maxvit_tiny recipe): it exits
    0, drops the fc keys as JAX does (its log line), and launches kernels 3
    and 4 18 times a step; then the validate entry with --extract-logits on
    the run's checkpoint, two batches: finite logits of the heads' shape."""
    import importlib.util
    import os
    import shutil

    import numpy as np
    import torch

    from imagenet_models_tpu_torch.cli import train as cli_train
    from imagenet_models_tpu_torch.cli import validate as cli_validate
    from imagenet_models_tpu_torch.ops import partition_attention as pa

    workers = min(8, os.cpu_count() or 1)
    bound = ({} if importlib.util.find_spec("PIL") else
             bind_resident_loader((cli_train, cli_validate), "finetune", FT_ENTRY_IMAGES))
    shutil.rmtree(FT_DIR, ignore_errors=True)
    records = _Records()
    logging.getLogger("train").addHandler(records)
    npz = OUT_DIR / "phase31_logits.npz"
    try:
        pa.fused_partition_attention.launches = pa.fused_partition_attention_bwd.launches = 0
        torch.cuda.synchronize()
        result = cli_train.main([
            f"synthetic:{FT_ENTRY_IMAGES}", "--model", FT_MODEL, "-b", str(FT_ENTRY_BATCH),
            "--epochs", "1", "--cooldown-epochs", "0", "--max-steps-per-epoch",
            str(FT_ENTRY_STEPS), "--amp", "--opt", "lamb", "--lr", "8e-3", "--weight-decay",
            "0.05", "--clip-grad", "1.0", "--smoothing", "0.1", "--bce-loss", "--drop-path",
            str(MAXVIT_DROP_PATH), "-fp", str(path), "-j", str(workers), "--output", str(FT_DIR),
            "--experiment", "finetune"])
        torch.cuda.synchronize()
        launches = [pa.fused_partition_attention.launches, pa.fused_partition_attention_bwd.launches]
        said = [m for m in records.messages if m.startswith("fine-tuning from")]
        steps = sum(e["train_stats"].steps for e in result["epochs"])
        losses = [e["train"]["loss"] for e in result["epochs"]]
        log(f"[finetune] 31b train entry -fp {path.name} on {FT_MODEL}, B={FT_ENTRY_BATCH} "
            f"{FT_IMG}px bf16: exit {result['exit']}, {steps} steps, losses {losses}, kernels 3 "
            f"and 4 launches {launches}; the entry said {said}")
        ok = (result["exit"] == "done" and steps == FT_ENTRY_STEPS
              and said == [f"fine-tuning from {path} (2 fc keys dropped)"]
              and launches == [FT_LAUNCHES_STEP * steps] * 2 and finite(losses))
        if not ok:
            raise AssertionError(f"phase 31b: the fine-tune run failed its checks: {result}, "
                                 f"{said}, {launches}")
        run = Path(result["output_dir"])
        [res] = cli_validate.main([
            f"synthetic:{FT_ENTRY_IMAGES}", "--model", FT_MODEL, "--amp", "-b",
            str(FT_ENTRY_BATCH), "--max-batches", "2", "-j", str(workers), "--checkpoint",
            str(run / "last"), "--extract-logits", str(npz)])
        data = np.load(npz)
        shape = tuple(data["logits"].shape)
        log(f"[finetune] 31b validate entry --extract-logits on {run.name}/last: top-1 "
            f"{res['top1']}, npz logits {shape} per_token {bool(data['per_token'])}, "
            f"finite {bool(np.isfinite(data['logits']).all())}, bias entries "
            f"{sorted(k for k in data.files if k.startswith('bias::'))}")
        if shape != (2 * FT_ENTRY_BATCH, 1, 1000) or not np.isfinite(data["logits"]).all():
            raise AssertionError(f"phase 31b: --extract-logits wrote {shape}")
    finally:
        logging.getLogger("train").removeHandler(records)
        for mod, (ds, ld) in bound.items():
            mod.create_dataset, mod.create_loader = ds, ld
        shutil.rmtree(FT_DIR, ignore_errors=True)
        npz.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    return {"exit": result["exit"], "steps": steps, "losses": losses, "launches": launches,
            "said": said, "validate": res, "logits_shape": list(shape)}


def part_attn_all(card: str) -> dict:
    """31c: map_maxvit_tiny_tf_224's eval forward at B=256 with
    IMTPU_PART_ATTN at "all" (`ops.window_attention._PART_ATTN`) against
    "fused": 18 launches of kernel 3 a forward at "all", none at "fused";
    the logits at "all" within phase 9's gate of the plain path (the twin)
    and of "fused"'s composition; eval img/s of both in turns; kernel 3 at
    these B=256 shapes against its twin, timed beside it, the bound and SDPA."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.nn.heads import average_head_logits
    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    errs, times = [], []
    for side, c, nh in MAXVIT_STAGES:
        args = attn_args(BENCH_BATCH, side, side, nh, PS, gen)
        qkv, bias, _ = args
        with torch.no_grad():
            for part in ("block", "grid"):
                got = pa.fused_partition_attention(qkv, bias, part, PS, nh)
                ref = pa.plain_partition_attention(qkv, bias, part, PS, nh)
                errs.append((got.float() - ref.float()).abs().max().item())
                ratio = rel_err(got, ref)
                log(f"[finetune] 31c kernel 3 B={BENCH_BATCH} {side}x{side} [{part}]: "
                    f"max|kernel-twin|/max|twin| {ratio:.3g} (tol {KERNEL_RTOL})")
                if not ratio <= KERNEL_RTOL:
                    raise AssertionError(f"phase 31c: kernel 3 disagrees with its twin at "
                                         f"B={BENCH_BATCH} {side}x{side} [{part}]")
                del got, ref
        times.append(attn_stage_times(args, side, c, nh, PS, kinds=("fwd",))["fwd"])
        del qkv, bias, args
    model = create_model(MAXVIT, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    x = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    out = {}
    with torch.inference_mode():
        for mode in ("all", "fused"):
            wa._PART_ATTN = mode
            pa.fused_partition_attention.launches = 0
            logits = average_head_logits(model(x))
            torch.cuda.synchronize()
            out[mode] = (logits, pa.fused_partition_attention.launches)
        wa._PART_ATTN = "all"
        plain = average_head_logits(model(x, use_kernel=False))
        scale = plain.abs().max().item()
        err = (out["all"][0] - plain).abs().max().item()
        err_fused = (out["all"][0] - out["fused"][0]).abs().max().item()

        def arm(mode):
            def run():
                wa._PART_ATTN = mode
                model(x)
            return run

        t = in_turns({"fused": arm("fused"), "all": arm("all")}, BENCH_ITERS,
                     order=("fused", "all"))
    wa._PART_ATTN = "fused"
    img_s = {k: [BENCH_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    launches = {k: v[1] for k, v in out.items()}
    log(f"[finetune] 31c {MAXVIT} eval B={BENCH_BATCH} bf16: kernel 3 launches a forward "
        f"{launches}; logits at 'all' vs the plain path max|diff| {err:.4g}, vs 'fused' "
        f"{err_fused:.4g} (tol {LOGITS_RTOL * scale:.4g}); img/s in turns (fused,all,all,fused) "
        f"{img_s['fused'][0]:.1f},{img_s['all'][0]:.1f},{img_s['all'][1]:.1f},"
        f"{img_s['fused'][1]:.1f} on {card}")
    if launches != {"all": FT_LAUNCHES_STEP, "fused": 0}:
        raise AssertionError(f"phase 31c: kernel 3 launches {launches}, want 18 at 'all', 0 at "
                             "'fused'")
    if not (err <= LOGITS_RTOL * scale and err_fused <= LOGITS_RTOL * scale):
        raise AssertionError("phase 31c: the logits at 'all' disagree with the plain path")
    del model, x
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "vs_fused": err_fused, "max_abs_plain": scale,
            "img_s": img_s, "kernel_errs": errs, "times": times}


def stripe_maxh(card: str, stripe_rows) -> dict:
    """31d: ga_cswin_tiny with IMTPU_STRIPE_MAXH at 56 against 16
    (`ops.stripe_attention._STRIPE_MAXH`): eval at B=256 in turns, kernel 5
    launched 30 and 27 times a forward, the logits of each arm within phase
    12's gate of the plain path; a first train step at B=128 at 56 held to
    phase 13's gates (`train_cswin`, two steps), and kernels 5 and 6 counted
    per step at both; train img/s in turns; kernels 5 and 6 timed at the
    stage-1 and stage-2 shapes that 56 admits (phase 11 held them to their
    twins there)."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.nn.heads import average_head_logits
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    times = {"fwd": [], "bwd": []}
    for name, side, ws, c, nh, _ in WIDE_STRIPES:
        args = stripe_args(TRAIN_BATCH, side, side, c, gen)
        tag = f"{name} B={TRAIN_BATCH} {side}x{side} ws={ws} C={c} heads={nh}"
        for which, row in stripe_stage_times(args, name, side, ws, c, nh, tag).items():
            times[which].append(row)
        del args
    errs = {"fwd": [r["max_abs_err"]["out"] for r in stripe_rows
                    if r["tag"].split()[0] in ("stage1", "stage2")],
            "bwd": [max(r["max_abs_err"][k] for k in STRIPE_OUTPUTS[1:]) for r in stripe_rows
                    if r["tag"].split()[0] in ("stage1", "stage2")]}
    model = create_model(GA_CSWIN, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    x = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    evals = {}
    with torch.inference_mode():
        for maxh in (STRIPE_MAXH_WIDE, 16):
            sa._STRIPE_MAXH = maxh
            sa.fused_stripe_attention.launches = 0
            logits = average_head_logits(model(x))
            torch.cuda.synchronize()
            launches = sa.fused_stripe_attention.launches
            plain = average_head_logits(model(x, use_kernel=False))
            scale = plain.abs().max().item()
            evals[maxh] = {"launches": launches, "max_abs_err": (logits - plain).abs().max().item(),
                           "max_abs_plain": scale, "logits": logits}

        def arm(maxh):
            def run():
                sa._STRIPE_MAXH = maxh
                model(x)
            return run

        t = in_turns({"16": arm(16), "56": arm(STRIPE_MAXH_WIDE)}, BENCH_ITERS, order=("16", "56"))
    sa._STRIPE_MAXH = 16
    apart = (evals[16]["logits"] - evals[STRIPE_MAXH_WIDE]["logits"]).abs().max().item()
    for e in evals.values():
        e.pop("logits")
    eval_img_s = {k: [BENCH_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    log(f"[finetune] 31d {GA_CSWIN} eval B={BENCH_BATCH} bf16, IMTPU_STRIPE_MAXH 56 / 16: "
        f"kernel 5 launches a forward {evals[STRIPE_MAXH_WIDE]['launches']} / "
        f"{evals[16]['launches']}; logits vs the plain path max|diff| "
        f"{evals[STRIPE_MAXH_WIDE]['max_abs_err']:.4g} / {evals[16]['max_abs_err']:.4g} (tol "
        f"{LOGITS_RTOL} of max|plain|), 56 vs 16 {apart:.4g}; img/s in turns (16,56,56,16) "
        f"{eval_img_s['16'][0]:.1f},{eval_img_s['56'][0]:.1f},{eval_img_s['56'][1]:.1f},"
        f"{eval_img_s['16'][1]:.1f} on {card}")
    if {k: e["launches"] for k, e in evals.items()} != {STRIPE_MAXH_WIDE: MAXH_LAUNCHES,
                                                         16: CSWIN_LAUNCHES}:
        raise AssertionError(f"phase 31d: kernel 5 launches {evals}")
    if not all(e["max_abs_err"] <= LOGITS_RTOL * e["max_abs_plain"] for e in evals.values()):
        raise AssertionError(f"phase 31d: the eval logits disagree with the plain path: {evals}")
    del model, x
    torch.cuda.empty_cache()

    sa._STRIPE_MAXH = STRIPE_MAXH_WIDE
    try:
        kernel, plain, images, targets, launches, check = train_cswin(
            ((sa.fused_stripe_attention, MAXH_LAUNCHES),
             (sa.fused_stripe_attention_bwd, MAXH_LAUNCHES)), steps=2, tag="maxh56-")
        del plain
        st, step = kernel
        per_step = {}
        for maxh in (16, STRIPE_MAXH_WIDE):
            sa._STRIPE_MAXH = maxh
            sa.fused_stripe_attention.launches = sa.fused_stripe_attention_bwd.launches = 0
            step(st, images, targets, gen)
            torch.cuda.synchronize()
            per_step[maxh] = [sa.fused_stripe_attention.launches,
                              sa.fused_stripe_attention_bwd.launches]

        def train_arm(maxh):
            def run():
                sa._STRIPE_MAXH = maxh
                step(st, images, targets, gen)
            return run

        t = in_turns({"16": train_arm(16), "56": train_arm(STRIPE_MAXH_WIDE)}, 2,
                     order=("16", "56"))
    finally:
        sa._STRIPE_MAXH = 16
    train_img_s = {k: [TRAIN_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    log(f"[finetune] 31d {GA_CSWIN} train B={TRAIN_BATCH}: kernels 5, 6 launches a step at 16 "
        f"{per_step[16]}, at 56 {per_step[STRIPE_MAXH_WIDE]}; img/s in turns (16,56,56,16) "
        f"{train_img_s['16'][0]:.1f},{train_img_s['56'][0]:.1f},{train_img_s['56'][1]:.1f},"
        f"{train_img_s['16'][1]:.1f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB on {card}")
    if per_step != {16: [CSWIN_LAUNCHES] * 2, STRIPE_MAXH_WIDE: [MAXH_LAUNCHES] * 2}:
        raise AssertionError(f"phase 31d: kernels 5 and 6 launches a step {per_step}")
    del kernel, st, step, images, targets
    torch.cuda.empty_cache()
    # the wide stripes' launches: the counted eval forward and the counted
    # step at 56, less the same runs at 16
    wide = {"fwd": evals[STRIPE_MAXH_WIDE]["launches"] - evals[16]["launches"]
            + per_step[STRIPE_MAXH_WIDE][0] - per_step[16][0],
            "bwd": per_step[STRIPE_MAXH_WIDE][1] - per_step[16][1]}
    return {"eval": evals, "eval_56_vs_16": apart, "eval_img_s": eval_img_s, "train": check,
            "train_launches": launches, "per_step": per_step, "train_img_s": train_img_s,
            "times": times, "errs": errs, "launches": wide}


def finetune_path(card: str, stripe_rows) -> dict:
    """Phase 31 (module docstring): 31a-31d, and kernels 3 and 4 against
    their twins and timed at maxvit_tiny_tf_384's T = 144 stage shapes."""
    import torch

    t0 = time.perf_counter()
    path = OUT_DIR / "phase31" / f"{FT_SOURCE}.pth.tar"
    tables = write_source_checkpoint(path)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    rows, times = [], {"fwd": [], "bwd": []}
    for side, c, nh in FT_STAGES:
        args = attn_args(FT_BATCH, side, side, nh, FT_PS, gen)
        for part in ("block", "grid"):
            rows.append(compare_attention(args, part, FT_PS, nh, f"B={FT_BATCH} {side}x{side} "
                                                                 f"C={c} T=144"))
        for which, row in attn_stage_times(args, side, c, nh, FT_PS).items():
            times[which].append(row)
        del args
    try:
        ckpt = finetune_checkpointing(path, tables, card)
        entry = finetune_entry(path, card)
    finally:
        path.unlink(missing_ok=True)
    evals = part_attn_all(card)
    maxh = stripe_maxh(card, stripe_rows)
    seconds = time.perf_counter() - t0
    log(f"[finetune] phase 31 in {seconds:.1f} s")
    return {"checks_384": rows, "times_384": times, "checkpointing": ckpt, "entry": entry,
            "part_attn_all": evals, "stripe_maxh": maxh, "seconds": seconds}


# ---------------------------------------------------------------- phase 26's trace

DET_BATCH = 8
DET_OUT = OUT_DIR / "phase26"


def det_child(out: str) -> None:
    """`chip_smoke.py --phase26 <out>`: two fp32 map_convnext_tiny train
    steps (the GA recipe, B=8) from one state as the port runs them, which
    gradients differ between the two and by how much; then the same pair
    under `torch.use_deterministic_algorithms(True)`: the first op it
    refuses (its error), every op it warns of (warn_only), and whether the
    pair is then bit-equal. Runs in its own process, so that cuBLAS reads
    CUBLAS_WORKSPACE_CONFIG before its first handle. Writes JSON to `out`."""
    import warnings

    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = create_model("map_convnext_tiny", ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    opt = create_optimizer("lamb", **GA_RECIPE)
    state0 = create_train_state(model, opt, ema_decay=GA_EMA)
    loss_fn = create_loss_fn(bce_loss=True, smoothing=0.1, mixup_active=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    images = torch.randn(DET_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    targets = torch.rand(DET_BATCH, 1000, generator=gen, device="cuda")

    def one_step():
        st = copy.deepcopy(state0)
        keep = FirstGrads(opt)
        step = make_train_step(st.model, keep, loss_fn, dec_lam=-0.8, ema_decay=GA_EMA)
        torch.manual_seed(SEED + 26)
        st, m = step(st, images, targets, torch.Generator(device="cuda").manual_seed(SEED + 26))
        torch.cuda.synchronize()
        return keep.grads, {k: v.item() for k, v in m.items()}, st.batch_stats()

    def pair():
        (g1, m1, b1), (g2, m2, b2) = one_step(), one_step()
        diff = {k: (g1[k] - g2[k]).abs().max().item() / max(g1[k].abs().max().item(), 1e-30)
                for k in g1 if not torch.equal(g1[k], g2[k])}
        return {"metrics": [m1, m2], "gradients": len(g1),
                "differing": dict(sorted(diff.items(), key=lambda kv: -kv[1])),
                "batch_stats_differing": [k for k in b1 if not torch.equal(b1[k], b2[k])]}

    result = {"default": pair()}
    torch.use_deterministic_algorithms(True)
    try:
        one_step()
        result["raised"] = None
    except RuntimeError as e:
        result["raised"] = " ".join(str(e).split())[:600]
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result["deterministic"] = pair()
    result["warned"] = sorted({" ".join(str(w.message).split())[:300] for w in caught
                               if "deterministic" in str(w.message)})
    Path(out).write_text(json.dumps(result))


def det_trace(card: str) -> dict:
    """Phase 26's trace (`det_child` in a child process): logs which
    gradients of two fp32 steps from one state differ, and what the
    deterministic mode names. It fails if the port's own pair differs (the
    fp32 convolutions' backward takes cuDNN's deterministic algorithms,
    `nn.layers._Fp32Conv`), or the deterministic mode refuses an op."""
    import os

    DET_OUT.mkdir(parents=True, exist_ok=True)
    out = DET_OUT / "trace.json"
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--phase26", str(out)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                          timeout=DP_TIMEOUT)
    for line in proc.stdout.splitlines()[-40:]:
        log(f"  [phase26 trace] {line}")
    if proc.returncode:
        raise AssertionError(f"phase 26: the trace's child process failed ({proc.returncode})")
    r = json.loads(out.read_text())
    for mode in ("default", "deterministic"):
        d = r[mode]
        top = list(d["differing"].items())[:8]
        log(f"[fp32] trace, map_convnext_tiny fp32 B={DET_BATCH}, two steps from one state, "
            f"{mode} algorithms: losses {[m['loss'] for m in d['metrics']]}, grad norms "
            f"{[m['grad_norm'] for m in d['metrics']]}; {len(d['differing'])} of {d['gradients']} "
            f"gradients differ (largest |diff|/max|g|: {top}); BatchNorm statistics differing "
            f"{d['batch_stats_differing']} on {card}")
    log(f"[fp32] trace: torch.use_deterministic_algorithms(True) raised: {r['raised']}; warned "
        f"of: {r['warned']}")
    if r["default"]["differing"] or r["default"]["batch_stats_differing"] or r["raised"]:
        raise AssertionError("phase 26: two fp32 steps from one state differ, or the "
                             f"deterministic mode refused an op: {r}")
    return r


# ---------------------------------------------------------------- the serving export

EXPORT_BATCH = 8
# a reloaded program against the live serving function on the same images:
# the bound of the export entry's --selftest, JAX's; the same kernels on the
# same inputs give the same bits, which the log reports
EXPORT_ATOL = 1e-3
# phase 32's exports: (tag, model, switch, its value, the op it is counted
# by, that op's launches a call). The switch is a module attribute the trace
# reads (`switched`): IMTPU_PART_ATTN "all" takes kernel 3 at eval,
# IMTPU_FLASH_ATTN "1" kernels 12 and 13
EXPORTS = (("32a", "map_convnext_tiny", None, None, "ln_mlp_fwd", sum(STAGE_DEPTHS)),
           ("32b", GA_CSWIN, None, None, "stripe_attn_fwd", CSWIN_LAUNCHES),
           ("32c", MAXVIT, "IMTPU_PART_ATTN", "all", "partition_attn_fwd", MAXVIT_LAUNCHES),
           ("32c", MAXVIT, "IMTPU_FLASH_ATTN", "1", "window_attn_heads_fwd",
            MAXVIT_FLASH_LAUNCHES),
           ("32c", GA_CSWIN, "IMTPU_FLASH_ATTN", "1", "window_attn_fwd", CSWIN_FLASH_LAUNCHES))
# the phase-4 build of each model: map_convnext_tiny with unit layer scales
EXPORT_MODEL_KW = {"map_convnext_tiny": dict(ls_init_value=1.0)}
# what the child that loads the programs must not import: the model code
MODEL_CODE = ("imagenet_models_tpu_torch.models", "imagenet_models_tpu_torch.nn.layers",
              "imagenet_models_tpu_torch.nn.heads", "imagenet_models_tpu_torch.nn.ga_head",
              "imagenet_models_tpu_torch.nn.vit")


def op_counters() -> dict:
    """The wrapper of each `imtpu::` op by op name; each counts its launches."""
    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.ops import flash_attention as fa
    from imagenet_models_tpu_torch.ops import partition_attention as pa
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    return {"ln_mlp_fwd": cb.fused_ln_mlp, "partition_attn_fwd": pa.fused_partition_attention,
            "stripe_attn_fwd": sa.fused_stripe_attention,
            "window_attn_fwd": fa.fused_window_attention,
            "window_attn_heads_fwd": fa.fused_window_attention_heads}


@contextlib.contextmanager
def switched(switch, value):
    """A switch of `switch_attr`'s, or IMTPU_PART_ATTN
    (`ops.window_attention._PART_ATTN`), at `value` inside the block and put
    back after it; nothing where `switch` is None."""
    if switch is None:
        yield
        return
    if switch == "IMTPU_PART_ATTN":
        from imagenet_models_tpu_torch.ops import window_attention as wa_ops

        module, attr = wa_ops, "_PART_ATTN"
    else:
        module, attr = switch_attr(switch)
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


def export_model(model, name: str, switch, value, batch: int, path: str) -> tuple:
    """The serving function of `model` (`name`) exported on the card at
    `batch` with `switch` at `value` (put back after), written to `path`
    with a sidecar that lists its ops. Returns (seconds to export, the
    program's imtpu ops)."""
    from imagenet_models_tpu_torch import default_cfg
    from imagenet_models_tpu_torch.ops.library import program_ops
    from imagenet_models_tpu_torch.serving import export_serving, write_artifact

    cfg = default_cfg(name)
    with switched(switch, value):
        t0 = time.perf_counter()
        exported = export_serving(model, batch, IMG, cfg["mean"], cfg["std"])
        seconds = time.perf_counter() - t0
    ops = program_ops(exported)
    write_artifact(exported, path, {"model": name, "batch_size": batch, "img_size": IMG,
                                    "switch": switch, "value": value, "ops": ops})
    return seconds, ops


def serving_export(card: str) -> dict:
    """Phase 32a-c: each of EXPORTS exported at B=8 on the card (each model
    built once, as the serving phases build it: bf16, seed SEED), its live
    serving function's logits and launches a call recorded on fixed uint8
    images; one child process (`--phase32`) loads every program with torch
    and the op library alone and holds each to its live function and
    launches, while map_convnext_tiny's and ga_cswin_tiny's programs are
    exported at B=256; those are then reloaded and timed against their
    live eager models in turns."""
    import tempfile

    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.serving import load_artifact, make_serving_fn

    counters = op_counters()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    images = torch.randint(0, 256, (EXPORT_BATCH, IMG, IMG, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    rows, models = [], {}
    timed = ("map_convnext_tiny", GA_CSWIN)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export-") as tmp:
        for i, (tag, name, switch, value, op, per_call) in enumerate(EXPORTS):
            if name not in models:
                models[name] = create_model(name, dtype=torch.bfloat16,
                                            generator=torch.Generator().manual_seed(SEED),
                                            **EXPORT_MODEL_KW.get(name, {}))
            model = models[name]
            path = str(Path(tmp) / f"{i}.pt2")
            seconds, ops = export_model(model, name, switch, value, EXPORT_BATCH, path)
            for c in counters.values():
                c.launches = 0
            cfg = default_cfg(name)
            with switched(switch, value):
                live = make_serving_fn(model, cfg["mean"], cfg["std"])(images)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            torch.save({"images": images.cpu(), "logits": live.cpu()}, path + ".ref")
            rows.append({"tag": tag, "model": name, "switch": switch, "value": value, "op": op,
                         "export_s": seconds, "ops": ops, "live_launches": launches})
            log(f"[export] {tag} {name}" + (f" ({switch}={value})" if switch else "")
                + f": exported at B={EXPORT_BATCH} in {seconds:.1f} s, ops {ops}; live "
                f"launches a call {({k: v for k, v in launches.items() if v})}")
            if ops != [f"imtpu::{op}"] or launches[op] != per_call:
                raise AssertionError(f"phase {tag}: {name} exported {ops} and launched {launches} "
                                     f"live, not imtpu::{op} {per_call} times")
        for name in set(models) - set(timed):
            del models[name]
        torch.cuda.empty_cache()

        # the loader runs while the programs to time are exported
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--phase32", tmp],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            bench_paths = {}
            for name in timed:
                bench_paths[name] = str(Path(tmp) / f"{name}-b{BENCH_BATCH}.pt2")
                export_model(models[name], name, None, None, BENCH_BATCH, bench_paths[name])
            out, err = child.communicate(timeout=900)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        if child.returncode != 0:
            raise AssertionError(f"phase 32's loader exited {child.returncode}:\n{out[-3000:]}\n"
                                 f"{err[-3000:]}")
        loaded = json.loads(out.strip().splitlines()[-1])
        log(f"[export] the loader (torch and the op library alone): {loaded['seconds']:.1f} s "
            f"in the child, {time.perf_counter() - t0:.1f} s with the B={BENCH_BATCH} exports "
            f"beside it; model code it imported: {loaded['model_code']}")
        if loaded["model_code"]:
            raise AssertionError(f"loading a program imported model code: {loaded['model_code']}")
        for row, got in zip(rows, loaded["programs"], strict=True):
            row.update(got)
            want = row["live_launches"]
            log(f"[export] {row['tag']} {row['model']} reloaded in {got['load_s']:.1f} s (first "
                f"call {got['first_call_s']:.1f} s): max|program - live| {got['max_abs_err']:.4g} "
                f"(tol {EXPORT_ATOL}; bit-equal {got['bit_equal']}), launches a call "
                f"{[{k: v for k, v in n.items() if v} for n in got['launches']]}")
            if not (got["finite"] and got["max_abs_err"] <= EXPORT_ATOL
                    and got["launches"] == [want, want]):
                raise AssertionError(f"phase {row['tag']}: the reloaded {row['model']} disagrees "
                                     f"with its live function: {got}")

        timing = {}
        for name in timed:
            program = load_artifact(bench_paths[name])[0].module()
            cfg = default_cfg(name)
            live = make_serving_fn(models[name], cfg["mean"], cfg["std"])
            x = torch.randint(0, 256, (BENCH_BATCH, IMG, IMG, 3), generator=gen, device="cuda",
                              dtype=torch.uint8)

            def exported(program=program, x=x):
                with torch.inference_mode():
                    program(x)
            t = in_turns({"eager": lambda: live(x), "exported": exported}, BENCH_ITERS,
                         order=("eager", "exported"))
            runs = {k: [BENCH_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
            timing[name] = {"img_s": {k: sum(v) / 2 for k, v in runs.items()}, "turns": runs}
            log(f"[throughput] {name} eval B={BENCH_BATCH} {IMG}px bf16: reloaded program "
                f"{timing[name]['img_s']['exported']:.1f} img/s, live eager model "
                f"{timing[name]['img_s']['eager']:.1f} (turns eager,exported,exported,eager: "
                + ",".join(f"{r:.1f}" for r in (runs["eager"][0], runs["exported"][0],
                                                runs["exported"][1], runs["eager"][1]))
                + f") on {card}")
            del program, live, exported, models[name]
            torch.cuda.empty_cache()
    return {"programs": rows, "loader_s": loaded["seconds"], "eval_b256": timing}


def phase32_child(directory: str) -> int:
    """Phase 32's loader: every `*.pt2` program in `directory` reloaded with
    torch and the op library alone (`serving.load_artifact`), run twice on
    its `.ref` images with each op's launches counted, its logits held to
    the `.ref` ones; one JSON line, with the model code that reached
    sys.modules (none is expected)."""
    import torch

    from imagenet_models_tpu_torch.serving import load_artifact

    started = time.perf_counter()
    counters = op_counters()
    programs = []
    for path in sorted(Path(directory).glob("[0-9]*.pt2"), key=lambda p: int(p.stem)):
        t0 = time.perf_counter()
        program, _ = load_artifact(str(path))
        ref = torch.load(str(path) + ".ref")
        run = program.module()
        images = ref["images"].cuda()
        load_s = time.perf_counter() - t0
        launches, calls_s = [], []
        for _ in range(2):
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits = run(images)
            torch.cuda.synchronize()
            calls_s.append(time.perf_counter() - t0)
            launches.append({k: c.launches for k, c in counters.items()})
        logits = logits.float().cpu()
        programs.append({"max_abs_err": (logits - ref["logits"]).abs().max().item(),
                         "bit_equal": torch.equal(logits, ref["logits"]),
                         "finite": bool(torch.isfinite(logits).all()), "launches": launches,
                         "load_s": load_s, "first_call_s": calls_s[0]})
        del program, run
    model_code = sorted(m for m in sys.modules if m.startswith(MODEL_CODE))
    print(json.dumps({"programs": programs, "model_code": model_code,
                      "seconds": time.perf_counter() - started}))
    return 0


def set_gelu(value: str) -> None:
    """IMTPU_GELU and IMTPU_XLA_GELU both at `value`, through the attributes
    they are read into (`ops.convnext_block._GELU_ENV`,
    `nn.layers._XLA_GELU_ENV`)."""
    from imagenet_models_tpu_torch.nn import layers
    from imagenet_models_tpu_torch.ops import convnext_block as cb

    cb._GELU_ENV = layers._XLA_GELU_ENV = value


def exact_gelu_train(card: str) -> dict:
    """Phase 32d: map_convnext_tiny's train step at B=128 with IMTPU_GELU and
    IMTPU_XLA_GELU at "exact": one kernel-path step (18 launches each of
    kernels 1 and 2, every one on its exact instance) against one plain-path
    step from a deep copy of the state, by phase 7's gates (loss and grad
    norm, the gradient groups against each other and against an fp32
    model's at "exact" too); then train img/s at "exact" and at the default
    (the fast fit) on the kernel path, in GELU_TURNS's turns, and the device
    time a step of both (torch.profiler)."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.train.state import make_train_step

    n_blocks = sum(STAGE_DEPTHS)
    state, opt, loss_fn = make_trainer()
    plain_state = copy.deepcopy(state)
    kernel_opt, plain_opt = FirstGrads(opt), FirstGrads(opt)
    step = make_train_step(state.model, kernel_opt, loss_fn, dec_lam=-0.8, ema_decay=0.9999)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, dec_lam=-0.8,
                                 ema_decay=0.9999, use_kernel=False)
    images, targets = train_batch()
    gen = torch.Generator(device="cuda")
    impls = {"fwd": [], "bwd": []}
    inits = cb._Fwd.__init__, cb._Bwd.__init__

    def fwd_init(self, *a, _init=inits[0]):
        impls["fwd"].append(a[-1])
        _init(self, *a)

    def bwd_init(self, *a, _init=inits[1]):
        impls["bwd"].append(a[-1])
        _init(self, *a)

    set_gelu("exact")
    try:
        cb._Fwd.__init__, cb._Bwd.__init__ = fwd_init, bwd_init
        cb.fused_ln_mlp.launches = cb.fused_ln_mlp_bwd.launches = 0
        torch.manual_seed(SEED + 10)
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10))
        torch.cuda.synchronize()
        cb._Fwd.__init__, cb._Bwd.__init__ = inits
        launches = {"fwd": cb.fused_ln_mlp.launches, "bwd": cb.fused_ln_mlp_bwd.launches}
        log(f"[exact-gelu-train] one kernel-path step at B={TRAIN_BATCH}: launches {launches}, "
            f"GELU of kernel 1's calls {sorted(set(impls['fwd']))}, of kernel 2's "
            f"{sorted(set(impls['bwd']))}")
        if (launches != {"fwd": n_blocks, "bwd": n_blocks}
                or set(impls["fwd"]) != {"exact"} or set(impls["bwd"]) != {"exact"}):
            raise AssertionError(f"phase 32d: expected {n_blocks} launches of kernels 1 and 2 "
                                 f"on their exact instances, got {launches}, {impls}")
        m = {k: v.item() for k, v in m.items()}
        torch.manual_seed(SEED + 10)
        plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
        pm = {k: v.item() for k, v in pm.items()}
        loss_rel = abs(m["loss"] - pm["loss"]) / abs(pm["loss"])
        gnorm_rel = abs(m["grad_norm"] - pm["grad_norm"]) / abs(pm["grad_norm"])
        log(f"[exact-gelu-train] first step, kernel vs plain path: loss {m['loss']:.6f} vs "
            f"{pm['loss']:.6f} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}); grad_norm "
            f"{m['grad_norm']:.6f} vs {pm['grad_norm']:.6f} (rel {gnorm_rel:.3g}, tol "
            f"{TRAIN_GNORM_RTOL})")
        if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL):
            raise AssertionError("phase 32d: the exact-GELU kernel step disagrees with the plain "
                                 "path")
        grads = compare_grads(kernel_opt.grads, plain_opt.grads,
                              fp32_grads(loss_fn, images, targets), tag="exact-gelu-")
        kernel_opt.grads = plain_opt.grads = {}
        del plain_state, plain_step
        torch.cuda.empty_cache()

        def arm(value):
            def run():
                set_gelu(value)
                step(state, images, targets, gen)
            return run
        fns = {"exact": arm("exact"), "fast": arm("")}
        for fn in fns.values():
            for _ in range(GELU_TURNS["warmup"]):
                fn()
        t, sequence = {"fast": [], "exact": []}, []
        for _ in range(GELU_TURNS["rounds"]):
            for k in ("fast", "exact", "exact", "fast"):
                t[k].append(cuda_ms(fns[k], GELU_TURNS["iters"]))
                sequence.append(TRAIN_BATCH * 1000.0 / t[k][-1])
        device = {k: sum(device_ms_by_kernel(fns[k], calls=2).values()) for k in ("fast", "exact")}
    finally:
        cb._Fwd.__init__, cb._Bwd.__init__ = inits
        set_gelu("")
    runs = {k: [TRAIN_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    img_s = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[train-throughput] map_convnext_tiny (LAMB, EMA) train B={TRAIN_BATCH} {IMG}px bf16 "
        f"on the kernel path: IMTPU_GELU/IMTPU_XLA_GELU exact {img_s['exact']:.1f} img/s, "
        f"default (fast) {img_s['fast']:.1f} ({GELU_TURNS['iters']} steps a turn; turns "
        f"fast,exact,exact,fast x{GELU_TURNS['rounds']}: "
        + ",".join(f"{r:.1f}" for r in sequence) + f"); device time a step (profiler) exact "
        f"{device['exact']:.3f} ms, fast {device['fast']:.3f} on {card}")
    return {"launches": launches, "loss": m["loss"], "plain_loss": pm["loss"],
            "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel, "grads_rel": grads,
            "train_img_s": img_s, "train_img_s_turns": runs, "device_ms": device}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2
    from imagenet_models_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    laps = {}

    def lap(phases: str) -> None:
        """Logs the seconds since the previous lap under `phases`."""
        now = time.perf_counter()
        laps[phases] = now - started - sum(laps.values())
        log(f"[time] phases {phases}: {laps[phases]:.1f} s")

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    builds = _kernels.build_all()
    for name in _kernels.KERNELS:
        getattr(_kernels, f"{name}_library")()
    log(f"[build] {', '.join(f'{n}.cu -> {b.path.name} in {b.seconds:.1f} s' for n, b in builds.items())}"
        f"; {time.perf_counter() - t0:.1f} s in all, in parallel")
    for name, b in builds.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")
    lap("1-2")

    # map_convnext_tiny: kernels 1 and 2, serving and the train step
    fwd_rows, fwd_times = check_forward("exact", (64, BENCH_BATCH))
    fast_rows, fast_times = check_forward("fast", (64, TRAIN_BATCH))
    fwd_code = check_forward_code(builds["ln_mlp_fwd"])
    bwd_rows, bwd_times = check_backward()
    pit_rows, pit_times, pit_per = check_pit_widths(card)
    lap("3")
    model, serve_launches, logits_check = serve()
    bench, runs = throughput(model, card)
    del model
    kernel, plain, images, targets, train_launches, train_check = train()
    train_bench, train_runs = train_throughput(kernel, plain, images, targets, card,
                                               "map_convnext_tiny (LAMB, EMA)")
    del plain
    prof = profile_step(kernel, images, targets, "map_convnext_tiny")
    del kernel, images, targets
    torch.cuda.empty_cache()
    lap("4-7")

    # map_maxvit_tiny_tf_224: kernels 3 and 4, serving and the train step
    attn_rows, attn_times, attn_evals, attn_extra = check_attention(card, builds)
    mv_serve = serve_maxvit(card)
    torch.cuda.empty_cache()
    mv_kernel, mv_plain, images, targets, mv_launches, mv_check = train_maxvit(steps=OPT_IN_STEPS)
    mv_bench, mv_runs = train_throughput(mv_kernel, mv_plain, images, targets, card,
                                         f"{MAXVIT} (LAMB, clip 1.0, drop-path 0.2)")
    del mv_plain
    mv_prof = profile_step(mv_kernel, images, targets, MAXVIT)
    mv_batch = (images, targets)  # phase 17 times MaxViT with the BatchNorm switch on
    del images, targets
    torch.cuda.empty_cache()
    lap("8-10")

    # ga_cswin_tiny: kernels 5 and 6, serving and the train step
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    stripe_rows, stripe_times, stripe_gate = check_stripe(card)
    stripe_code = check_stripe_code(builds)
    cs_serve_launches, cs_serve = serve_branches(
        card, GA_CSWIN, (sa.fused_stripe_attention, sa.fused_stripe_attention_bwd),
        CSWIN_LAUNCHES, "cswin-")
    cs_kernel, cs_plain, images, targets, cs_launches, cs_check = train_cswin()
    cs_bench, cs_runs = train_throughput(cs_kernel, cs_plain, images, targets, card,
                                         f"{GA_CSWIN} (LAMB, EMA)")
    del cs_plain
    cs_prof = profile_step(cs_kernel, images, targets, GA_CSWIN)
    cs_prof["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del cs_kernel, images, targets
    torch.cuda.empty_cache()
    lap("11-13")

    # map_resnet50 and map_mobilenet_v1: kernels 7 and 8, with the switch at "full"
    from imagenet_models_tpu_torch.ops import batch_norm as bn_ops

    bn_census_b128, bn_rows, bn_times, bn_totals = check_bn(card)
    bn_ops._PALLAS_BN_MODE = "full"
    rn_serve = serve_bn(RESNET, card, "resnet")
    rn_kernel, rn_plain, images, targets, rn_launches, rn_check = train_bn(
        RESNET, RESNET_RECIPE, TRAIN_STEPS, IMG, "resnet", **RESNET_DROPS)
    rn_arms = switch_arms("IMTPU_PALLAS_BN", rn_kernel, rn_plain, images, targets, card,
                      f"{RESNET} (LAMB, drop-path 0.1, drop 0.1)", BN_ARMS)
    del rn_plain
    rn_prof = profile_step(rn_kernel, images, targets, f"{RESNET} (switch 'full')")
    rn_prof["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del rn_kernel, images, targets
    torch.cuda.empty_cache()
    mb_serve = serve_bn(MOBILENET, card, "mobilenet")
    mb_kernel, mb_plain, images, targets, mb_launches, mb_check = train_bn(
        MOBILENET, MOBILENET_RECIPE, 1, MOBILENET_IMG, "mobilenet")
    del mb_kernel, mb_plain, images, targets
    torch.cuda.empty_cache()
    mv_arms = switch_arms("IMTPU_PALLAS_BN", mv_kernel, None, *mv_batch, card,
                          f"{MAXVIT} (LAMB, clip 1.0, drop-path 0.2)",
                      (("full", "kernel"), ("0", "kernel")))
    bn_ops._PALLAS_BN_MODE = "0"
    del mv_kernel, mv_batch
    torch.cuda.empty_cache()
    lap("14-17")

    # ga_convnext_tiny: kernels 1 and 2 in 23 blocks, kernel 9 with IMTPU_DW_WGRAD at "1"
    from imagenet_models_tpu_torch.ops import dw_conv as dw_ops
    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd

    dw_rows, dw_times, dw_totals = check_dw(card, builds["dw7_wgrad"])
    ga_serve_launches, ga_serve = serve_branches(
        card, GA_CONVNEXT, (fused_ln_mlp, fused_ln_mlp_bwd, dw_ops.fused_dw7_wgrad),
        GA_LAUNCHES, "ga-", ls_init_value=1.0)
    ga_kernel, ga_plain, images, targets, ga_launches, ga_check = train_ga()
    ga_arms = switch_arms("IMTPU_DW_WGRAD", ga_kernel, ga_plain, images, targets, card,
                          f"{GA_CONVNEXT} (LAMB, drop-path 0.1, EMA)", DW_ARMS)
    del ga_plain
    ga_prof = profile_step(ga_kernel, images, targets, f"{GA_CONVNEXT} (IMTPU_DW_WGRAD '1')")
    ga_prof["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del ga_kernel, images, targets
    torch.cuda.empty_cache()
    cx_dw_arms = convnext_dw_arms(card)
    dw_ops._DW_WGRAD = "0"
    lap("18-20")

    # the opt-in routes: kernels 12 and 13 with IMTPU_FLASH_ATTN at "1", and
    # kernels 1 and 2 on the transformers' MLPs with IMTPU_TLNMLP at "1"
    from imagenet_models_tpu_torch.ops import convnext_block as cb_ops
    from imagenet_models_tpu_torch.ops import flash_attention as fa_ops

    flash_rows, flash_times, flash_extra = check_flash(card, builds)
    fa_ops._FLASH_ATTN = "1"
    mv_flash = flash_maxvit(card)
    cs_flash = flash_cswin(card)
    fa_ops._FLASH_ATTN = "0"
    cb_ops._TLNMLP = "1"
    tlnmlp = tlnmlp_arms(card)
    cb_ops._TLNMLP = "0"
    lap("21-24")

    # the fused ConvNeXt branch: kernels 10 and 11 on map_convnext_tiny's 18
    # blocks through convnext_branch_apply, phase 25
    branch_rows, branch_times_b128, branch_totals = check_branch(card)
    branch_code = check_branch_code(builds)
    branch = branch_path(card)
    lap("25")

    # phase 26: fp32 models of the families of kernels 1-6 under the default
    # dispatch, and the trace of the fp32 step's run-to-run difference
    fp32 = fp32_dispatch(card)
    fp32["trace"] = det_trace(card)
    lap("26")

    # phase 27: the train and validate entries on map_convnext_tiny
    entry_checks = train_entry(card, train_bench["kernel"])
    lap("27")

    # phase 28: data parallelism in child processes (NCCL at world 1, gloo at 2)
    dp = data_parallel(card)
    lap("28")

    # phase 29: map_pit_s with kernels 1 and 2 on its blocks' MLPs, and the heads
    pit = pit_path(card)
    lap("29")

    # phase 30: map_faster_vit_3_224 with kernels 7 and 8 on its training BatchNorms
    fastervit = fastervit_path(card)
    lap("30")

    # phase 31: fine-tuning maxvit_tiny_tf_384 from a 224 px checkpoint,
    # gradient checkpointing, and the IMTPU_PART_ATTN / IMTPU_STRIPE_MAXH arms
    finetune = finetune_path(card, stripe_rows)
    lap("31")

    # phase 32: the serving export through the forward kernels' custom ops,
    # and the exact-GELU train step
    export = serving_export(card)
    export["exact_gelu"] = exact_gelu_train(card)
    lap("32")

    def entry(name, source, replaces, launches, errs, times, weights):
        return {"name": name, "route": "cuda",
                "source": f"imagenet_models_tpu_torch/csrc/{source}",
                "replaces": f"imagenet_models_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": max(errs),
                # one forward's or train step's launches, weighted over the stages
                "ms": weighted(times, "ms", weights),
                "plain_ms": weighted(times, "plain_ms", weights),
                "bound_ms": weighted(times, "bound_ms", weights),
                "bound_by": "operations" if all(t["bound_by"] == "operations" for t in times)
                else "bytes",
                "library_ms": (weighted(times, "library_ms", weights)
                               if all(t.get("library_ms") is not None for t in times) else None)}

    errs = lambda rows: [r["max_abs_err"] for r in rows]
    attn_errs = {"fwd": [r["max_abs_err"]["out"] for r in attn_rows],
                 "bwd": [max(r["max_abs_err"]["dqkv"], r["max_abs_err"]["dbias"])
                         for r in attn_rows]}
    kernels = [
        # per map_convnext_tiny forward at B=64 and at B=256 (the eval batch),
        # exact GELU, and per train step's forward at B=128 (fast GELU)
        entry("ln_mlp_fwd", "ln_mlp_fwd.cu", "convnext_block.py:341", serve_launches,
              errs(r for r in fwd_rows if r["gelu"] == "exact"), fwd_times[64], STAGE_DEPTHS),
        entry("ln_mlp_fwd_b256", "ln_mlp_fwd.cu", "convnext_block.py:341", serve_launches,
              errs(r for r in fwd_rows if r["gelu"] == "exact"), fwd_times[BENCH_BATCH],
              STAGE_DEPTHS),
        entry("ln_mlp_fwd_fast", "ln_mlp_fwd.cu", "convnext_block.py:341", train_launches["fwd"],
              errs(r for r in fast_rows if r["gelu"] == "fast"), fast_times[TRAIN_BATCH],
              STAGE_DEPTHS),
        entry("ln_mlp_bwd", "ln_mlp_bwd.cu", "convnext_block.py:474", train_launches["bwd"],
              errs(bwd_rows), bwd_times, STAGE_DEPTHS),
        entry("partition_attn_fwd", "partition_attn_fwd.cu", "partition_attention.py:286",
              mv_launches["fused_partition_attention"], attn_errs["fwd"], attn_times["fwd"],
              MAXVIT_STAGE_LAUNCHES),
        entry("partition_attn_bwd", "partition_attn_bwd.cu", "partition_attention.py:310",
              mv_launches["fused_partition_attention_bwd"], attn_errs["bwd"], attn_times["bwd"],
              MAXVIT_STAGE_LAUNCHES),
        entry("stripe_attn_fwd", "stripe_attn_fwd.cu", "stripe_attention.py:264",
              cs_launches["fused_stripe_attention"],
              [r["max_abs_err"]["out"] for r in stripe_rows], stripe_times["fwd"],
              CSWIN_PATH_LAUNCHES),
        entry("stripe_attn_bwd", "stripe_attn_bwd.cu", "stripe_attention.py:284",
              cs_launches["fused_stripe_attention_bwd"],
              [max(r["max_abs_err"][k] for k in STRIPE_OUTPUTS[1:]) for r in stripe_rows],
              stripe_times["bwd"], CSWIN_PATH_LAUNCHES),
        entry("bn_moments", "bn_moments.cu", "batch_norm.py:115", rn_launches["fwd"],
              [r["moments"]["max_abs_err"] for r in bn_rows], bn_times["fwd"],
              [r["count"] for r in bn_times["fwd"]]),
        entry("bn_dot_sums", "bn_dot_sums.cu", "batch_norm.py:133", rn_launches["bwd"],
              [r["dot_sums"]["max_abs_err"] for r in bn_rows], bn_times["bwd"],
              [r["count"] for r in bn_times["bwd"]]),
        entry("dw7_wgrad", "dw7_wgrad.cu", "dw_conv.py:72", ga_launches["dw_wgrad"],
              errs(dw_rows), dw_times, DW_PATH_LAUNCHES),
        # kernel 12 per ga_cswin_tiny forward at B=128, kernel 13 per
        # map_maxvit_tiny_tf_224 eval forward at B=256; launches over phases
        # 23 and 22 (serving, training and the switch arms)
        entry("window_attn_fwd", "window_attn_fwd.cu", "flash_attention.py:64",
              cs_flash["launches"], [r["max_abs_err"] for r in flash_rows if r["kernel"] == "12"],
              flash_times["12"], CSWIN_FLASH_WEIGHTS),
        entry("window_attn_heads_fwd", "window_attn_heads_fwd.cu", "flash_attention.py:134",
              mv_flash["launches"], [r["max_abs_err"] for r in flash_rows if r["kernel"] == "13"],
              flash_times["13"], MAXVIT_FLASH_WEIGHTS),
        # per map_convnext_tiny forward (kernel 10) and train step's backward
        # (kernel 11) at B=128; launches over phase 25(c)
        entry("convnext_branch_fwd", "convnext_branch_fwd.cu", "convnext_branch.py:213",
              branch["launches"]["fwd"], [r["max_abs_err"]["fwd"] for r in branch_rows],
              branch_times_b128["fwd"], STAGE_DEPTHS),
        entry("convnext_branch_bwd", "convnext_branch_bwd.cu", "convnext_branch.py:242",
              branch["launches"]["bwd"], [r["max_abs_err"]["bwd"] for r in branch_rows],
              branch_times_b128["bwd"], STAGE_DEPTHS),
        # per map_pit_s eval forward at B=256 (exact GELU), train step's
        # forward and backward at B=128 (fast); launches over phase 29
        entry("ln_mlp_fwd_pit_b256", "ln_mlp_fwd.cu", "convnext_block.py:341",
              pit["launches"]["fwd"],
              errs(r for r in pit_rows if r["kernel"] == 1 and r["gelu"] == "exact"),
              pit_times["fwd_b256"], PIT_DEPTHS),
        entry("ln_mlp_fwd_fast_pit", "ln_mlp_fwd.cu", "convnext_block.py:341",
              pit["launches"]["fwd"],
              errs(r for r in pit_rows if r["kernel"] == 1 and r["gelu"] == "fast"),
              pit_times["fwd_b128"], PIT_DEPTHS),
        entry("ln_mlp_bwd_pit", "ln_mlp_bwd.cu", "convnext_block.py:474", pit["launches"]["bwd"],
              errs(r for r in pit_rows if r["kernel"] == 2), pit_times["bwd_b128"], PIT_DEPTHS),
        # per map_faster_vit_3_224 train step at B=128; launches over phase 30's steps
        entry("bn_moments_fastervit", "bn_moments.cu", "batch_norm.py:115",
              fastervit["launches"]["fwd"],
              [r["moments"]["max_abs_err"] for r in fastervit["checks"]],
              fastervit["times"]["fwd"], [r["count"] for r in fastervit["times"]["fwd"]]),
        entry("bn_dot_sums_fastervit", "bn_dot_sums.cu", "batch_norm.py:133",
              fastervit["launches"]["bwd"],
              [r["dot_sums"]["max_abs_err"] for r in fastervit["checks"]],
              fastervit["times"]["bwd"], [r["count"] for r in fastervit["times"]["bwd"]]),
        # phase 31: kernels 3 and 4 at T = 144 per maxvit_tiny_tf_384 train
        # step at B=32, launches over 31a's two steps (18 + 36 and 18 + 18);
        # kernel 3 per map_maxvit_tiny_tf_224 eval forward at B=256 with
        # IMTPU_PART_ATTN "all" (31c's counted forward); kernels 5 and 6 on
        # the stripes past 16 rows (ga_cswin_tiny's stages 1 and 2, B=128)
        # with IMTPU_STRIPE_MAXH 56, per forward and step, launches those of
        # 31d's counted forward and step at 56 less the same runs at 16
        entry("partition_attn_fwd_384", "partition_attn_fwd.cu", "partition_attention.py:286",
              finetune["checkpointing"]["launches"]["fwd"],
              [r["max_abs_err"]["out"] for r in finetune["checks_384"]],
              finetune["times_384"]["fwd"], MAXVIT_STAGE_LAUNCHES),
        entry("partition_attn_bwd_384", "partition_attn_bwd.cu", "partition_attention.py:310",
              finetune["checkpointing"]["launches"]["bwd"],
              [max(r["max_abs_err"]["dqkv"], r["max_abs_err"]["dbias"])
               for r in finetune["checks_384"]],
              finetune["times_384"]["bwd"], MAXVIT_STAGE_LAUNCHES),
        entry("partition_attn_fwd_eval", "partition_attn_fwd.cu", "partition_attention.py:286",
              finetune["part_attn_all"]["launches"]["all"],
              finetune["part_attn_all"]["kernel_errs"], finetune["part_attn_all"]["times"],
              MAXVIT_STAGE_LAUNCHES),
        entry("stripe_attn_fwd_maxh56", "stripe_attn_fwd.cu", "stripe_attention.py:264",
              finetune["stripe_maxh"]["launches"]["fwd"], finetune["stripe_maxh"]["errs"]["fwd"],
              finetune["stripe_maxh"]["times"]["fwd"], WIDE_LAUNCHES),
        entry("stripe_attn_bwd_maxh56", "stripe_attn_bwd.cu", "stripe_attention.py:284",
              finetune["stripe_maxh"]["launches"]["bwd"], finetune["stripe_maxh"]["errs"]["bwd"],
              finetune["stripe_maxh"]["times"]["bwd"], WIDE_LAUNCHES),
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel of the paths was never launched: "
                             f"{[k['name'] for k in kernels if not k['launches']]}")
    # every module of the port, the weights converter included, imports
    # nothing of JAX or of the JAX package
    import imagenet_models_tpu_torch

    for mod in pkgutil.walk_packages(imagenet_models_tpu_torch.__path__, "imagenet_models_tpu_torch."):
        importlib.import_module(mod.name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "imagenet_models_tpu"))
    if leaked or "imagenet_models_tpu_torch.ckpt.convert" not in sys.modules:
        raise AssertionError(f"the port imported JAX-side modules: {leaked[:5]}")

    seconds = time.perf_counter() - started
    log(f"[time] every phase, the build included, in {seconds:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "seconds": seconds, "seconds_by_phases": laps,
        "device": kind, "card": card, "torch": torch.__version__,
        "build_seconds": {n: b.seconds for n, b in builds.items()},
        "forward_checks": fwd_rows, "forward_times": fwd_times,
        "forward_fast_checks": fast_rows, "forward_fast_times": fast_times,
        "forward_code": fwd_code,
        "backward_checks": bwd_rows, "backward_times_b128": bwd_times,
        "serving": logits_check, "serving_launches": serve_launches,
        "eval_img_s": bench, "eval_img_s_turns": runs,
        "train": train_check, "train_launches": train_launches,
        "train_img_s": train_bench, "train_img_s_turns": train_runs,
        "train_profile": prof,
        "maxvit": {"attention_checks": attn_rows, "attention_times_b128": attn_times,
                   "attention_eval_b256": attn_evals, **attn_extra, "serving": mv_serve,
                   "train": mv_check, "train_launches": mv_launches,
                   "train_img_s": mv_bench, "train_img_s_turns": mv_runs,
                   "train_profile": mv_prof},
        "ga_cswin": {"stripe_checks": stripe_rows, "stripe_times_b128": stripe_times,
                     "stripe_code": stripe_code,
                     "gate_b128": stripe_gate, "serving": cs_serve,
                     "serving_launches": cs_serve_launches, "train": cs_check,
                     "train_launches": cs_launches, "train_img_s": cs_bench,
                     "train_img_s_turns": cs_runs, "train_profile": cs_prof},
        "batch_norm": {"census_b128": {f"{s} {d}": n for (s, d), n in bn_census_b128.items()},
                       "checks": bn_rows, "times_b128": bn_times, "per_step_ms": bn_totals,
                       "resnet": {"serving": rn_serve, "train": rn_check,
                                  "train_launches": rn_launches, "train_arms": rn_arms,
                                  "train_profile": rn_prof},
                       "mobilenet": {"serving": mb_serve, "train": mb_check,
                                     "train_launches": mb_launches},
                       "maxvit_arms": mv_arms},
        "ga_convnext": {"dw_checks": dw_rows, "dw_times_b128": dw_times,
                        "dw_per_step_ms": dw_totals, "serving": ga_serve,
                        "serving_launches": ga_serve_launches, "train": ga_check,
                        "train_launches": ga_launches, "train_arms": ga_arms,
                        "train_profile": ga_prof, "map_convnext_tiny_arms": cx_dw_arms},
        "flash": {"checks": flash_rows, "times": flash_times, "maxvit": mv_flash,
                  "ga_cswin": cs_flash, **flash_extra},
        "tlnmlp": tlnmlp,
        "convnext_branch": {"checks": branch_rows, "times_b128": branch_times_b128,
                            "per_forward_and_step_ms": branch_totals,
                            "code": branch_code["summary"], **branch},
        "fp32_dispatch": fp32,
        "train_entry": entry_checks,
        "data_parallel": dp,
        "pit": {"kernel_checks": pit_rows, "kernel_times": pit_times, "per_forward_or_step_ms":
                pit_per, **pit},
        "fastervit": fastervit,
        "finetune": finetune,
        "serving_export": export,
        "kernels": kernels}, indent=2))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase32"]:  # phase 32's loader of the exported programs
        sys.exit(phase32_child(sys.argv[2]))
    if sys.argv[1:2] == ["--phase28"]:  # a child process of phase 28
        sys.exit(phase28_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase26"]:  # the child process of phase 26's trace
        det_child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
