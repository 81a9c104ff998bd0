"""Every bf16 kernel whose launcher keeps its launch state per device
(`imt_mma::LaunchCache`, csrc/mma_sync.cuh) launched on every visible card in
turn, in one process: kernels 4, 5, 6, 12 and 13, and the fused ConvNeXt
branch's 10 and 11.

A kernel that asks for more than 48 KB of dynamic shared memory must raise
its limit on each device, since the limit is an attribute of the kernel on
a device; a launcher that raised it once per process would fail on the
second card. Each case here asks for more than 48 KB. On every card the
kernel's outputs lie within 1e-2 of the largest |value| of its twin's on
that card (chip_smoke.py's KERNEL_RTOL) and are the bits of the first
card's: the same inputs, and every sum in a fixed order.

These tests need two or more NVIDIA GPUs and skip otherwise: on the CPU, and
on a machine with one card.
"""

import numpy as np
import pytest
import torch


def _devices():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs: the kernels run on each card in turn")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _draw(seed, *shapes, scale=0.3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)) for s in shapes]


def _partition(dev):
    from imagenet_models_tpu_torch.ops import partition_attention as pa

    b, h, w, nh, ps = 2, 28, 28, 4, (7, 7)
    c, t = 32 * nh, ps[0] * ps[1]
    qkv, bias, g = _draw(4, (b, h, w, 3 * c), (nh, t, t), (b, h, w, c))
    qkv, bias, g = qkv.bfloat16().to(dev), bias.to(dev), g.bfloat16().to(dev)
    got = pa.fused_partition_attention_bwd(qkv, bias, g, "block", ps, nh)
    return got, pa.plain_partition_attention_bwd(qkv, bias, g, "block", ps, nh)


def _stripe(dev, backward: bool):
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    b, h, w, cb, nh, ws = 2, 14, 14, 128, 4, 7
    q, k, v, w9, wb, g = _draw(5, *[(b, h, w, cb)] * 3, (9, cb), (1, cb), (b, h, w, cb))
    q, k, v, g = (t.bfloat16().to(dev) for t in (q, k, v, g))
    w9, wb = w9.to(dev), wb.to(dev)
    scale = (cb // nh) ** -0.5
    if backward:
        return (sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale),
                sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=ws, nh=nh, scale=scale))
    return ((sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale),),
            (sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale),))


def _window(dev, heads: bool):
    from imagenet_models_tpu_torch.ops import flash_attention as fa

    shape, bshape = ((3, 4, 144, 32), (4, 144, 144)) if heads else ((3, 256, 128), (3, 256, 256))
    q, k, v, bias = _draw(6, shape, shape, shape, bshape)
    q, k, v = (t.bfloat16().to(dev) for t in (q, k, v))
    bias = bias.to(dev)
    if heads:
        return ((fa.fused_window_attention_heads(q, k, v, bias),),
                (fa.plain_fused_window_attention_heads(q, k, v, bias),))
    return (fa.fused_window_attention(q, k, v, bias),), (fa.plain_fused_window_attention(q, k, v,
                                                                                      bias),)


def _branch(dev, backward: bool):
    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    b, h, w, c = 2, 14, 14, 192
    x, g, dww, dwb, lns, lnb, w1, b1, w2, b2, gm = _draw(
        7, (b, h, w, c), (b, h, w, c), (c, 1, 7, 7), (c,), (c,), (c,), (4 * c, c), (4 * c,),
        (c, 4 * c), (c,), (c,))
    x, g = x.bfloat16().to(dev), g.bfloat16().to(dev)
    params = [t.to(dev) for t in (dww, dwb, 1.0 + lns, lnb, w1 * c ** -0.5, b1,
                                  w2 * (4 * c) ** -0.5, b2, gm)]
    if backward:
        return (cbr.fused_convnext_branch_bwd(x, g, *params),
                cbr.plain_convnext_branch_bwd(x, g, *params))
    return (cbr.fused_convnext_branch(x, *params),), (cbr.plain_convnext_branch(x, *params),)


CASES = {"4": _partition, "5": lambda d: _stripe(d, False), "6": lambda d: _stripe(d, True),
         "12": lambda d: _window(d, False), "13": lambda d: _window(d, True),
         "10": lambda d: _branch(d, False), "11": lambda d: _branch(d, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(CASES))
def test_bf16_kernel_runs_on_every_card(kernel):
    first = None
    for dev in _devices():
        with torch.no_grad():
            got, ref = CASES[kernel](dev)
        torch.cuda.synchronize(dev)
        for o, r in zip(got, ref):
            assert o.device == dev and o.shape == r.shape and o.dtype == r.dtype
            err = (o.float() - r.float()).abs().max().item()
            assert err <= 1e-2 * r.float().abs().max().item(), (kernel, dev, err)
        outs = [o.cpu() for o in got]
        if first is None:
            first = outs
        else:
            assert all(torch.equal(a, b) for a, b in zip(first, outs)), (kernel, dev)
