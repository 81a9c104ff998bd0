"""The dispatch rule of kernels 1-6 for fp32 models.

`ln_mlp`, `partition_attention` and `stripe_attention` send every CUDA tensor
to their CUDA kernels, bf16 and fp32 alike (each kernel has an fp32 instance,
as the TPU kernels take fp32 operands), and any CPU tensor to the plain twin.
The kernels' wrappers raise TypeError on any other dtype: a tensor on the
card never takes the twin by default.

There is no card here, so the CUDA tensors are CPU tensors of a subclass that
reports `is_cuda`: the dispatchers read only the device and the dtype, and the
kernels' entry points are replaced by recorders.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import convnext_block as cb
from imagenet_models_tpu_torch.ops import partition_attention as pa
from imagenet_models_tpu_torch.ops import stripe_attention as sa


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device."""

    @property
    def is_cuda(self):
        return True


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))


def _ln_mlp_case(rng):
    c, hid = 32, 128
    args = (_rand(rng, 20, c), _rand(rng, c, scale=0.1, shift=1.0), _rand(rng, c, scale=0.1),
            _rand(rng, hid, c, scale=c ** -0.5), _rand(rng, hid, scale=0.1),
            _rand(rng, c, hid, scale=hid ** -0.5), _rand(rng, c, scale=0.1), _rand(rng, c))
    return args[:1], args[1:], {}


def _partition_case(rng):
    return ((_rand(rng, 1, 4, 4, 24),), (_rand(rng, 2, 4, 4),),
            dict(part_type="block", ps=(2, 2), num_heads=2))


def _stripe_case(rng):
    return ((_rand(rng, 1, 4, 4, 8), _rand(rng, 1, 4, 4, 8), _rand(rng, 1, 4, 4, 8)),
            (_rand(rng, 9, 8, scale=0.3), _rand(rng, 1, 8, scale=0.1)),
            dict(ws=2, num_heads=2, scale=0.5))


# (dispatcher, the autograd function it launches the kernels through, the
# forward kernel's wrapper and how it is called, the inputs)
CASES = {
    "ln_mlp": (cb.ln_mlp, cb.LnMlpFunction, lambda t, rest, kw: cb.fused_ln_mlp(*t, *rest),
               _ln_mlp_case),
    "partition_attention": (pa.partition_attention, pa.PartitionAttentionFunction,
                            lambda t, rest, kw: pa.fused_partition_attention(
                                *t, *rest, kw["part_type"], kw["ps"], kw["num_heads"]),
                            _partition_case),
    "stripe_attention": (sa.stripe_attention, sa.StripeAttentionFunction,
                         lambda t, rest, kw: sa.fused_stripe_attention(
                             *t, *rest, kw["ws"], kw["num_heads"], kw["scale"]),
                         _stripe_case),
}


@pytest.mark.parametrize("name", list(CASES))
def test_default_route_follows_device(name, monkeypatch):
    dispatch, function, _, case = CASES[name]
    tokens, rest, kw = case(np.random.default_rng(7))
    calls = []
    # the recorder returns its first operand, which the dispatcher may reshape
    monkeypatch.setattr(function, "apply", staticmethod(lambda *a: calls.append(a) or a[0]))

    # a CPU tensor takes the twin in any dtype
    for dtype in (torch.float32, torch.bfloat16):
        cpu = [t.to(dtype) for t in tokens]
        got = dispatch(*cpu, *rest, **kw)
        assert not calls
        assert torch.equal(got, dispatch(*cpu, *rest, **kw, use_kernel=False))

    # a CUDA tensor goes to the kernels, once, in its own dtype: an fp32 model
    # on the card runs the kernels' fp32 instances
    for dtype in (torch.float32, torch.bfloat16):
        dispatch(*[t.to(dtype).as_subclass(_CudaLooking) for t in tokens], *rest, **kw)
        assert len(calls) == 1 and calls[0][0].dtype == dtype
        calls.clear()


@pytest.mark.parametrize("name", list(CASES))
def test_kernels_refuse_other_dtypes(name):
    """An fp16 CUDA tensor is not taken by the twin either: the default route
    and the kernel's wrapper both raise, before any library is built."""
    dispatch, _, fused, case = CASES[name]
    tokens, rest, kw = case(np.random.default_rng(8))
    looking = [t.half().as_subclass(_CudaLooking) for t in tokens]
    with pytest.raises(TypeError, match="bf16 or fp32"):
        dispatch(*looking, *rest, **kw)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fused(looking, rest, kw)
