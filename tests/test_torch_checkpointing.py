"""Steps that repeat bit for bit. Gradient checkpointing in the port's
training forward: MaxViT's
`grad_checkpointing` and GA-CSWin's `use_chk` (JAX's per-block `nn.remat`),
through `nn.checkpoint.checkpoint_call`.

The checkpointed step is held to the port's own plain step, which
tests/test_torch_maxvit.py and tests/test_torch_cswin.py hold to JAX: narrow
models with drop-path 0.5 and an explicit generator, one forward and
backward each from one state. Every gradient, every BatchNorm running
statistic and the generator's state after the step are bit-equal between
the two (the recompute redraws the forward's DropPath masks, leaves the
generator where the backward found it, and does not update the statistics a
second time; for MaxViT, whose MBConv BatchNorms sit inside the blocks, a
stub that lets the recompute update them shows that the test sees it).
"""

import copy

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.models import ga_cswin as tgc
from imagenet_models_tpu_torch.models import maxvit as tmv
from imagenet_models_tpu_torch.nn import checkpoint as checkpointing

MAXVIT = dict(embed_dim=(32, 32, 64, 64), depths=(1, 1, 1, 1), stem_width=16, num_classes=11,
              head_hidden_size=24, last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16,
              gram_dim=16, ca_dim=16, num_heads=2, global_pool="mmcap", img_size=64)
CSWIN = dict(embed_dim=16, depth=(1, 1, 2, 1), dims=(16, 32, 64, 128),
             num_heads=(2, 2, 4, 4, 4), branches=2, gram_dim=48, stage3_naggre=1,
             num_classes=7, split_size=(1, 2, 2, 2, 2), img_size=64)


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _step(model, flag: str, on: bool):
    """One training forward and backward of a copy of `model` with the flag
    set; returns (gradients, BN running statistics, the generator's state,
    its next draw)."""
    m = copy.deepcopy(model).train()
    setattr(m, flag, on)
    gen = torch.Generator().manual_seed(3)
    torch.manual_seed(0)  # the heads' dropouts draw from the default generator
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32))
    loss = sum(t.float().square().mean() for t in _leaves(m(x, generator=gen)))
    loss.backward()
    grads = {k: p.grad for k, p in m.named_parameters() if p.grad is not None}
    stats = {k: b for k, b in m.named_buffers() if k.endswith(("running_mean", "running_var"))}
    return grads, stats, gen.get_state(), torch.rand(4, generator=gen)


def _equal(a: dict, b: dict) -> list:
    assert set(a) == set(b)
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("family", ["maxvit", "ga_cswin"])
def test_checkpointed_step_is_bit_equal(family, monkeypatch):
    if family == "maxvit":
        model, flag = tmv.MaxxVit(**MAXVIT, drop_path_rate=0.5), "grad_checkpointing"
    else:
        model, flag = tgc.GA_CSWinTransformer(**CSWIN, drop_path_rate=0.5), "use_chk"
    before = {k: b.clone() for k, b in model.named_buffers() if k.endswith("running_mean")}
    plain, chk = _step(model, flag, False), _step(model, flag, True)
    assert len(plain[0]) > 100 and _equal(plain[0], chk[0]) == []
    assert plain[1] and _equal(plain[1], chk[1]) == []
    assert torch.equal(plain[2], chk[2]) and torch.equal(plain[3], chk[3])
    assert all(not torch.equal(before[k], plain[1][k]) for k in before)  # one update was made
    if family == "maxvit":  # GA-CSWin's BatchNorms are in its heads, outside the blocks
        # the test sees a second update of the statistics in the recompute
        monkeypatch.setattr(checkpointing, "recomputing", lambda: False)
        twice = _step(model, flag, True)
        assert _equal(twice[0], chk[0]) == [] and _equal(twice[1], chk[1]) != []


@pytest.mark.parametrize("stride,padding,groups,bias", [(1, 0, 1, True), (2, 1, 1, False),
                                                        (4, 0, 1, True), (1, 1, 8, True)])
def test_fp32_conv_backward_is_the_convolutions_own(stride, padding, groups, bias):
    """`nn.layers._Fp32Conv`, which fp32 CUDA convolutions take so that
    their backward runs cuDNN's deterministic algorithms, gives the
    gradients of `F.conv2d` under autograd (checked here on the CPU, where
    the two are the same call: bit-equal)."""
    from imagenet_models_tpu_torch.nn.layers import _Fp32Conv

    rng = np.random.default_rng(stride * 10 + groups)
    x = torch.from_numpy(rng.standard_normal((2, 16, 9, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16 // groups, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32)) if bias else None
    g = torch.from_numpy(rng.standard_normal(
        tuple(torch.nn.functional.conv2d(x, w, b, stride=stride, padding=padding,
                                         groups=groups).shape)).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w) + ((b,) if bias else ())]
        out = fn(leaves[0], leaves[1], leaves[2] if bias else None)
        return (out,) + torch.autograd.grad(out, leaves, g)

    ref = grads(lambda x, w, b: torch.nn.functional.conv2d(x, w, b, stride=stride,
                                                            padding=padding, groups=groups))
    got = grads(lambda x, w, b: _Fp32Conv.apply(x, w, b, stride, padding, groups))
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
