"""Training losses. Port of imagenet_models_tpu/train/losses.py.

timm's BinaryCrossEntropy, SoftTargetCrossEntropy, LabelSmoothingCrossEntropy
and JsdCrossEntropy, and the GA/MAP multi-head objective with the
head-decorrelation KL and self-distillation pairs. The reductions are the
JAX package's (sum/numel against batch-mean is load-bearing for loss-curve
parity); logits are taken in fp32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def one_hot_smooth(target: torch.Tensor, num_classes: int, smoothing: float = 0.0) -> torch.Tensor:
    """Dense (optionally smoothed) fp32 targets from class indices."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(target.long(), num_classes).float() * (on - off) + off


def _dense_target(target: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    if target.dim() == 1:
        return one_hot_smooth(target, num_classes, smoothing)
    return target  # already dense (mixup soft targets carry their own smoothing)


def binary_cross_entropy(logits: torch.Tensor, target: torch.Tensor, smoothing: float = 0.0,
                         target_threshold: Optional[float] = None) -> torch.Tensor:
    """timm BinaryCrossEntropy: BCE-with-logits against dense targets, mean
    over every element."""
    t = _dense_target(target, logits.shape[-1], smoothing)
    if target_threshold is not None:
        t = (t > target_threshold).to(logits.dtype)
    x = logits.float()
    t = t.float()
    return (torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def soft_target_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                              smoothing: float = 0.0) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: batch-mean of sum(-t * log_softmax(x))."""
    t = _dense_target(target, logits.shape[-1], smoothing)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-(t * logp).sum(dim=-1)).mean()


def cross_entropy(logits: torch.Tensor, target: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """CrossEntropy / LabelSmoothingCrossEntropy."""
    return soft_target_cross_entropy(logits, target, smoothing)


def jsd_cross_entropy(logits: torch.Tensor, target: torch.Tensor, num_splits: int,
                      alpha: float = 12.0, smoothing: float = 0.1) -> torch.Tensor:
    """timm JsdCrossEntropy: cross-entropy on the clean split plus alpha times
    the mean over splits of KL(split || clamped mixture), batchmean. Rows are
    sample-major (sample k holds rows [k*s, (k+1)*s), clean split first), as
    the JAX package's loader lays them out (losses.py:68-104)."""
    n, c = logits.shape
    b = n // num_splits
    lsp = logits.reshape(b, num_splits, c).float()
    if target.dim() > 1:
        t_clean = target.reshape(b, num_splits, *target.shape[1:])[:, 0]
    else:
        t_clean = target.reshape(b, num_splits)[:, 0]
    loss = cross_entropy(lsp[:, 0], t_clean, smoothing)
    probs = torch.softmax(lsp, dim=-1)
    logm = torch.log(torch.clamp(probs.mean(dim=1), 1e-7, 1.0))[:, None, :]
    # torch F.kl_div(logm, p): sum p*(log p - logm), with 0*log 0 = 0
    pos = probs > 0
    kl = torch.where(pos, probs * (torch.log(torch.where(pos, probs, torch.ones_like(probs)))
                                   - logm), torch.zeros_like(probs))
    return loss + alpha * kl.sum() / (b * num_splits)


def create_loss_fn(bce_loss: bool = False, smoothing: float = 0.0,
                   bce_target_thresh: Optional[float] = None, mixup_active: bool = False,
                   jsd_splits: int = 0, jsd_alpha: float = 12.0) -> Callable:
    """The reference's loss selection (GA/train.py:612-630): with mixup the
    smoothing is in the mixup targets, so the dense-target losses take none;
    jsd_splits > 1 selects JsdCrossEntropy first."""
    if jsd_splits > 1:
        return lambda x, t: jsd_cross_entropy(x, t, jsd_splits, jsd_alpha, smoothing)
    if mixup_active:
        if bce_loss:
            return lambda x, t: binary_cross_entropy(x, t, 0.0, bce_target_thresh)
        return lambda x, t: soft_target_cross_entropy(x, t)
    if bce_loss:
        return lambda x, t: binary_cross_entropy(x, t, smoothing, bce_target_thresh)
    return lambda x, t: cross_entropy(x, t, smoothing)


def kl_div_log_target(input_logp: torch.Tensor, target_logp: torch.Tensor,
                      reduction: str) -> torch.Tensor:
    """torch F.kl_div(input, target, log_target=True): sum(exp(target) * (target - input))."""
    kl = torch.exp(target_logp) * (target_logp - input_logp)
    if reduction == "sum":
        return kl.sum()
    if reduction == "mean":
        return kl.mean()
    if reduction == "batchmean":
        return kl.sum() / kl.shape[0]
    raise ValueError(reduction)


HeadOutput = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def multi_head_loss(outputs: Sequence[HeadOutput], target: torch.Tensor, base_loss: Callable,
                    dec_lam: float = 0.0, token_distillation: bool = True) -> torch.Tensor:
    """The GA/MAP multi-head objective (losses.py:129-198).

    Per head: the classification loss of its main logits; an (org, avg) pair
    adds KL(log_softmax(avg) || detached log_softmax(org)), summed and divided
    by org.numel(); a (y_hat, y_distill, y_mean) triple with
    `token_distillation` adds two such KLs and takes the mean of the two
    branches' classification losses (without, only y_hat is trained). Across
    more than one head, `dec_lam` times KL(log_softmax(y_k) || log_softmax of
    the detached mean logits), mean reduction, decorrelates the heads.
    """
    loss = 0.0
    aggregate = 0.0
    mains = []
    for out in outputs:
        if isinstance(out, (tuple, list)) and len(out) == 3:
            y_hat, y_distill, y_mean = out
            if token_distillation:
                logp_mean = torch.log_softmax(y_mean.float(), dim=1)
                logp_hat = torch.log_softmax(y_hat.float(), dim=1).detach()
                logp_dst = torch.log_softmax(y_distill.float(), dim=1).detach()
                adv1 = kl_div_log_target(logp_mean, logp_hat, "sum") / y_hat.numel()
                adv2 = kl_div_log_target(logp_mean, logp_dst, "sum") / y_distill.numel()
                cls = 0.5 * (base_loss(y_hat, target) + base_loss(y_distill, target))
                loss = loss + cls + adv1 + adv2
            else:
                loss = loss + base_loss(y_hat, target)
            main = y_hat
        elif isinstance(out, (tuple, list)):
            org, avg = out
            logp_avg = torch.log_softmax(avg.float(), dim=1)
            logp_org = torch.log_softmax(org.float(), dim=1).detach()
            adv = kl_div_log_target(logp_avg, logp_org, "sum") / org.numel()
            loss = loss + base_loss(org, target) + adv
            main = org
        else:
            loss = loss + base_loss(out, target)
            main = out
        aggregate = aggregate + main.float().detach()
        mains.append(main)

    if len(outputs) > 1 and dec_lam != 0.0:
        mean_logp = torch.log_softmax(aggregate / len(outputs), dim=1)
        for y in mains:
            logp = torch.log_softmax(y.float(), dim=1)
            loss = loss + kl_div_log_target(logp, mean_logp, "mean") * dec_lam
    return loss
