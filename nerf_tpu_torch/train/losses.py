"""The loss library; counterpart of ``nerf_tpu/train/losses.py``.

Plain functions on tensors with the JAX package's semantics (epsilons,
normalisations, reductions): CornerNet's focal loss, weighted smooth-L1,
associative-embedding pull/push, cyclic polygon matching, edge attention,
index-gathered L1 (2D and 1D) and the geometric cross-entropy.
"""
from __future__ import annotations

from typing import Tuple

import torch


def clamped_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """sigmoid clamped to [eps, 1 - eps]."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CornerNet's modified focal loss. pred: probabilities in (0, 1); gt: a
    heatmap whose 1s are positives, the rest negatives weighted (1 - gt)^4."""
    pos = (gt == 1.0).to(pred.dtype)
    neg = (gt < 1.0).to(pred.dtype)
    neg_w = (1.0 - gt) ** 4
    pos_loss = torch.sum(torch.log(pred) * (1.0 - pred) ** 2 * pos)
    neg_loss = torch.sum(torch.log(1.0 - pred) * pred ** 2 * neg_w * neg)
    num_pos = torch.sum(pos)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
                   sigma: float = 1.0, normalize: bool = True,
                   reduce: bool = True) -> torch.Tensor:
    """Weighted smooth-L1. pred/target [b, d, h, w], weights [b, 1, h, w];
    quadratic below 1/sigma^2, linear above; optionally normalised by
    d * sum(weights) per item, then the mean."""
    b, d = pred.shape[0], pred.shape[1]
    sigma2 = sigma ** 2
    diff = weights * (pred - target)
    abs_diff = torch.abs(diff)
    quad = (abs_diff < 1.0 / sigma2).to(pred.dtype)
    loss = diff ** 2 * (sigma2 / 2.0) * quad + (abs_diff - 0.5 / sigma2) * (1.0 - quad)
    if normalize:
        loss = torch.sum(loss.reshape(b, -1), 1) / (d * torch.sum(weights.reshape(b, -1), 1)
                                                     + 1e-3)
    if reduce:
        loss = torch.mean(loss)
    return loss


def ae_loss(ae: torch.Tensor, ind: torch.Tensor,
            ind_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Associative-embedding (pull, push). ae [b, 1, h, w], ind [b, max_objs,
    max_parts] flat pixel indices, ind_mask of the same shape."""
    b, _, h, w = ae.shape
    _, max_objs, max_parts = ind.shape
    obj_mask = torch.sum(ind_mask, dim=2) != 0
    tag = torch.gather(ae.reshape(b, h * w), 1,
                       ind.reshape(b, max_objs * max_parts).long()).reshape(b, max_objs,
                                                                            max_parts)
    tag_mean = torch.sum(tag * ind_mask, 2) / (torch.sum(ind_mask, 2) + 1e-4)
    pull_dist = (tag - tag_mean[:, :, None]) ** 2 * ind_mask
    obj_num = torch.sum(obj_mask.to(ae.dtype), 1)
    pull = torch.sum(torch.sum(pull_dist, (1, 2)) / (obj_num + 1e-4)) / b
    push_dist = torch.relu(1.0 - torch.abs(tag_mean[:, None, :] - tag_mean[:, :, None]))
    pair_mask = (obj_mask[:, None, :] & obj_mask[:, :, None]).to(ae.dtype)
    push = torch.sum((torch.sum(push_dist * pair_mask, (1, 2)) - obj_num)
                     / (obj_num * (obj_num - 1) + 1e-4)) / b
    return pull, push


def poly_matching_loss(pred: torch.Tensor, gt: torch.Tensor,
                       loss_type: str = "L2") -> torch.Tensor:
    """Distance to the best cyclic shift of the gt contour; pred/gt [b, pnum, 2]."""
    pnum = pred.shape[1]
    ar = torch.arange(pnum, device=pred.device)
    gt_expand = gt[:, (ar[:, None] + ar[None, :]) % pnum]  # [b, pnum(shift), pnum, 2]
    dis = pred[:, None] - gt_expand
    if loss_type == "L2":
        dis = torch.sum(torch.sqrt(torch.sum(dis ** 2, 3)), 2)
    elif loss_type == "L1":
        dis = torch.sum(torch.sum(torch.abs(dis), 3), 2)
    else:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    return torch.mean(torch.min(dis, dim=1).values)


def attention_loss(pred: torch.Tensor, gt: torch.Tensor, beta: float = 4.0,
                   gamma: float = 0.5) -> torch.Tensor:
    """Edge attention: class-balanced BCE modulated by beta^((1-p)^gamma).
    pred in (0, 1), gt in {0, 1}."""
    num_pos = torch.sum(gt)
    num_neg = torch.sum(1.0 - gt)
    alpha = num_neg / (num_pos + num_neg)
    edge_beta = beta ** ((1.0 - pred) ** gamma)
    bg_beta = beta ** (pred ** gamma)
    loss = (-alpha * edge_beta * torch.log(pred) * gt
            - (1.0 - alpha) * bg_beta * torch.log(1.0 - pred) * (1.0 - gt))
    return torch.mean(loss)


def _gather_feat_2d(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [b, c, h, w], ind [b, n] flat spatial indices -> [b, n, c]."""
    b, c = feat.shape[0], feat.shape[1]
    flat = feat.permute(0, 2, 3, 1).reshape(b, -1, c)
    return torch.gather(flat, 1, ind.long()[..., None].expand(-1, -1, c))


def ind2d_reg_l1_loss(output: torch.Tensor, target: torch.Tensor, ind: torch.Tensor,
                      ind_mask: torch.Tensor) -> torch.Tensor:
    """Index-gathered 2D regression L1. output [b, c, h, w]; ind, ind_mask
    [b, max_objs, max_parts]; target [b, max_objs, max_parts, c]."""
    b, max_objs, max_parts = ind.shape
    pred = _gather_feat_2d(output, ind.reshape(b, -1)).reshape(b, max_objs, max_parts,
                                                              output.shape[1])
    mask = ind_mask[..., None]
    loss = torch.sum(torch.abs(pred * mask - target * mask))
    return loss / (torch.sum(mask.expand_as(pred)) + 1e-4)


def ind_l1_loss_1d(output: torch.Tensor, target: torch.Tensor, ind: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """Index-gathered 1D L1. output [b, c, h, w], ind [b, n], target
    [b, n, c], weight [b, n]."""
    pred = _gather_feat_2d(output, ind)
    w = weight[..., None]
    loss = torch.sum(torch.abs(pred * w - target * w))
    return loss / (torch.sum(weight) * output.shape[1] + 1e-4)


def geo_cross_entropy_loss(output: torch.Tensor, target: torch.Tensor,
                           poly: torch.Tensor) -> torch.Tensor:
    """Soft cross-entropy whose label is a gaussian kernel of the distance
    from the target vertex along the polygon. output [b, k, n], target [b, 4]
    (a vertex index a quarter), poly [b, 4 k', 2]."""
    logp = torch.log(torch.clamp(torch.softmax(output, dim=1), min=1e-4))
    b = poly.shape[0]
    poly4 = poly.reshape(b, 4, -1, 2)  # [b, 4, k', 2]
    idx = target.long()[..., None, None].expand(-1, -1, 1, 2)
    tgt = torch.gather(poly4, 2, idx)  # [b, 4, 1, 2]
    sigma = torch.sum((poly4[:, :, 0] - poly4[:, :, 1]) ** 2, -1, keepdim=True)  # [b, 4, 1]
    kernel = torch.exp(-torch.sum((poly4 - tgt) ** 2, 3) / (sigma / 3.0))
    return -torch.mean(torch.sum(logp * kernel.permute(0, 2, 1), 1))
