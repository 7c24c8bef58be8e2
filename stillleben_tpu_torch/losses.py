"""Loss functions of the differentiation package.

Counterpart of ``stillleben_tpu/losses.py`` (reference
python/stillleben/losses.py)."""

from __future__ import annotations

import torch


def neg_iou_loss(predict: torch.Tensor, target: torch.Tensor):
    """Negative intersection over union (reference losses.py:5-21).

    :param predict: BxCxHxW image (a tensor, or an array that goes to the
        context's device)
    :param target: BxCxHxW image, moved to ``predict``'s device
    :return: (scalar loss, per-pixel loss image). The loss image carries no
        gradient (the JAX package's ``stop_gradient``, losses.py:24).
    """
    if not isinstance(predict, torch.Tensor):  # an array goes to the context's device
        from .context import context

        predict = torch.as_tensor(predict, device=context().device)
    predict = predict.to(torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=predict.device)
    dims = tuple(range(1, predict.dim()))
    _intersect = predict * target
    intersect = _intersect.sum(dims)
    _union = predict + target - predict * target
    union = _union.sum(dims) + 1e-6
    loss_img = (1.0 - _intersect / (_union + 1e-6)).detach()
    return 1.0 - (intersect / union).sum() / intersect.numel(), loss_img
