"""Classification and segmentation losses: the port of the JAX package's
``criteria/classification.py`` (optax's losses written out in PyTorch).

* ``_ce``: cross entropy over the last axis of the logits (NHWC
  segmentation logits flatten their pixels); integer labels, or target
  probabilities with the logits' rank; label smoothing towards the uniform
  distribution; class weights by label, ``sum(w l) / sum(w)`` (with
  probability targets the weight is 1 and the sum is not divided, as in the
  JAX package).  Those sums are the global batch's in data-parallel
  training (``group``): summed over the ranks with a differentiable
  all-reduce; every other loss here is a mean of equal shares.
* ``_bce``: optax's ``sigmoid_binary_cross_entropy``,
  ``-t log_sigmoid(p) - (1 - t) log_sigmoid(-p)``.
* ``BCEWeightedClassLoss``: target channel 0 is a per-pixel weight map and
  the rest the labels.
* The ``WithAux`` losses add the same loss on Inception's auxiliary logits.

Each loss returns ``{"class_error", "aux_class_error"}``.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.distributed import all_sum


def _ce(pred: torch.Tensor, t: torch.Tensor, label_smoothing: float = 0.0,
        weight: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    num_classes = pred.shape[-1]
    logits = pred.reshape(-1, num_classes)
    log_probs = F.log_softmax(logits, dim=-1)
    if t.dim() == pred.dim():
        labels = t.reshape(-1, num_classes).float()
        if label_smoothing > 0:
            labels = (labels * (1 - label_smoothing)
                      + label_smoothing / num_classes)
        losses = -(labels * log_probs).sum(-1)
    else:
        labels = t.reshape(-1).long()
        if label_smoothing > 0:
            onehot = F.one_hot(labels, num_classes).float()
            onehot = (onehot * (1 - label_smoothing)
                      + label_smoothing / num_classes)
            losses = -(onehot * log_probs).sum(-1)
        else:
            label_logits = logits.gather(1, labels[:, None])[:, 0]
            losses = torch.logsumexp(logits, dim=-1) - label_logits
    if weight is not None:
        if t.dim() != pred.dim():
            w = weight.reshape(-1).to(losses.device)[labels]
            sums = all_sum(torch.stack([torch.sum(losses * w),
                                        torch.sum(w).to(losses.dtype)]),
                           group)
            return sums[0] / sums[1]
        return all_sum(torch.sum(losses), group)
    return torch.mean(losses)


def _bce(pred: torch.Tensor, t: torch.Tensor, reduce_mean: bool = True
         ) -> torch.Tensor:
    labels = t.to(pred.dtype)
    losses = (-labels * F.logsigmoid(pred)
              - (1.0 - labels) * F.logsigmoid(-pred))
    return torch.mean(losses) if reduce_mean else losses


def _zero(pred: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), device=pred.device)


class CEClassLoss:

    def __init__(self, weight=None, label_smoothing: float = 0.0, **_):
        self._weight = None if weight is None else torch.as_tensor(weight)
        self._smooth = label_smoothing

    def __call__(self, pred, t, group=None, **_):
        return {"class_error": _ce(pred, t, self._smooth, self._weight,
                                   group),
                "aux_class_error": _zero(pred)}


class BCEClassLoss:

    def __init__(self, **_):
        pass

    def __call__(self, pred, t, **_):
        return {"class_error": _bce(pred, t),
                "aux_class_error": _zero(pred)}


class BCEWeightedClassLoss:
    """BCE where target channel 0 is a per-pixel weight map (NHWC targets:
    ``t[..., :1]`` the weights, ``t[..., 1:]`` the labels)."""

    def __init__(self, **_):
        pass

    def __call__(self, pred, t, **_):
        losses = _bce(pred, t[..., 1:], reduce_mean=False)
        return {"class_error": torch.mean(t[..., :1] * losses),
                "aux_class_error": _zero(pred)}


class CEClassLossWithAux:

    def __init__(self, weight=None, label_smoothing: float = 0.0, **_):
        self._weight = None if weight is None else torch.as_tensor(weight)
        self._smooth = label_smoothing

    def __call__(self, pred, t, aux_pred=None, group=None, **_):
        out = {"class_error": _ce(pred, t, self._smooth, self._weight,
                                  group)}
        out["aux_class_error"] = (
            _ce(aux_pred, t, self._smooth, self._weight, group)
            if aux_pred is not None else _zero(pred))
        return out


class BCEClassLossWithAux:

    def __init__(self, **_):
        pass

    def __call__(self, pred, t, aux_pred=None, **_):
        out = {"class_error": _bce(pred, t)}
        out["aux_class_error"] = (_bce(aux_pred, t) if aux_pred is not None
                                  else _zero(pred))
        return out


CLASSLOSS_LIST = {
    "CELoss": CEClassLoss,
    "BCELoss": BCEClassLoss,
    "WeightedBCELoss": BCEWeightedClassLoss,
    "CELossWithAux": CEClassLossWithAux,
    "BCELossWithAux": BCEClassLossWithAux,
}
