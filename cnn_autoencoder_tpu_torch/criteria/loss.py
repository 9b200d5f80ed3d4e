"""The loss composer and the criterion-string parser, counterparts of the
JAX package's ``criteria/loss.py:37-168`` for what this port carries:

* distortion (MSE, times 255^2, weighted by ``distortion_lambda``),
* rate (bpp) plus the bottleneck's auxiliary quantile loss, returned as
  ``entropy_loss`` for the train step to add.

A criterion that asks for MS-SSIM, a multiscale pyramid, an energy penalty
or a classification loss raises: those are not ported yet.
"""

from typing import Dict, Optional

import torch

from ..models.entropy import aux_loss_fn
from .ratedist import DIST_LOSS_LIST, NOT_PORTED, RATE_LOSS_LIST


def _check(kind: str, name: Optional[str], table) -> None:
    if name in NOT_PORTED:
        raise ValueError(f"{kind} loss {name} is not ported yet")
    if name not in table:
        raise ValueError(f"unknown {kind} loss {name}")


class GeneralLoss:

    def __init__(self, dist_loss_type: Optional[str] = "MSE",
                 rate_loss_type: Optional[str] = "Rate",
                 penalty_loss_type: Optional[str] = None,
                 class_loss_type: Optional[str] = None,
                 distortion_lambda=0.1, **_):
        if penalty_loss_type is not None \
                and penalty_loss_type.lower() != "none":
            raise ValueError(f"penalty {penalty_loss_type} is not ported yet")
        if class_loss_type is not None and class_loss_type.lower() != "none":
            raise ValueError(f"class loss {class_loss_type} is not ported yet")
        self.dist_loss = None
        if dist_loss_type is not None:
            _check("distortion", dist_loss_type, DIST_LOSS_LIST)
            self.dist_loss = DIST_LOSS_LIST[dist_loss_type]
            self._multiplier = 255 ** 2 if "MSE" in dist_loss_type else 1
            if not isinstance(distortion_lambda, (list, tuple)):
                distortion_lambda = [distortion_lambda]
            self._distortion_lambda = list(distortion_lambda)
        self.rate_loss = None
        if rate_loss_type is not None:
            _check("rate", rate_loss_type, RATE_LOSS_LIST)
            self.rate_loss = RATE_LOSS_LIST[rate_loss_type]

    def __call__(self, inputs: torch.Tensor, outputs, targets=None,
                 net=None) -> Dict[str, torch.Tensor]:
        del targets
        loss = torch.zeros((), device=inputs.device)
        loss_dict = {"channel_e": torch.tensor(-1, device=inputs.device)}
        if self.dist_loss is not None:
            loss_dict.update(self.dist_loss(x=inputs, x_r=outputs["x_r"]))
            loss_dict["dist"] = [self._multiplier * d
                                 for d in loss_dict["dist"]]
            # zip truncates, as in the reference
            loss_dict["dist_loss"] = sum(
                d * w for d, w in zip(loss_dict["dist"],
                                      self._distortion_lambda))
            loss = loss + loss_dict["dist_loss"]
        if self.rate_loss is not None:
            loss_dict.update(self.rate_loss(x=inputs, p_y=outputs["p_y"]))
            if net is not None and "fact_ent_params" in net:
                loss_dict["entropy_loss"] = aux_loss_fn(
                    net["fact_ent_params"], net["num_filters"])
            loss = loss + loss_dict["rate_loss"]
        loss_dict["loss"] = loss
        return loss_dict


def setup_loss(criterion: str, **kwargs) -> GeneralLoss:
    """Parse a criterion string (``"RateMSE"``, ...) into a GeneralLoss, by
    the JAX package's rules."""
    crit = criterion.lower()
    rate_loss_type = "Rate" if "rate" in crit else None
    if "mse" in crit:
        dist_loss_type = "MSE"
    elif "msssim" in crit or "ms-ssim" in crit:
        dist_loss_type = "MSSSIM"
    else:
        dist_loss_type = None
    if "multiscale" in crit and dist_loss_type is not None:
        dist_loss_type = "Multiscale" + dist_loss_type
    if "penaltya" in crit or "pa" in crit:
        penalty_loss_type = "PenaltyA"
    elif "penaltyb" in crit or "pb" in crit:
        penalty_loss_type = "PenaltyB"
    else:
        penalty_loss_type = "none"
    if "bce" in crit or "binarycrossentropy" in crit:
        class_loss_type = "BCELoss"
    elif "ce" in crit or "crossentropy" in crit:
        class_loss_type = "CELoss"
    else:
        class_loss_type = None
    return GeneralLoss(dist_loss_type, rate_loss_type, penalty_loss_type,
                       class_loss_type, **kwargs)
