"""The loss composer and the criterion-string parser, counterparts of the
JAX package's ``criteria/loss.py:37-168``.  It sums, in this order:

* distortion: MSE, MS-SSIM or their multiscale pyramids (times 255^2
  where the name holds "MSE"), weighted by ``distortion_lambda``; the zip
  of the per-scale distortions with the lambdas truncates, as in the
  JAX package;
* rate (bpp), with the bottleneck's auxiliary quantile loss returned as
  ``entropy_loss`` for the train step to add;
* the energy penalty A or B, weighted by ``penalty_beta`` (the registry
  indexed by ``penalty_loss_type``);
* the classification or segmentation loss (``criteria/classification.py``)
  of the classifier's logits ``t_pred`` / ``t_aux_pred``, else the
  segmenter's ``s_pred`` / ``s_aux_pred``, against ``targets``, weighted by
  ``class_error_mu`` and ``class_error_aux_mu``.

``net`` carries what the losses need from the model: ``fact_ent_params``
and ``num_filters`` (the auxiliary loss) and ``decoder_fn`` (PenaltyB).
"""

from typing import Dict, Optional

import torch

from ..models.entropy import aux_loss_fn
from .classification import CLASSLOSS_LIST
from .ratedist import (DIST_LOSS_LIST, PENALTY_LOSS_LIST, RATE_LOSS_LIST,
                       penalty_a, penalty_b)


def _check(kind: str, name: str, table) -> None:
    if name not in table:
        raise ValueError(f"unknown {kind} loss {name}")


class GeneralLoss:

    def __init__(self, dist_loss_type: Optional[str] = "MSE",
                 rate_loss_type: Optional[str] = "Rate",
                 penalty_loss_type: Optional[str] = None,
                 class_loss_type: Optional[str] = None,
                 distortion_lambda=0.1,
                 penalty_beta: float = 0.001,
                 class_error_mu: float = 1.0,
                 class_error_aux_mu: float = 1.0,
                 channel_e: int = 0,
                 **kwargs):
        self.dist_loss = None
        if dist_loss_type is not None:
            _check("distortion", dist_loss_type, DIST_LOSS_LIST)
            self.dist_loss = DIST_LOSS_LIST[dist_loss_type](**kwargs)
            self._multiplier = 255 ** 2 if "MSE" in dist_loss_type else 1
            if not isinstance(distortion_lambda, (list, tuple)):
                distortion_lambda = [distortion_lambda]
            self._distortion_lambda = list(distortion_lambda)
        self.rate_loss = None
        if rate_loss_type is not None:
            _check("rate", rate_loss_type, RATE_LOSS_LIST)
            self.rate_loss = RATE_LOSS_LIST[rate_loss_type]
        self._penalty_type = None
        if penalty_loss_type is not None \
                and penalty_loss_type.lower() != "none":
            _check("penalty", penalty_loss_type, PENALTY_LOSS_LIST)
            self._penalty_type = penalty_loss_type
            self._penalty_beta = penalty_beta
            self._channel_e = channel_e
        self.class_loss = None
        if class_loss_type is not None and class_loss_type.lower() != "none":
            _check("class", class_loss_type, CLASSLOSS_LIST)
            self.class_loss = CLASSLOSS_LIST[class_loss_type](**kwargs)
            self._class_error_mu = class_error_mu
            self._class_error_aux_mu = class_error_aux_mu

    def _class_loss(self, outputs, targets) -> Dict[str, torch.Tensor]:
        if outputs.get("t_pred") is not None:
            pred, aux_pred = outputs["t_pred"], outputs.get("t_aux_pred")
        else:
            pred, aux_pred = outputs["s_pred"], outputs.get("s_aux_pred")
        return self.class_loss(pred=pred, aux_pred=aux_pred, t=targets)

    def __call__(self, inputs: torch.Tensor, outputs, targets=None,
                 net=None) -> Dict[str, torch.Tensor]:
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
        if self._penalty_type == "PenaltyA":
            loss_dict.update(penalty_a(x=inputs, y=outputs["y"]))
        elif self._penalty_type == "PenaltyB":
            loss_dict.update(penalty_b(y=outputs["y"],
                                       decoder_fn=net["decoder_fn"],
                                       channel_e=self._channel_e))
        if self._penalty_type is not None:
            loss = loss + self._penalty_beta * loss_dict["weighted_penalty"]
        if self.class_loss is not None:
            loss_dict.update(self._class_loss(outputs, targets))
            loss = (loss + self._class_error_mu * loss_dict["class_error"]
                    + self._class_error_aux_mu
                    * loss_dict["aux_class_error"])
        loss_dict["loss"] = loss
        return loss_dict


def setup_loss(criterion: str, **kwargs) -> GeneralLoss:
    """Parse a criterion string (``"RateMSE"``, ``"MultiscaleRateMSSSIM"``,
    ``"RateMSEPA"``, ``"RateMSECE"``, ...) into a GeneralLoss, by the JAX
    package's rules: BCE before CE, then "weighted", then "aux"."""
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
    if class_loss_type is not None and "weighted" in crit:
        class_loss_type = "Weighted" + class_loss_type
    if class_loss_type is not None and "aux" in crit:
        class_loss_type += "WithAux"
    return GeneralLoss(dist_loss_type, rate_loss_type, penalty_loss_type,
                       class_loss_type, **kwargs)
