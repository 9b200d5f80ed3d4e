"""Rate and distortion losses (NHWC), counterparts of the JAX package's
``criteria/ratedist.py:25-32``.

Ported: ``rate_loss`` (bits per pixel from the bottleneck's likelihoods)
and ``dist_mse``.  MS-SSIM and the multiscale pyramids are listed so that
asking for them raises "not ported"; the energy penalties raise in
``criteria.loss``.
"""

from typing import Dict, List

import torch


def rate_loss(x: torch.Tensor, p_y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """bpp estimate: -sum(log2 p_y) / (batch * H * W of the pixel input)."""
    denom = x.shape[0] * x.shape[1] * x.shape[2]
    return {"rate_loss": -torch.sum(torch.log2(p_y)) / denom}


def dist_mse(x: torch.Tensor, x_r: List[torch.Tensor], **_
             ) -> Dict[str, list]:
    return {"dist": [torch.mean((x_r[0] - x) ** 2)]}


RATE_LOSS_LIST = {"Rate": rate_loss}
DIST_LOSS_LIST = {"MSE": dist_mse}
NOT_PORTED = ("MSSSIM", "MultiscaleMSE", "MultiscaleMSSSIM")
