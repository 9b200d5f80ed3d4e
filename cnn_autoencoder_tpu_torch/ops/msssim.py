"""SSIM and MS-SSIM on NHWC tensors, the counterpart of the JAX package's
``ops/msssim.py:1-110`` (itself ``pytorch_msssim``'s semantics):

* separable depthwise Gaussian windows, VALID (no padding), per-channel
  means, in full float32 (``utils/device.py:full_f32``);
* between levels a 2x average pool with symmetric zero padding on an odd
  side, the padded zeros counted (``F.avg_pool2d`` with
  ``padding=(h % 2, w % 2)`` and ``count_include_pad=True`` gives the JAX
  package's windows);
* the product of the relu'd contrast terms under the standard 5-level
  weights.

bf16 inputs are widened to float32 before the first blur.  The JAX
function raises on them (its float32 window meets the bf16 image in one
convolution), so its bf16 training of an MS-SSIM criterion stops there.
"""

from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils.device import full_f32

DEFAULT_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(win_size: int, sigma: float, device) -> torch.Tensor:
    coords = (torch.arange(win_size, dtype=torch.float32, device=device)
              - win_size // 2)
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view, widened to float32 from bf16."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.permute(0, 3, 1, 2)


def _depthwise_blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian filter, VALID padding; x is NCHW."""
    c, n = x.shape[1], win.shape[0]
    kh = win.reshape(1, 1, n, 1).expand(c, 1, n, 1).contiguous()
    kw = win.reshape(1, 1, 1, n).expand(c, 1, 1, n).contiguous()
    with full_f32():
        return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)


def _ssim_per_channel(x, y, win_size, sigma, data_range, k1=0.01, k2=0.03):
    """(B, C) SSIM and contrast-structure means of NCHW x and y."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    win = _gaussian_window(win_size, sigma, x.device)

    mu_x = _depthwise_blur(x, win)
    mu_y = _depthwise_blur(y, win)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y

    sigma_xx = _depthwise_blur(x * x, win) - mu_xx
    sigma_yy = _depthwise_blur(y * y, win) - mu_yy
    sigma_xy = _depthwise_blur(x * y, win) - mu_xy

    cs_map = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def ssim(x, y, data_range: float = 1.0, win_size: int = 11,
         win_sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over batch and channels; inputs NHWC."""
    ssim_pc, _ = _ssim_per_channel(_nchw(x), _nchw(y), win_size, win_sigma,
                                   data_range)
    return ssim_pc.mean()


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x average pool of NCHW x, symmetric zero pad on odd sides, the pads
    counted."""
    return F.avg_pool2d(x, 2, 2, padding=(x.shape[2] % 2, x.shape[3] % 2),
                        count_include_pad=True)


def ms_ssim(x, y, data_range: float = 1.0, win_size: int = 11,
            win_sigma: float = 1.5,
            weights: Sequence[float] = DEFAULT_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM over NHWC inputs; returns the batch-mean scalar."""
    levels = len(weights)
    smaller_side = min(x.shape[1], x.shape[2])
    assert smaller_side > (win_size - 1) * (2 ** (levels - 1)), (
        f"Image size {tuple(x.shape)} too small for {levels}-level MS-SSIM "
        f"with win_size {win_size}")
    weights = torch.tensor(weights, dtype=torch.float32, device=x.device)
    x, y = _nchw(x), _nchw(y)

    mcs = []
    for i in range(levels):
        ssim_pc, cs_pc = _ssim_per_channel(x, y, win_size, win_sigma,
                                           data_range)
        if i < levels - 1:
            mcs.append(F.relu(cs_pc))
            x = _avg_pool2(x)
            y = _avg_pool2(y)

    mcs_and_ssim = torch.stack(mcs + [F.relu(ssim_pc)], dim=0)
    val = torch.prod(mcs_and_ssim ** weights[:, None, None], dim=0)
    return val.mean()
