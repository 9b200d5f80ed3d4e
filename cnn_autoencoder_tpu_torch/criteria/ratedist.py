"""Rate, distortion and energy-penalty losses (NHWC), counterparts of the
JAX package's ``criteria/ratedist.py:25-178``:

* ``rate_loss``: bits per pixel from the bottleneck's likelihoods;
* ``dist_mse`` and ``DistMSSSIM`` (1 - MS-SSIM with the scale-adaptive
  window and zero padding), and their multiscale pyramids
  (``PyramidLoss`` against a 5x5 binomial, 2x2-mean target pyramid);
* ``penalty_a``: the entropy of the per-channel energy shares;
* ``penalty_b``: the variance of the decode of a one-hot code.

Variances are the population's (``jnp.var``), computed in float32 and
returned in the input's type, as ``jnp.var`` does for bf16.  Medians are
``jnp.median``'s: the mean of the two middle values of an even count
(``torch.median`` returns the lower one).
"""

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.msssim import ms_ssim
from ..utils.device import full_f32


def rate_loss(x: torch.Tensor, p_y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """bpp estimate: -sum(log2 p_y) / (batch * H * W of the pixel input)."""
    denom = x.shape[0] * x.shape[1] * x.shape[2]
    return {"rate_loss": -torch.sum(torch.log2(p_y)) / denom}


def dist_mse(x: torch.Tensor, x_r: List[torch.Tensor], **_
             ) -> Dict[str, list]:
    return {"dist": [torch.mean((x_r[0] - x) ** 2)]}


class DistMSSSIM:
    """1 - MS-SSIM with the reference's scale-adaptive window and padding:
    win_size = 11 - 2*scale, win_sigma = 1.5 / 2**scale; a patch too small
    for a 5-level pyramid at that scale is zero-padded in both images."""

    def __init__(self, patch_size: int, scale: int = 0,
                 normalize: bool = False, **_):
        self.data_range = 2 if normalize else 1
        self.win_size = 11 - 2 * scale
        self.win_sigma = 1.5 / 2 ** scale
        pad = self.win_size - patch_size // 2 ** (scale + 4)
        self.padding = pad * 2 ** 3 if pad > 0 else 0

    def __call__(self, x: torch.Tensor, x_r: List[torch.Tensor], **_):
        rec = x_r[0]
        if self.padding > 0:
            pads = (0, 0) + (self.padding,) * 4
            rec = F.pad(rec, pads)
            x = F.pad(x, pads)
        val = ms_ssim(rec, x, data_range=self.data_range,
                      win_size=self.win_size, win_sigma=self.win_sigma)
        return {"dist": [1.0 - val]}


_PYR_KERNEL_1D = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def downsample_pyramid(x: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur (zero padding 2) and a 2x2 mean, the reference's
    bilinear 0.5x, of an NHWC target; detached."""
    c = x.shape[-1]
    k2d = torch.tensor(np.outer(_PYR_KERNEL_1D, _PYR_KERNEL_1D),
                       dtype=torch.float32, device=x.device)
    kern = k2d.reshape(1, 1, 5, 5).expand(c, 1, 5, 5).contiguous()
    with full_f32():
        blurred = F.conv2d(x.detach().permute(0, 3, 1, 2), kern, padding=2,
                           groups=c)
    return F.avg_pool2d(blurred, 2, 2).permute(0, 2, 3, 1)


class PyramidLoss:
    """Per-scale distortion criteria against a blurred target pyramid."""

    def __init__(self, dist_criteria):
        self._dist_criteria = dist_criteria

    def __call__(self, x: torch.Tensor, x_r: List[torch.Tensor], **kwargs):
        dist = []
        x_org = x
        for s, (x_r_s, d_crt) in enumerate(zip(x_r, self._dist_criteria)):
            dist += d_crt(x_org, [x_r_s], **kwargs)["dist"]
            if s < len(self._dist_criteria) - 1:
                x_org = downsample_pyramid(x_org)
        return {"dist": dist}


def dist_mse_pyramid(compression_level: int = 4, **kwargs):
    return PyramidLoss([lambda x, x_r, **_: dist_mse(x, x_r)
                        for _ in range(compression_level)])


def dist_msssim_pyramid(patch_size: int, compression_level: int = 4,
                        **kwargs):
    return PyramidLoss([DistMSSSIM(patch_size=patch_size, scale=s, **kwargs)
                        for s in range(compression_level)])


def _var(v: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.var``: the population's, in float32, in v's type."""
    return torch.var(v.float(), dim=dim, correction=0).to(v.dtype)


def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a vector: the two middle values' mean."""
    s = torch.sort(v.float()).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def penalty_a(x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Energy-compaction penalty A: the entropy of the per-channel energy
    shares, with the batch median of the largest share and of its channel
    (a float, as ``jnp.median`` gives it) for the PA stopping criterion
    and for PenaltyB."""
    x_mean = torch.mean(x, dim=-1)                           # (B, H, W)
    x_var = (_var(x_mean, (1, 2))[:, None] + 1e-10).detach()  # (B, 1)

    a = _var(y, (1, 2)) / x_var                              # (B, C)
    a = a / torch.sum(a, dim=1, keepdim=True)
    a = torch.clamp(a, 1e-10, 1.0)

    p_a = torch.mean(torch.sum(-a * torch.log2(a), dim=1))

    a_sg = a.detach()
    max_energy = _median(torch.max(a_sg, dim=1).values)
    channel_e = _median(torch.argmax(a_sg, dim=1))

    return {"weighted_penalty": p_a, "penalty": p_a, "energy": max_energy,
            "channel_e": channel_e}


def penalty_b(y: torch.Tensor, decoder_fn: Callable, channel_e: int = 0
              ) -> Dict[str, torch.Tensor]:
    """Energy-compaction penalty B: the variance of ``decoder_fn`` (the
    synthesis track on an NHWC latent) of a one-hot ``(1, h, w, C)`` code
    in y's type; only ``weighted_penalty`` carries a gradient."""
    _, h, w, c = y.shape
    fake_codes = F.one_hot(torch.tensor(channel_e, device=y.device), c)
    fake_codes = fake_codes.to(y.dtype).expand(1, h, w, c).contiguous()

    fake_rec = decoder_fn(fake_codes)
    if isinstance(fake_rec, (list, tuple)):
        fake_rec = fake_rec[0]

    p_b = _var(fake_rec, (1, 2, 3))[0]
    return {"weighted_penalty": p_b, "penalty": p_b.detach(),
            "energy": p_b.detach(),
            "channel_e": torch.tensor(channel_e, device=y.device)}


DIST_LOSS_LIST = {
    "MSE": lambda **kw: dist_mse,
    "MultiscaleMSE": dist_mse_pyramid,
    "MSSSIM": lambda **kw: DistMSSSIM(**kw),
    "MultiscaleMSSSIM": dist_msssim_pyramid,
}

PENALTY_LOSS_LIST = {
    "PenaltyA": penalty_a,
    "PenaltyB": penalty_b,
}

RATE_LOSS_LIST = {"Rate": rate_loss}
