"""Color-space conversions and the CIE76 color difference, in float64 on
the tensor's device: the port of the JAX package's ``ops/color.py:1-56``
(itself skimage's conventions).

sRGB -> XYZ under the D65 white through the standard sRGB transfer curve,
then CIELAB.  uint8 inputs are scaled to [0, 1], and so are floats whose
maximum passes 1.5 (0..255 floats, as the RD harness hands them over).
Inputs may be numpy arrays or tensors; numpy inputs go to ``device``
(None: the CPU), tensors stay where they are.  The results are float64
tensors.
"""

import numpy as np
import torch

# sRGB -> XYZ (D65) matrix
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))

# D65 reference white
_WHITE = (0.95047, 1.0, 1.08883)


def as_float64(x, device=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a float64 tensor, on ``device`` for numpy
    inputs and on its own device for tensors."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
        if device is not None:
            x = x.to(device)
    return x.to(torch.float64)


def _srgb_to_linear(rgb: torch.Tensor) -> torch.Tensor:
    return torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                       rgb / 12.92)


def rgb2xyz(rgb, device=None) -> torch.Tensor:
    if not isinstance(rgb, torch.Tensor):
        rgb = np.asarray(rgb)
    is_u8 = rgb.dtype in ((torch.uint8,) if isinstance(rgb, torch.Tensor)
                          else (np.uint8,))
    is_float = (rgb.is_floating_point() if isinstance(rgb, torch.Tensor)
                else np.issubdtype(rgb.dtype, np.floating))
    rgb = as_float64(rgb, device)
    if is_u8 or (is_float and bool(rgb.max() > 1.5)):
        rgb = rgb / 255.0
    m = torch.tensor(_RGB2XYZ, dtype=torch.float64, device=rgb.device)
    return _srgb_to_linear(rgb) @ m.T


def rgb2lab(rgb, device=None) -> torch.Tensor:
    """sRGB (HWC, uint8 or float) -> CIELAB."""
    xyz = rgb2xyz(rgb, device)
    xyz = xyz / torch.tensor(_WHITE, dtype=torch.float64, device=xyz.device)
    eps = 0.008856451679035631   # (6/29)^3
    kappa = 903.2962962962963    # (29/3)^3
    # the cube root only where xyz > eps > 0
    f = torch.where(xyz > eps, xyz.clamp_min(eps) ** (1.0 / 3.0),
                    (kappa * xyz + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def deltaE_cie76(lab1, lab2, device=None) -> torch.Tensor:
    """Euclidean distance in CIELAB (CIE76)."""
    lab1 = as_float64(lab1, device)
    lab2 = as_float64(lab2, lab1.device)
    return torch.sqrt(torch.sum((lab1 - lab2) ** 2, dim=-1))
