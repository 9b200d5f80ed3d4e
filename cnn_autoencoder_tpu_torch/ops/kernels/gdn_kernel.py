"""GDN over (N, C) rows: the CUDA kernel ``csrc/gdn.cu`` and its plain
PyTorch version.

Replaces ``cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:_gdn_kernel``.
``fused_gdn`` gives CPU tensors ``gdn_plain`` and CUDA tensors the kernel;
the kernel takes float32 rows of any channel count.
"""

import torch

from ...utils.device import full_f32
from .build import check_launch, load_library, stream_handle


def gdn_plain(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """y = x * (beta + x^2 gamma^T)^(-1/2) (inverse: ^(+1/2)); float32 math,
    one rounding to x's dtype."""
    x32 = x2d.float()
    with full_f32():
        norm = torch.matmul(x32 * x32, gamma.t().float()) + beta.float()
    r = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (x32 * r).to(x2d.dtype)


def _check_rows(x2d, gamma, beta):
    if x2d.dtype != torch.float32 or x2d.dim() != 2:
        raise ValueError(f"gdn kernel takes float32 (N, C) rows, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    c = x2d.shape[1]
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(f"gdn kernel: gamma {tuple(gamma.shape)} / beta "
                         f"{tuple(beta.shape)} do not match C = {c}")
    for name, t in (("x", x2d), ("gamma", gamma), ("beta", beta)):
        if t.device != x2d.device:
            raise ValueError(f"gdn kernel: {name} is on {t.device}, x on "
                             f"{x2d.device}")
    if not x2d.is_contiguous():
        raise ValueError("gdn kernel takes contiguous rows")


def gdn_cuda(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             inverse: bool = False) -> torch.Tensor:
    """The CUDA kernel; raises on what it does not take."""
    if x2d.device.type != "cuda":
        raise ValueError(f"gdn_cuda takes CUDA tensors, got {x2d.device}")
    _check_rows(x2d, gamma, beta)
    n, c = x2d.shape
    gamma_t = gamma.float().t().contiguous()
    beta = beta.float().contiguous()
    out = torch.empty_like(x2d)
    lib = load_library()
    with torch.cuda.device(x2d.device):
        err = lib.cae_gdn_fwd(x2d.data_ptr(), gamma_t.data_ptr(),
                              beta.data_ptr(), out.data_ptr(), n, c,
                              int(inverse), stream_handle(x2d))
    check_launch(err, "gdn_fwd")
    gdn_cuda.launches += 1
    return out


gdn_cuda.launches = 0
gdn_cuda.kernel_name = "gdn_fwd"


def fused_gdn(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """GDN over (N, C) rows: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if x2d.device.type == "cpu":
        return gdn_plain(x2d, gamma, beta, inverse)
    return gdn_cuda(x2d, gamma, beta, inverse)
