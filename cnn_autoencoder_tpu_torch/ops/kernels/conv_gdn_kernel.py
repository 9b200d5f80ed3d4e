"""Fused reflect-pad + 3x3 stride-2 conv + GDN: the CUDA kernel
``csrc/conv_gdn.cu`` and its plain PyTorch version.

Replaces ``cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:_kernel`` (the
serving variant; the training variant that also returns the pre-GDN conv
output waits for the training slice).  Layouts are the JAX package's: NHWC
input, HWIO kernel (3, 3, Cin, Cout), ``gamma``/``beta`` already
reparameterized.  The kernel takes even H and W and at most
``MAX_COUT`` output channels (a block holds a pixel's whole channel row for
the GDN epilogue) and raises otherwise.
"""

import torch
import torch.nn.functional as F

from ...utils.device import full_f32
from .build import check_launch, load_library, stream_handle
from .gdn_kernel import gdn_plain

MAX_COUT = 128


def conv_gdn_plain(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """Reflect pad 1, 3x3/s2 VALID conv in full float32, then GDN."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    with full_f32():
        y = F.conv2d(xp, kernel.permute(3, 2, 0, 1), stride=2)
    y = y.permute(0, 2, 3, 1)
    cout = y.shape[-1]
    return gdn_plain(y.reshape(-1, cout), gamma, beta).reshape(y.shape)


def conv_gdn_cuda(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel; raises on what it does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"conv_gdn_cuda takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("conv_gdn kernel takes a contiguous float32 NHWC "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    b, h, w, cin = x.shape
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"conv_gdn kernel takes even H, W >= 2, got {h}x{w}")
    if kernel.shape[:3] != (3, 3, cin):
        raise ValueError(f"conv_gdn kernel takes a (3, 3, {cin}, Cout) "
                         f"kernel, got {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    if cout > MAX_COUT:
        raise ValueError(f"conv_gdn kernel takes Cout <= {MAX_COUT}, "
                         f"got {cout}")
    if gamma.shape != (cout, cout) or beta.shape != (cout,):
        raise ValueError("conv_gdn kernel: gamma/beta do not match Cout")
    for name, t in (("kernel", kernel), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device:
            raise ValueError(f"conv_gdn kernel: {name} is on {t.device}, "
                             f"x on {x.device}")
    kernel = kernel.float().contiguous()
    gamma_t = gamma.float().t().contiguous()
    beta = beta.float().contiguous()
    out = torch.empty((b, h // 2, w // 2, cout), dtype=torch.float32,
                      device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.cae_conv_gdn_fwd(x.data_ptr(), kernel.data_ptr(),
                                   gamma_t.data_ptr(), beta.data_ptr(),
                                   out.data_ptr(), b, h, w, cin, cout,
                                   stream_handle(x))
    check_launch(err, "conv_gdn_fwd")
    conv_gdn_cuda.launches += 1
    return out


conv_gdn_cuda.launches = 0
conv_gdn_cuda.kernel_name = "conv_gdn_fwd"


def fused_conv_gdn(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """reflect-pad -> 3x3/s2 conv -> GDN: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return conv_gdn_plain(x, kernel, gamma, beta)
    return conv_gdn_cuda(x, kernel, gamma, beta)
