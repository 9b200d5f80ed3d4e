"""GDN over (N, C) rows: the CUDA kernels of ``csrc/gdn_tc.cu``,
``csrc/gdn_fwd_bf16_tc.cu`` and ``csrc/gdn_bf16_tc.cu`` and their plain
PyTorch versions.

* K1 ``gdn_cuda`` replaces ``cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:
  _gdn_kernel``, the serving GDN, and takes the rows' type as the JAX
  kernel takes its blocks'.  Float32 rows: float32-accurate math on the
  tensor cores (three TF32 passes over hi/lo parts of x^2 and gamma, split
  in the kernel, ``gdn_tc.cu``).  bf16 rows (``gdn_bf16_cuda``, the bf16
  serving mode's GDN): the pool at ``norm_pool_precision``, one bf16
  tensor-core pass with float32 sums, from K2's kernels without the
  residual (``gdn_fwd_bf16_tc.cu``); under ``CAE_TPU_GDN_FAST=0``
  (``gdn_bf16_f32pool_cuda``) the float32 kernel's three-pass pool on the
  widened rows, y stored as bf16 (``gdn_tc.cu``).  ``fused_gdn`` is its differentiable
  entry (the JAX ``fused_gdn`` custom VJP): the forward is the kernel on
  the card and ``gdn_plain`` on the CPU; the backward recomputes the plain
  GDN and differentiates it, as the JAX backward does (it has no kernel
  there either).
* K2 replaces ``_gdn_train_fwd_kernel``: ``y`` in the rows' type and the
  backward residual ``r`` as bf16, one wrapper for each type of rows.
  ``gdn_train_fwd_cuda`` takes bf16 rows (the bf16 mode's path) and runs
  the pool on the bf16 tensor cores (one pass, float32 sums,
  ``gdn_fwd_bf16_tc.cu``), or under ``CAE_TPU_GDN_FAST=0``
  (``gdn_train_fwd_bf16_f32pool_cuda``) the float32 kernel's pool with
  ``kWantR``; ``gdn_train_fwd_f32_cuda`` (kernel name
  ``gdn_train_fwd_f32``) takes float32 rows (a GDN after a batch norm in
  the bf16 mode) and runs K1's float32 kernel with the residual added
  (``gdn_tc.cu`` with ``kWantR``): the pool float32-accurate in three TF32
  passes, ``y`` bit-equal to K1's on the same rows.
* K3 ``gdn_train_bwd_cuda`` replaces ``_gdn_train_bwd_kernel``: ``dx`` in the
  cotangent's type and ``dnb = bf16(dnorm)``, the pool on the bf16 tensor
  cores (bf16 products are exact in float32; one pass, float32 sums); with
  ``want_dbeta`` also the column sums of the float32 ``dnorm`` (beta's
  gradient on the JAX package's default route), from partial sums the
  kernel writes as it goes.  ``gdn_mixed_bwd`` is the backward of the JAX
  ``gdn_mixed`` around it.

The norm pool's precision follows ``norm_pool_precision``.  The dispatchers
(``fused_gdn``, ``gdn_train_fwd``, ``gdn_train_bwd``) give CPU tensors the
plain versions and CUDA tensors the kernels, which take any C.
"""

from typing import Tuple

import torch

from ...utils.device import full_f32
from .. import switches
from .build import check_launch, load_library, stream_handle

_ROW_DTYPES = (torch.float32, torch.bfloat16)


def norm_pool_precision(dtype: torch.dtype) -> torch.dtype:
    """The type the norm pool rounds its multiplicands (x^2 and gamma) to,
    by activation dtype (the JAX package's ``ops/gdn.py:norm_pool_precision``):
    bf16 activations round them to bf16 and sum the products in float32;
    float32 activations keep full float32, and so do bf16 ones under
    ``CAE_TPU_GDN_FAST=0`` (read now, as the JAX package reads it)."""
    if dtype != torch.bfloat16 or not switches.gdn_fast():
        return torch.float32
    return torch.bfloat16


def _norm(x32: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          pool_dtype: torch.dtype) -> torch.Tensor:
    """beta + x^2 gamma^T, with x^2 and gamma rounded to ``pool_dtype`` and
    float32 sums (bf16 values are exact in float32, so the float32 product
    with TF32 off is the bf16-multiplicand, float32-accumulate product)."""
    x2 = (x32 * x32).to(pool_dtype).float()
    g = gamma.float().to(pool_dtype).float()
    with full_f32():
        return torch.matmul(x2, g.t()) + beta.float()


def gdn_plain(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """y = x * (beta + x^2 gamma^T)^(-1/2) (inverse: ^(+1/2)); float32 math,
    the pool at ``norm_pool_precision(x2d.dtype)``, one rounding to x's
    dtype."""
    x32 = x2d.float()
    norm = _norm(x32, gamma, beta, norm_pool_precision(x2d.dtype))
    r = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (x32 * r).to(x2d.dtype)


def gdn_train_fwd_plain(x2d: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, inverse: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function: (y in x's dtype, r as bf16), the pool at
    ``norm_pool_precision(x2d.dtype)``."""
    x32 = x2d.float()
    norm = _norm(x32, gamma, beta, norm_pool_precision(x2d.dtype))
    r = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (x32 * r).to(x2d.dtype), r.to(torch.bfloat16)


def gdn_train_bwd_plain(g: torch.Tensor, xb: torch.Tensor, rb: torch.Tensor,
                        gamma: torch.Tensor, inverse: bool = False,
                        want_dbeta: bool = False):
    """K3's function: (dx in g's dtype, dnb = bf16(dnorm)), with the C x C
    product over bf16 dnb and bf16 gamma summed in float32; with
    ``want_dbeta`` also the column sums of the float32 dnorm (float32)."""
    g32, x, r = g.float(), xb.float(), rb.float()
    if inverse:
        dnorm = (0.5 * g32 * x) / r
    else:
        dnorm = (-0.5 * g32 * x) * (r * r * r)
    dnb = dnorm.to(torch.bfloat16)
    with full_f32():
        back = torch.matmul(dnb.float(),
                            gamma.float().to(torch.bfloat16).float())
    dx = g32 * r + 2.0 * x * back
    if want_dbeta:
        return dx.to(g.dtype), dnb, dnorm.sum(0)
    return dx.to(g.dtype), dnb


def _check_rows(name, t, c, dtypes, device):
    if t.dtype not in dtypes or t.dim() != 2 or t.shape[1] != c:
        raise ValueError(f"{name}: takes (N, {c}) rows of {dtypes}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: takes contiguous rows")


def _check_params(kernel, device, c, gamma, beta=None):
    if gamma.shape != (c, c) or (beta is not None and beta.shape != (c,)):
        raise ValueError(f"{kernel}: gamma {tuple(gamma.shape)} / beta "
                         f"{None if beta is None else tuple(beta.shape)} "
                         f"do not match C = {c}")
    for t in (gamma, beta):
        if t is not None and t.device != device:
            raise ValueError(f"{kernel}: parameters on {t.device}, rows on "
                             f"{device}")


def _require_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {t.device}")


def gdn_cuda(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             inverse: bool = False) -> torch.Tensor:
    """K1 on float32 or bf16 rows; raises on what it does not take."""
    c = x2d.shape[-1]
    _check_rows("gdn kernel x", x2d, c, _ROW_DTYPES, x2d.device)
    _check_params("gdn kernel", x2d.device, c, gamma, beta)
    _require_cuda("gdn_cuda", x2d)
    if x2d.dtype == torch.bfloat16:
        if norm_pool_precision(x2d.dtype) == torch.float32:
            return gdn_bf16_f32pool_cuda(x2d, gamma, beta, inverse)
        return gdn_bf16_cuda(x2d, gamma, beta, inverse)
    n = x2d.shape[0]
    gamma = gamma.detach().float().contiguous()
    beta = beta.detach().float().contiguous()
    out = torch.empty_like(x2d)
    lib = load_library()
    with torch.cuda.device(x2d.device):
        err = lib.cae_gdn_fwd(x2d.data_ptr(), gamma.data_ptr(),
                              beta.data_ptr(), out.data_ptr(), n, c,
                              int(inverse), stream_handle(x2d))
    check_launch(err, "gdn_fwd")
    gdn_cuda.launches += 1
    return out


gdn_cuda.launches = 0
gdn_cuda.kernel_name = "gdn_fwd"


def gdn_bf16_cuda(x2d: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """K1 on bf16 rows, the pool in one bf16 pass; raises on what it does
    not take."""
    c = x2d.shape[-1]
    _check_rows("gdn kernel x", x2d, c, (torch.bfloat16,), x2d.device)
    _check_params("gdn kernel", x2d.device, c, gamma, beta)
    _require_cuda("gdn_bf16_cuda", x2d)
    n = x2d.shape[0]
    gamma = gamma.detach().float().contiguous()
    beta = beta.detach().float().contiguous()
    out = torch.empty_like(x2d)
    lib = load_library()
    with torch.cuda.device(x2d.device):
        # the kernel's bf16 copy of gamma, padded
        work = torch.empty(lib.cae_gdn_fwd_bf16_workspace(c),
                           dtype=torch.uint8, device=x2d.device)
        err = lib.cae_gdn_fwd_bf16(x2d.data_ptr(), gamma.data_ptr(),
                                   beta.data_ptr(), out.data_ptr(),
                                   work.data_ptr(), n, c, int(inverse),
                                   stream_handle(x2d))
    check_launch(err, "gdn_fwd_bf16")
    gdn_bf16_cuda.launches += 1
    return out


gdn_bf16_cuda.launches = 0
gdn_bf16_cuda.kernel_name = "gdn_fwd_bf16"


def gdn_bf16_f32pool_cuda(x2d: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, inverse: bool = False
                          ) -> torch.Tensor:
    """K1 on bf16 rows with the float32-accurate pool
    (``CAE_TPU_GDN_FAST=0``); raises on what it does not take."""
    c = x2d.shape[-1]
    _check_rows("gdn kernel x", x2d, c, (torch.bfloat16,), x2d.device)
    _check_params("gdn kernel", x2d.device, c, gamma, beta)
    _require_cuda("gdn_bf16_f32pool_cuda", x2d)
    gamma = gamma.detach().float().contiguous()
    beta = beta.detach().float().contiguous()
    out = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        err = load_library().cae_gdn_fwd_bf16_f32pool(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), x2d.shape[0], c, int(inverse),
            stream_handle(x2d))
    check_launch(err, "gdn_fwd_bf16_f32pool")
    gdn_bf16_f32pool_cuda.launches += 1
    return out


gdn_bf16_f32pool_cuda.launches = 0
gdn_bf16_f32pool_cuda.kernel_name = "gdn_fwd_bf16_f32pool"


def gdn_train_fwd_cuda(x2d: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, inverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on bf16 rows, the pool in one bf16 pass; raises on what it does
    not take."""
    c = x2d.shape[-1]
    _check_rows("gdn_train_fwd x", x2d, c, (torch.bfloat16,), x2d.device)
    _check_params("gdn_train_fwd", x2d.device, c, gamma, beta)
    _require_cuda("gdn_train_fwd_cuda", x2d)
    n = x2d.shape[0]
    gamma = gamma.detach().float().contiguous()
    beta = beta.detach().float().contiguous()
    y = torch.empty_like(x2d)
    rb = torch.empty(x2d.shape, dtype=torch.bfloat16, device=x2d.device)
    lib = load_library()
    with torch.cuda.device(x2d.device):
        # the kernel's bf16 copy of gamma, padded
        work = torch.empty(lib.cae_gdn_train_fwd_workspace(c),
                           dtype=torch.uint8, device=x2d.device)
        err = lib.cae_gdn_train_fwd(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), rb.data_ptr(), work.data_ptr(), n, c,
            int(inverse), stream_handle(x2d))
    check_launch(err, "gdn_train_fwd")
    gdn_train_fwd_cuda.launches += 1
    return y, rb


gdn_train_fwd_cuda.launches = 0
gdn_train_fwd_cuda.kernel_name = "gdn_train_fwd"


def gdn_train_fwd_bf16_f32pool_cuda(x2d: torch.Tensor, gamma: torch.Tensor,
                                    beta: torch.Tensor, inverse: bool = False
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on bf16 rows with the float32-accurate pool
    (``CAE_TPU_GDN_FAST=0``); raises on what it does not take."""
    c = x2d.shape[-1]
    _check_rows("gdn_train_fwd x", x2d, c, (torch.bfloat16,), x2d.device)
    _check_params("gdn_train_fwd", x2d.device, c, gamma, beta)
    _require_cuda("gdn_train_fwd_bf16_f32pool_cuda", x2d)
    gamma = gamma.detach().float().contiguous()
    beta = beta.detach().float().contiguous()
    y = torch.empty_like(x2d)
    rb = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        err = load_library().cae_gdn_train_fwd_bf16_f32pool(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            rb.data_ptr(), x2d.shape[0], c, int(inverse), stream_handle(x2d))
    check_launch(err, "gdn_train_fwd_bf16_f32pool")
    gdn_train_fwd_bf16_f32pool_cuda.launches += 1
    return y, rb


gdn_train_fwd_bf16_f32pool_cuda.launches = 0
gdn_train_fwd_bf16_f32pool_cuda.kernel_name = "gdn_train_fwd_bf16_f32pool"


def gdn_train_fwd_f32_cuda(x2d: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, inverse: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on float32 rows; raises on what it does not take."""
    c = x2d.shape[-1]
    _check_rows("gdn_train_fwd x", x2d, c, (torch.float32,), x2d.device)
    _check_params("gdn_train_fwd", x2d.device, c, gamma, beta)
    _require_cuda("gdn_train_fwd_f32_cuda", x2d)
    n = x2d.shape[0]
    gamma = gamma.detach().float().contiguous()
    beta = beta.detach().float().contiguous()
    y = torch.empty_like(x2d)
    rb = torch.empty(x2d.shape, dtype=torch.bfloat16, device=x2d.device)
    lib = load_library()
    with torch.cuda.device(x2d.device):
        err = lib.cae_gdn_train_fwd_f32(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), rb.data_ptr(), n, c, int(inverse),
            stream_handle(x2d))
    check_launch(err, "gdn_train_fwd_f32")
    gdn_train_fwd_f32_cuda.launches += 1
    return y, rb


gdn_train_fwd_f32_cuda.launches = 0
gdn_train_fwd_f32_cuda.kernel_name = "gdn_train_fwd_f32"


def gdn_train_bwd_cuda(g: torch.Tensor, xb: torch.Tensor, rb: torch.Tensor,
                       gamma: torch.Tensor, inverse: bool = False,
                       want_dbeta: bool = False):
    """K3; raises on what it does not take."""
    c = g.shape[-1]
    _check_rows("gdn_train_bwd g", g, c, _ROW_DTYPES, g.device)
    for name, t in (("xb", xb), ("rb", rb)):
        _check_rows(f"gdn_train_bwd {name}", t, c, (torch.bfloat16,),
                    g.device)
        if t.shape != g.shape:
            raise ValueError(f"gdn_train_bwd: {name} {tuple(t.shape)} does "
                             f"not match g {tuple(g.shape)}")
    _check_params("gdn_train_bwd", g.device, c, gamma)
    _require_cuda("gdn_train_bwd_cuda", g)
    n = g.shape[0]
    gamma = gamma.detach().float().contiguous()
    dx = torch.empty_like(g)
    dnb = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    is_bf16 = int(g.dtype == torch.bfloat16)
    lib = load_library()
    # the kernel's bf16 copy of gamma, transposed and padded
    work = torch.empty(lib.cae_gdn_train_bwd_workspace(c), dtype=torch.uint8,
                       device=g.device)
    with torch.cuda.device(g.device):
        part = None
        if want_dbeta:  # a row of dbeta's partial sums for each warp group
            rows = lib.cae_gdn_train_bwd_partials(n, c, is_bf16)
            if rows < 0:
                raise RuntimeError("gdn_train_bwd: no launch plan")
            part = torch.empty(rows, c, dtype=torch.float32,
                               device=g.device)
        err = lib.cae_gdn_train_bwd(
            g.data_ptr(), xb.data_ptr(), rb.data_ptr(), gamma.data_ptr(),
            dx.data_ptr(), dnb.data_ptr(),
            None if part is None else part.data_ptr(), work.data_ptr(), n,
            c, int(inverse), is_bf16, stream_handle(g))
    check_launch(err, "gdn_train_bwd")
    gdn_train_bwd_cuda.launches += 1
    if part is None:
        return dx, dnb
    return dx, dnb, part.sum(0)


gdn_train_bwd_cuda.launches = 0
gdn_train_bwd_cuda.kernel_name = "gdn_train_bwd"


def gdn_train_fwd(x2d, gamma, beta, inverse: bool = False):
    """K2's function: the plain version for CPU tensors, the kernel for
    CUDA tensors (by the rows' type and the pool's precision)."""
    if x2d.device.type == "cpu":
        return gdn_train_fwd_plain(x2d, gamma, beta, inverse)
    if x2d.dtype == torch.float32:
        return gdn_train_fwd_f32_cuda(x2d, gamma, beta, inverse)
    if norm_pool_precision(x2d.dtype) == torch.float32:
        return gdn_train_fwd_bf16_f32pool_cuda(x2d, gamma, beta, inverse)
    return gdn_train_fwd_cuda(x2d, gamma, beta, inverse)


def gdn_train_bwd(g, xb, rb, gamma, inverse: bool = False,
                  want_dbeta: bool = False):
    """K3's function: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if g.device.type == "cpu":
        return gdn_train_bwd_plain(g, xb, rb, gamma, inverse, want_dbeta)
    return gdn_train_bwd_cuda(g, xb, rb, gamma, inverse, want_dbeta)


def gdn_mixed_bwd(g: torch.Tensor, xb: torch.Tensor, rb: torch.Tensor,
                  gamma: torch.Tensor, inverse: bool = False,
                  need_gamma: bool = True, need_beta: bool = True):
    """The backward of the JAX ``gdn_mixed`` (``ops/gdn.py:_gdn_mixed_bwd``
    there) over (N, C) rows: (dx in g's type, dgamma, dbeta), the last two
    float32 or None where not needed.  dx and dnb come from K3; dgamma is
    the contraction of dnb with bf16(xb * xb), float32 sums; dbeta the
    column sums of the float32 dnorm (the default route's, from K3), or,
    under ``CAE_TPU_GDN_TRAIN_KERNEL=1`` (the JAX training kernels), of
    the bf16 dnb."""
    from_dnb = switches.gdn_train_kernel()
    outs = gdn_train_bwd(g, xb, rb, gamma, inverse,
                         want_dbeta=need_beta and not from_dnb)
    dx, dnb = outs[:2]
    dbeta = None
    if need_beta:
        dbeta = dnb.float().sum(0) if from_dnb else outs[2]
    dgamma = None
    if need_gamma:
        with full_f32():
            dgamma = torch.matmul(dnb.float().t(), (xb * xb).float())
    return dx, dgamma, dbeta


class _FusedGDN(torch.autograd.Function):
    """K1 forward; backward by autograd of the recomputed plain GDN (the
    JAX ``_fused_gdn_bwd``)."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, inverse):
        ctx.save_for_backward(x2d, gamma, beta)
        ctx.inverse = inverse
        if x2d.device.type == "cpu":
            return gdn_plain(x2d, gamma, beta, inverse)
        return gdn_cuda(x2d, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        x2d, gamma, beta = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip((x2d, gamma, beta), ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), full_f32():
            y = gdn_plain(*inputs, ctx.inverse)
            grads = iter(torch.autograd.grad(y, wanted, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def fused_gdn(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """Differentiable GDN over float32 or bf16 (N, C) rows: K1 on the card,
    the plain version on the CPU, the plain GDN's gradient."""
    return _FusedGDN.apply(x2d, gamma, beta, inverse)
