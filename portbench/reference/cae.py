"""The plain reference of the CAE: analysis, synthesis, the factorized
entropy model, the RateMSE loss and per-module Adam, in plain PyTorch on
NCHW tensors.

It follows the published model (Cheng et al., IEEE TMM 2019, as the
reference implementation ``src/models/tasks/_autoencoders.py`` builds it)
in the checkpoint format the codec reads: conv kernels HWIO, transposed-conv
kernels spatially flipped HWIO, GDN parameters stored under the
non-negative reparameterization ``s = sqrt(max(v + 2^-36, 2^-36))``, the
bottleneck's (C, out, in) matrices.  Every convolution reflect-pads by one
and runs 3x3 at stride 2 (the residual branch at stride 1); every
transposed convolution has torch's geometry (stride 2, padding 1, output
padding 1; the residual branch stride 1, padding 1).  GDN is
``x / sqrt(beta + gamma @ x^2)`` (IGDN multiplies), with ``gamma`` and
``beta`` recovered through a lower bound whose gradient passes where the
value is at or above the bound or the gradient would raise it.

``product`` says how the convolutions and GDN's pool multiply: "float32"
(TF32 off: the configuration's precision) or "tf32", the operands rounded
to TF32 (10 mantissa bits, round to nearest even) with float32 sums, the
precision just below, on any device: the control that a comparison must
fail.  Nothing here imports the program.
"""

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PEDESTAL = 2.0 ** -36
BETA_MIN = 1e-6
LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
CLIP_NORM = 1.0
PRODUCTS = ("float32", "tf32")


class _LowerBound(torch.autograd.Function):
    """``max(x, bound)``; the gradient passes where ``x >= bound`` or where
    it is negative (it would push ``x`` up)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x >= ctx.bound) | (g < 0)
        return torch.where(keep, g, torch.zeros_like(g)), None


class _RoundTF32(torch.autograd.Function):
    """Round float32 to TF32 (10 mantissa bits, to nearest even); the
    gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        i = x.contiguous().view(torch.int32)
        i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
        return i.view(torch.float32).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g


@contextlib.contextmanager
def _no_tf32():
    """cuDNN and cuBLAS in float32 (cuDNN's convolutions default to TF32 on
    this hardware); the settings it found restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _operand(t: torch.Tensor, product: str) -> torch.Tensor:
    if product == "float32":
        return t
    if product == "tf32":
        return _RoundTF32.apply(t)
    raise ValueError(f"product {product!r} not in {PRODUCTS}")


def _nonneg(stored: torch.Tensor, minimum: float) -> torch.Tensor:
    bound = (minimum + PEDESTAL) ** 0.5
    out = _LowerBound.apply(stored, bound)
    return out * out - PEDESTAL


def _conv(x, kernel, stride: int, product: str, bias=None):
    w = kernel.permute(3, 2, 0, 1)
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(_operand(xp, product), _operand(w, product), bias,
                    stride=stride)


def _deconv(x, kernel, stride: int, output_padding: int, product: str,
            bias=None):
    w = kernel.flip(0, 1).permute(2, 3, 0, 1)
    return F.conv_transpose2d(_operand(x, product), _operand(w, product),
                              bias, stride=stride, padding=1,
                              output_padding=output_padding)


def _gdn(x, p: Dict[str, torch.Tensor], prefix: str, inverse: bool,
         product: str):
    gamma = _nonneg(p[prefix + "/gamma"], 0.0)
    beta = _nonneg(p[prefix + "/beta"], BETA_MIN)
    norm = F.conv2d(_operand(x * x, product),
                    _operand(gamma[:, :, None, None], product))
    norm = norm + beta[None, :, None, None]
    return x * torch.sqrt(norm) if inverse else x / torch.sqrt(norm)


def analysis(p: Dict[str, torch.Tensor], x: torch.Tensor, config,
             product: str = "float32") -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> (B, C, H / 2^L, W / 2^L) latent y."""
    levels = int(config["compression_level"])
    for i in range(levels):
        u, act = f"encoder/down_{i}", i < levels - 1
        if config.get("use_residual"):
            fx = _conv(x, p[u + "/res_conv1/kernel"], 1, product,
                       p.get(u + "/res_conv1/bias"))
            if act:
                fx = _gdn(fx, p, u + "/gdn_res", False, product)
            x = fx + x
        x = _conv(x, p[u + "/conv_down/kernel"], 2, product,
                  p.get(u + "/conv_down/bias"))
        if act:
            x = _gdn(x, p, u + "/gdn_down", False, product)
    return x


def synthesis(p: Dict[str, torch.Tensor], y: torch.Tensor, config,
              product: str = "float32") -> torch.Tensor:
    """(B, C, h, w) latent -> (B, 3, h 2^L, w 2^L) reconstruction."""
    levels = int(config["compression_level"])
    x = y
    for i in range(levels):
        u, act = f"decoder/up_{i}", i < levels - 1
        if config.get("use_residual"):
            fx = _deconv(x, p[u + "/res_deconv1/kernel"], 1, 0, product,
                         p.get(u + "/res_deconv1/bias"))
            if act:
                fx = _gdn(fx, p, u + "/gdn_res", True, product)
            x = fx + x
        x = _deconv(x, p[u + "/deconv_up/kernel"], 2, 1, product,
                    p.get(u + "/deconv_up/bias"))
        if act:
            x = _gdn(x, p, u + "/gdn_up", True, product)
    return x


def medians(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["fact_ent/quantiles"][:, 0, 1]


@_no_tf32()
def symbols(p, tiles_u8: torch.Tensor, config,
            product: str = "float32") -> torch.Tensor:
    """(B, H, W, 3) uint8 tiles, sides multiples of 2^L -> (B, C, h, w)
    int32 quantized latent ``round(y - medians)``."""
    x = tiles_u8.permute(0, 3, 1, 2).float() / 255.0
    y = analysis(p, x, config, product)
    return torch.round(y - medians(p)[None, :, None, None]).to(torch.int32)


@_no_tf32()
def pixels(p, sym: torch.Tensor, config,
           product: str = "float32") -> torch.Tensor:
    """(B, C, h, w) symbols -> (B, H, W, 3) uint8: the synthesis of
    ``symbols + medians``, times 255, clipped to [0, 255] and truncated."""
    y = sym.float() + medians(p)[None, :, None, None]
    x_r = synthesis(p, y, config, product)
    return torch.clamp(x_r * 255.0, 0, 255).to(torch.uint8).permute(
        0, 2, 3, 1)


# -- the factorized entropy model -------------------------------------------

def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _chain(p, v: torch.Tensor, num_filters: int) -> torch.Tensor:
    """The cumulative-logit chain on channel-last ``v`` (..., C)."""
    x = v[..., None]
    for i in range(num_filters + 1):
        m = _softplus(p[f"fact_ent/matrix_{i}"])
        x = (torch.einsum("cof,...cf->...co", m, x)
             + p[f"fact_ent/bias_{i}"][:, :, 0])
        if i < num_filters:
            x = x + torch.tanh(p[f"fact_ent/factor_{i}"][:, :, 0]) \
                * torch.tanh(x)
    return x[..., 0]


def likelihood(p, v: torch.Tensor, num_filters: int) -> torch.Tensor:
    """P(round(v)) of channel-last ``v``, held above 1e-9."""
    lower = _chain(p, v - 0.5, num_filters)
    upper = _chain(p, v + 0.5, num_filters)
    sign = -torch.sign(lower + upper).detach()
    lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    return _LowerBound.apply(lik, LIKELIHOOD_BOUND)


def aux_loss(p, num_filters: int) -> torch.Tensor:
    """The quantile-fitting loss; only the quantiles move by it."""
    target = math.log(2.0 / TAIL_MASS - 1.0)
    q = p["fact_ent/quantiles"][:, 0, :]
    held = {k: (v if k == "fact_ent/quantiles" else v.detach())
            for k, v in p.items() if k.startswith("fact_ent/")}
    logits = _chain(held, q.t(), num_filters)
    targets = torch.tensor([-target, 0.0, target], device=q.device)
    return torch.abs(logits - targets[:, None]).sum()


# -- training ----------------------------------------------------------------

def rate_mse_loss(p, x_nhwc: torch.Tensor, noise_nhwc: torch.Tensor, config,
                  lam: float, product: str = "float32"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RateMSE loss, loss + auxiliary loss) of one batch: ``lam * 255^2 *
    MSE + bits per pixel`` with additive-noise quantization."""
    num_filters = int(config.get("K", 4))
    x = x_nhwc.permute(0, 3, 1, 2)
    y = analysis(p, x, config, product)
    y_q = y + noise_nhwc.permute(0, 3, 1, 2)
    p_y = likelihood(p, y_q.permute(0, 2, 3, 1), num_filters)
    x_r = synthesis(p, y_q, config, product)
    dist = 255.0 ** 2 * torch.mean((x_r - x) ** 2)
    b, h, w = x_nhwc.shape[:3]
    rate = -torch.sum(torch.log2(p_y)) / (b * h * w)
    loss = lam * dist + rate
    return loss, loss + aux_loss(p, num_filters)


def slot_of(name: str) -> str:
    """The optimizer slot of a leaf: its module, the quantiles apart."""
    module = name.split("/")[0]
    return module + "_aux" if "quantiles" in name or "aux" in name \
        else module


class Adam:
    """One Adam a slot, after clipping the slot's gradients to global norm
    1 (optax's ``clip_by_global_norm`` then ``scale_by_adam``)."""

    def __init__(self, names: Sequence[str]):
        self.slots: Dict[str, List[str]] = {}
        for n in names:
            self.slots.setdefault(slot_of(n), []).append(n)
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, p, grads, lr: float) -> Dict[str, torch.Tensor]:
        """Move ``p`` in place; returns the clipped gradients."""
        self.count += 1
        one, n = np.float32(1), np.float32(self.count)
        c1 = float(one - np.float32(ADAM_B1) ** n)
        c2 = float(one - np.float32(ADAM_B2) ** n)
        clipped = {}
        for names in self.slots.values():
            norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k])
                                  for k in names))
            for k in names:
                g = grads[k]
                clipped[k] = torch.where(norm < CLIP_NORM, g,
                                         g / norm * CLIP_NORM)
        for k, g in clipped.items():
            self.mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu.get(
                k, torch.zeros_like(g))
            self.nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * self.nu.get(
                k, torch.zeros_like(g))
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + ADAM_EPS)
            p[k].sub_(lr * u)
        return clipped


@_no_tf32()
def train(p0: Dict[str, torch.Tensor], batches, noises, config, lam: float,
          lr: float, product: str = "float32", grad_steps=(1,),
          spans=None) -> Dict[str, object]:
    """Follow the train step from ``p0`` over ``batches`` with ``noises``
    (NHWC tensors).  Returns each step's loss, for each step of
    ``grad_steps`` (counted from 1) the norm a leaf of its clipped
    gradient, and for each ``(a, b)`` of ``spans`` (default: the whole
    run) the norm a leaf of the parameters' change from after step ``a``
    to after step ``b``."""
    spans = spans or ((0, len(batches)),)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    names = sorted(p)
    opt = Adam(names)
    marks = {0: {k: v.detach().clone() for k, v in p0.items()}}
    wanted = {i for span in spans for i in span}
    losses, grads_at = [], {}
    for i, (x, noise) in enumerate(zip(batches, noises), 1):
        loss, total = rate_mse_loss(p, x, noise, config, lam, product)
        grads = torch.autograd.grad(total, [p[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(p[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        clipped = opt.step(p, grads, lr)
        losses.append(float(loss.detach()))
        if i in grad_steps:
            grads_at[i] = {k: float(torch.linalg.vector_norm(g.double()))
                           for k, g in clipped.items()}
        if i in wanted:
            marks[i] = {k: p[k].detach().clone() for k in names}
        del loss, total, grads, clipped
    changes = [{k: float(torch.linalg.vector_norm(
        (marks[b][k] - marks[a][k]).double())) for k in names}
        for a, b in spans]
    return {"losses": losses, "grads": grads_at, "changes": changes}


def flat_params(tree, device) -> Dict[str, torch.Tensor]:
    """A checkpoint's variable trees as ``{"module/unit/layer/name":
    float32 tensor}`` on ``device`` (the ``params`` level dropped)."""
    out = {}
    for module in ("encoder", "decoder", "fact_ent"):
        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + [k])
                else:
                    t = v if torch.is_tensor(v) else torch.from_numpy(
                        np.asarray(v))
                    out["/".join(path + [k])] = t.to(device, torch.float32)
        walk(tree[module]["params"], [module])
    return out
