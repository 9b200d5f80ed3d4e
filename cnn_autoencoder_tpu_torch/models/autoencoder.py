"""Analyzer and Synthesizer of the CAE, on NHWC tensors.

Same stage and channel arithmetic, reflect padding and activation placement
as the JAX package's ``models/autoencoder.py``, with its parameter names
(``down_i/conv_down``, ``down_i/gdn_down``, ``up_i/deconv_up``,
``up_i/gdn_up``, and ``conv_pre``/``deconv_pre`` for elementwise
activations), so ``utils.weights`` maps checkpoints one to one.

Ported: plain down/up units with activations None, GDN, ReLU and LeakyReLU.
Residual units, batch norm, dropout and multiscale color layers wait for
later slices; asking for them raises.

A downsampling unit with GDN, no bias, k=3 and at least 64 input channels
runs the fused conv+GDN kernel when H and W are even (the JAX package's gate
at ``models/autoencoder.py:73-77``); the other GDN stages run the
convolution and the GDN kernel.  The fused kernel takes any number of
channels.

Training and serving run the same modules.  The compute type follows the
input (float32, or bf16 activations end to end), and where a gradient is
wanted the fused stage takes its training variant; the JAX package's
``train`` flag switches only batch norm and dropout, which are not ported
and raise, so in the port it is ``nn.Module.train()`` and changes nothing
here.
"""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convops import Conv2dReflect, ConvTranspose2dTorch
from ..ops.gdn import GDN
from ..ops.kernels.conv_gdn_kernel import fused_conv_gdn

ACT_TYPES = (None, "Identity", "LeakyReLU", "ReLU", "GDN")


def _act_fn(act: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if act in (None, "Identity"):
        return x
    if act == "LeakyReLU":
        return F.leaky_relu(x, negative_slope=0.01)
    if act == "ReLU":
        return F.relu(x)
    raise ValueError(f"Activation layer {act} not supported")


def _has_pre_block(act: Optional[str]) -> bool:
    # the reference adds the stride-1 pre-conv only for elementwise
    # activations (not for None/GDN)
    return act is not None and act != "GDN"


class DownsamplingUnit(nn.Module):

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, use_bias: bool = False,
                 act_layer_type: Optional[str] = None):
        super().__init__()
        if act_layer_type not in ACT_TYPES:
            raise ValueError(f"Activation layer {act_layer_type} not "
                             "supported")
        self.act = act_layer_type
        if _has_pre_block(act_layer_type):
            self.conv_pre = Conv2dReflect(channels_in, channels_in,
                                          kernel_size, 1, use_bias)
        self.conv_down = Conv2dReflect(channels_in, channels_out,
                                       kernel_size, 2, use_bias)
        if act_layer_type == "GDN":
            self.gdn_down = GDN(channels_out, inverse=False)
        self.fused = (act_layer_type == "GDN" and not use_bias
                      and kernel_size == 3 and channels_in >= 64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _has_pre_block(self.act):
            x = _act_fn(self.act, self.conv_pre(x))
        if self.fused and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            gamma, beta = self.gdn_down.effective_params()
            return fused_conv_gdn(x.contiguous(), self.conv_down.kernel_hwio(),
                                  gamma, beta)
        x = self.conv_down(x)
        if self.act == "GDN":
            return self.gdn_down(x)
        return _act_fn(self.act, x)


class UpsamplingUnit(nn.Module):

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, use_bias: bool = True,
                 act_layer_type: Optional[str] = None):
        super().__init__()
        if act_layer_type not in ACT_TYPES:
            raise ValueError(f"Activation layer {act_layer_type} not "
                             "supported")
        k = kernel_size
        self.act = act_layer_type
        if _has_pre_block(act_layer_type):
            self.deconv_pre = ConvTranspose2dTorch(channels_in, channels_in,
                                                   k, 1, k // 2, 0, use_bias)
        self.deconv_up = ConvTranspose2dTorch(channels_in, channels_out, k, 2,
                                              k // 2, 1, use_bias)
        if act_layer_type == "GDN":
            self.gdn_up = GDN(channels_out, inverse=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _has_pre_block(self.act):
            x = _act_fn(self.act, self.deconv_pre(x))
        x = self.deconv_up(x)
        if self.act == "GDN":
            return self.gdn_up(x)
        return _act_fn(self.act, x)


def _analyzer_stage_channels(channels_org, channels_net, channels_bn,
                             compression_level, channels_expansion):
    """(in, out, act?) per stage."""
    stages = []
    prev, curr = channels_org, channels_net
    for _ in range(compression_level - 1):
        stages.append((prev, curr, True))
        prev, curr = curr, curr * channels_expansion
    if compression_level > 0:
        stages.append((prev, channels_bn, False))
    return stages


def _synthesizer_stage_channels(channels_org, channels_net, channels_bn,
                                compression_level, channels_expansion):
    """(in, out, act?) per stage."""
    stages = []
    prev = channels_bn
    curr = channels_net * channels_expansion ** compression_level
    for _ in range(compression_level - 1):
        stages.append((prev, curr, True))
        prev, curr = curr, curr // channels_expansion
    if compression_level > 0:
        stages.append((prev, channels_org, False))
    return stages


class Analyzer(nn.Module):
    """Encoder: ``compression_level`` stride-2 stages, pixels -> latent y
    (NHWC in, NHWC out)."""

    def __init__(self, channels_org: int = 3, channels_net: int = 8,
                 channels_bn: int = 16, compression_level: int = 3,
                 channels_expansion: int = 1, kernel_size: int = 3,
                 use_bias: bool = False,
                 act_layer_type: Optional[str] = None):
        super().__init__()
        stages = _analyzer_stage_channels(channels_org, channels_net,
                                          channels_bn, compression_level,
                                          channels_expansion)
        self.names: List[str] = []
        for i, (cin, cout, act) in enumerate(stages):
            self.add_module(f"down_{i}", DownsamplingUnit(
                cin, cout, kernel_size, use_bias,
                act_layer_type if act else None))
            self.names.append(f"down_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class Synthesizer(nn.Module):
    """Decoder: latent -> full-resolution reconstruction (NHWC).

    Returns ``(x_r, fx_brg)`` like the JAX package: ``x_r[0]`` is the
    reconstruction (coarser entries are None without color layers) and
    ``fx_brg`` the per-stage features."""

    def __init__(self, channels_org: int = 3, channels_net: int = 8,
                 channels_bn: int = 16, compression_level: int = 3,
                 channels_expansion: int = 1, kernel_size: int = 3,
                 use_bias: bool = False,
                 act_layer_type: Optional[str] = None):
        super().__init__()
        stages = _synthesizer_stage_channels(channels_org, channels_net,
                                             channels_bn, compression_level,
                                             channels_expansion)
        self.names: List[str] = []
        for i, (cin, cout, act) in enumerate(stages):
            self.add_module(f"up_{i}", UpsamplingUnit(
                cin, cout, kernel_size, use_bias,
                act_layer_type if act else None))
            self.names.append(f"up_{i}")

    def forward(self, x: torch.Tensor
                ) -> Tuple[List[Optional[torch.Tensor]], List[torch.Tensor]]:
        x_r: List[Optional[torch.Tensor]] = []
        fx_brg: List[torch.Tensor] = []
        for i, name in enumerate(self.names):
            x = getattr(self, name)(x)
            x_r.insert(0, x if i == len(self.names) - 1 else None)
            fx_brg.append(x)
        return x_r, fx_brg
