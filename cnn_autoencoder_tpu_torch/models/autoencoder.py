"""Analyzer and Synthesizer of the CAE, on NHWC tensors.

Same stage and channel arithmetic, reflect padding and activation placement
as the JAX package's ``models/autoencoder.py``, with its parameter names
(``down_i/conv_down``, ``down_i/gdn_down``, ``up_i/deconv_up``,
``up_i/gdn_up``, ``conv_pre``/``deconv_pre`` for elementwise activations;
the residual units' ``res_conv1``, ``res_conv2``, ``res_deconv1``,
``res_deconv2`` and ``gdn_res``; batch norms ``norm_pre``, ``norm_down``,
``norm_up``, ``res_norm1`` and ``res_norm2``), so ``utils.weights`` maps
checkpoints one to one.

Every option of the JAX package's units is ported: activations None, GDN,
ReLU and LeakyReLU; plain and residual units (``use_residual``); batch norm
(``ops/batchnorm.py``); channel dropout (``ops/dropout.py``); grouped
convolutions (``groups``: each unit's convolutions take as many groups as
the unit has input channels); and the Synthesizer's multiscale color layers
(``color_i``).

A plain downsampling unit with GDN, no bias, no batch norm, no groups, k=3
and at least 64 input channels runs the fused conv+GDN kernel when H and W
are even (the JAX package's gate at ``models/autoencoder.py:73-77``), in
the mode that computes the JAX package's function now
(``conv_gdn_kernel.conv_gdn_mode``: its default route, which is unfused
there, or under ``CAE_TPU_PALLAS=1`` its Pallas kernel's); the other GDN
stages, every residual unit (the JAX package has no fused branch there),
and the bf16 mode under ``CAE_TPU_GDN_FAST=0``, run the convolution and
the GDN kernel.  The fused kernel takes any number of channels.

Under the model mesh axis (``parallel/mesh.py:shard_model``) every unit
runs as it is: each convolution with a sharded kernel is column-parallel
(``ops/convops.py``; a grouped one on its rank's whole groups), each GDN
gathers its parameters (``ops/gdn.py``), each batch norm its ``scale``
and ``bias`` and records its rank's slice of the running statistics
(``ops/batchnorm.py``), dropout takes the global draw's full-channel
masks, the same on every rank of a model group, and the fused stage takes
the gathered conv kernel, ``gamma`` and ``beta`` (``kernel_hwio``,
``effective_params``) and launches K4 on the rank's rows as one process
does.

Training and serving run the same modules.  Each ``forward`` takes, as the
JAX package's ``__call__`` does, an explicit ``train`` (default False) that
switches batch norm and dropout only: train mode normalizes by the batch's
statistics and records the new running values in ``batch_stats`` (a dict
the caller folds in), and drops channels by the keep-masks in ``masks``
(one per unit with dropout, drawn by ``draw_masks`` before the forward).
``nn.Module.train()`` changes nothing here.  The compute type follows the
input (float32, or bf16 activations end to end); ``compute_dtype`` names
the mode where a batch norm's float32 output meets the bf16 mode's layers
(``ops/convops.py``, ``ops/gdn.py``), and where a gradient is wanted the
fused stage takes its training variant.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batchnorm import BatchNorm
from ..ops.convops import Conv2dReflect, ConvTranspose2dTorch
from ..ops.dropout import Dropout
from ..ops.gdn import GDN
from ..ops.kernels.conv_gdn_kernel import conv_gdn_mode, fused_conv_gdn

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


class _Unit(nn.Module):
    """What the four units share: the activation, the optional batch norms
    and dropout, and the keyword arguments of their forwards."""

    def __init__(self, channels_in: int, channels_out: int, groups: bool,
                 batch_norm: bool, dropout: float,
                 act_layer_type: Optional[str]):
        super().__init__()
        if act_layer_type not in ACT_TYPES:
            raise ValueError(f"Activation layer {act_layer_type} not "
                             "supported")
        self.act = act_layer_type
        self.batch_norm = batch_norm
        # groups=True gives each convolution as many groups as the unit has
        # input channels (the JAX package's g_in)
        self.g = channels_in if groups else 1
        self.drop = Dropout(dropout, channels_out) if dropout > 0.0 else None

    def _norm(self, name: str, x: torch.Tensor, train: bool,
              batch_stats) -> torch.Tensor:
        if not self.batch_norm:
            return x
        return getattr(self, name)(x, train, batch_stats)

    def _gdn_or_act(self, name: str, x: torch.Tensor,
                    compute_dtype) -> torch.Tensor:
        if self.act == "GDN":
            return getattr(self, name)(x, compute_dtype)
        return _act_fn(self.act, x)

    def _dropout(self, x: torch.Tensor, mask, train: bool) -> torch.Tensor:
        return x if self.drop is None else self.drop(x, mask, train)


class DownsamplingUnit(_Unit):

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, use_bias: bool = False,
                 act_layer_type: Optional[str] = None, groups: bool = False,
                 batch_norm: bool = False, dropout: float = 0.0):
        super().__init__(channels_in, channels_out, groups, batch_norm,
                         dropout, act_layer_type)
        if _has_pre_block(act_layer_type):
            self.conv_pre = Conv2dReflect(channels_in, channels_in,
                                          kernel_size, 1, use_bias, self.g)
            if batch_norm:
                self.norm_pre = BatchNorm(channels_in)
        self.conv_down = Conv2dReflect(channels_in, channels_out,
                                       kernel_size, 2, use_bias, self.g)
        if batch_norm:
            self.norm_down = BatchNorm(channels_out)
        if act_layer_type == "GDN":
            self.gdn_down = GDN(channels_out, inverse=False)
        self.fused = (act_layer_type == "GDN" and not use_bias
                      and not batch_norm and self.g == 1
                      and kernel_size == 3 and channels_in >= 64)

    def forward(self, x: torch.Tensor, train: bool = False,
                compute_dtype=None, mask=None,
                batch_stats=None) -> torch.Tensor:
        if _has_pre_block(self.act):
            x = self._norm("norm_pre", self.conv_pre(x, compute_dtype),
                           train, batch_stats)
            x = _act_fn(self.act, x)
        mode = (conv_gdn_mode(x.dtype, compute_dtype) if self.fused
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0 else None)
        if mode is not None:
            gamma, beta = self.gdn_down.effective_params()
            x = fused_conv_gdn(x.contiguous(), self.conv_down.kernel_hwio(),
                               gamma, beta, mode, compute_dtype)
        else:
            x = self._norm("norm_down", self.conv_down(x, compute_dtype),
                           train, batch_stats)
            x = self._gdn_or_act("gdn_down", x, compute_dtype)
        return self._dropout(x, mask, train)


class ResidualDownsamplingUnit(_Unit):
    """The JAX package's ``ResidualDownsamplingUnit``: a stride-1 residual
    branch (``res_conv1``, its norm, GDN or the activation, and for
    elementwise activations ``res_conv2`` and its norm) added to the input,
    then the strided ``conv_down`` stage as in the plain unit."""

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, use_bias: bool = False,
                 act_layer_type: Optional[str] = None, groups: bool = False,
                 batch_norm: bool = False, dropout: float = 0.0):
        super().__init__(channels_in, channels_out, groups, batch_norm,
                         dropout, act_layer_type)
        k, g = kernel_size, self.g
        self.res_conv1 = Conv2dReflect(channels_in, channels_in, k, 1,
                                       use_bias, g)
        if batch_norm:
            self.res_norm1 = BatchNorm(channels_in)
        if act_layer_type == "GDN":
            self.gdn_res = GDN(channels_in, inverse=False)
        if _has_pre_block(act_layer_type):
            self.res_conv2 = Conv2dReflect(channels_in, channels_in, k, 1,
                                           use_bias, g)
            if batch_norm:
                self.res_norm2 = BatchNorm(channels_in)
        self.conv_down = Conv2dReflect(channels_in, channels_out, k, 2,
                                       use_bias, g)
        if batch_norm:
            self.norm_down = BatchNorm(channels_out)
        if act_layer_type == "GDN":
            self.gdn_down = GDN(channels_out, inverse=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                compute_dtype=None, mask=None,
                batch_stats=None) -> torch.Tensor:
        fx = self._norm("res_norm1", self.res_conv1(x, compute_dtype), train,
                        batch_stats)
        fx = self._gdn_or_act("gdn_res", fx, compute_dtype)
        if _has_pre_block(self.act):
            fx = self._norm("res_norm2", self.res_conv2(fx, compute_dtype),
                            train, batch_stats)
        fx = fx + x
        if _has_pre_block(self.act):
            fx = _act_fn(self.act, fx)
        fx = self._norm("norm_down", self.conv_down(fx, compute_dtype),
                        train, batch_stats)
        fx = self._gdn_or_act("gdn_down", fx, compute_dtype)
        return self._dropout(fx, mask, train)


class UpsamplingUnit(_Unit):

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, use_bias: bool = True,
                 act_layer_type: Optional[str] = None, groups: bool = False,
                 batch_norm: bool = False, dropout: float = 0.0):
        super().__init__(channels_in, channels_out, groups, batch_norm,
                         dropout, act_layer_type)
        k, g = kernel_size, self.g
        if _has_pre_block(act_layer_type):
            self.deconv_pre = ConvTranspose2dTorch(
                channels_in, channels_in, k, 1, k // 2, 0, use_bias, g)
            if batch_norm:
                self.norm_pre = BatchNorm(channels_in)
        self.deconv_up = ConvTranspose2dTorch(channels_in, channels_out, k, 2,
                                              k // 2, 1, use_bias, g)
        if batch_norm:
            self.norm_up = BatchNorm(channels_out)
        if act_layer_type == "GDN":
            self.gdn_up = GDN(channels_out, inverse=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                compute_dtype=None, mask=None,
                batch_stats=None) -> torch.Tensor:
        if _has_pre_block(self.act):
            x = self._norm("norm_pre", self.deconv_pre(x, compute_dtype),
                           train, batch_stats)
            x = _act_fn(self.act, x)
        x = self._norm("norm_up", self.deconv_up(x, compute_dtype), train,
                       batch_stats)
        x = self._gdn_or_act("gdn_up", x, compute_dtype)
        return self._dropout(x, mask, train)


class ResidualUpsamplingUnit(_Unit):
    """The JAX package's ``ResidualUpsamplingUnit``: a stride-1 transposed
    residual branch (``res_deconv1``, its norm, IGDN or the activation, and
    for elementwise activations ``res_deconv2``, its norm and the
    activation) added to the input, then the ``deconv_up`` stage as in the
    plain unit."""

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, use_bias: bool = True,
                 act_layer_type: Optional[str] = None, groups: bool = False,
                 batch_norm: bool = False, dropout: float = 0.0):
        super().__init__(channels_in, channels_out, groups, batch_norm,
                         dropout, act_layer_type)
        k, g = kernel_size, self.g
        self.res_deconv1 = ConvTranspose2dTorch(channels_in, channels_in, k,
                                                1, k // 2, 0, use_bias, g)
        if batch_norm:
            self.res_norm1 = BatchNorm(channels_in)
        if act_layer_type == "GDN":
            self.gdn_res = GDN(channels_in, inverse=True)
        if _has_pre_block(act_layer_type):
            self.res_deconv2 = ConvTranspose2dTorch(
                channels_in, channels_in, k, 1, k // 2, 0, use_bias, g)
            if batch_norm:
                self.res_norm2 = BatchNorm(channels_in)
        self.deconv_up = ConvTranspose2dTorch(channels_in, channels_out, k, 2,
                                              k // 2, 1, use_bias, g)
        if batch_norm:
            self.norm_up = BatchNorm(channels_out)
        if act_layer_type == "GDN":
            self.gdn_up = GDN(channels_out, inverse=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                compute_dtype=None, mask=None,
                batch_stats=None) -> torch.Tensor:
        fx = self._norm("res_norm1", self.res_deconv1(x, compute_dtype),
                        train, batch_stats)
        fx = self._gdn_or_act("gdn_res", fx, compute_dtype)
        if _has_pre_block(self.act):
            fx = self._norm("res_norm2", self.res_deconv2(fx, compute_dtype),
                            train, batch_stats)
            fx = _act_fn(self.act, fx)
        fx = fx + x
        if _has_pre_block(self.act):
            fx = _act_fn(self.act, fx)
        fx = self._norm("norm_up", self.deconv_up(fx, compute_dtype), train,
                        batch_stats)
        fx = self._gdn_or_act("gdn_up", fx, compute_dtype)
        return self._dropout(fx, mask, train)


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


class _Track(nn.Module):
    """The stages of an Analyzer or a Synthesizer: units ``<prefix>_i``,
    plain or residual, with the options every unit takes."""

    def _add_units(self, prefix: str, stages, kernel_size: int,
                   use_bias: bool, act_layer_type: Optional[str],
                   use_residual: bool, groups: bool, batch_norm: bool,
                   dropout: float, plain, residual) -> None:
        unit = residual if use_residual else plain
        self.names: List[str] = []
        for i, (cin, cout, act) in enumerate(stages):
            self.add_module(f"{prefix}_{i}", unit(
                cin, cout, kernel_size, use_bias,
                act_layer_type if act else None, groups, batch_norm,
                float(dropout or 0.0)))
            self.names.append(f"{prefix}_{i}")

    def draw_masks(self, batch: int,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Dict[str, torch.Tensor]:
        """A train-mode forward's dropout keep-masks, ``{unit: (batch,
        channels) bool}``, drawn from ``generator`` unit by unit in stage
        order; empty without dropout."""
        return {name: getattr(self, name).drop.draw(batch, generator, device)
                for name in self.names
                if getattr(self, name).drop is not None}

    def _unit(self, i: int, x: torch.Tensor, train: bool, compute_dtype,
              masks, batch_stats) -> torch.Tensor:
        name = self.names[i]
        return getattr(self, name)(x, train, compute_dtype,
                                   (masks or {}).get(name), batch_stats)


class Analyzer(_Track):
    """Encoder: ``compression_level`` stride-2 stages, pixels -> latent y
    (NHWC in, NHWC out)."""

    def __init__(self, channels_org: int = 3, channels_net: int = 8,
                 channels_bn: int = 16, compression_level: int = 3,
                 channels_expansion: int = 1, kernel_size: int = 3,
                 use_bias: bool = False,
                 act_layer_type: Optional[str] = None,
                 use_residual: bool = False, groups: bool = False,
                 batch_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        stages = _analyzer_stage_channels(channels_org, channels_net,
                                          channels_bn, compression_level,
                                          channels_expansion)
        self._add_units("down", stages, kernel_size, use_bias,
                        act_layer_type, use_residual, groups, batch_norm,
                        dropout, DownsamplingUnit, ResidualDownsamplingUnit)

    def forward(self, x: torch.Tensor, train: bool = False,
                compute_dtype=None, masks=None,
                batch_stats=None) -> torch.Tensor:
        for i in range(len(self.names)):
            x = self._unit(i, x, train, compute_dtype, masks, batch_stats)
        return x


class Synthesizer(_Track):
    """Decoder: latent -> reconstruction pyramid (NHWC), the JAX package's
    ``models/autoencoder.py:295-352``.

    Returns ``(x_r, fx_brg)`` like the JAX package: ``x_r`` is finest
    first, ``x_r[0]`` the full-resolution reconstruction; with
    ``multiscale_analysis`` each coarser entry is the color layer
    ``color_i`` (a reflect-padded stride-1 conv to ``channels_org``, in
    ``channels_org`` groups with ``groups``) of stage i's output, else
    None.  ``fx_brg`` holds the per-stage features.  A color layer takes
    its stage's width, which flax infers in the JAX package; at
    channels_expansion 1 that is its ``color_channels`` (``:328-330``).
    With ``groups`` the last stage's ``channels_org`` outputs must be a
    multiple of its input width, as in the JAX package."""

    def __init__(self, channels_org: int = 3, channels_net: int = 8,
                 channels_bn: int = 16, compression_level: int = 3,
                 channels_expansion: int = 1, kernel_size: int = 3,
                 use_bias: bool = False,
                 act_layer_type: Optional[str] = None,
                 multiscale_analysis: bool = False,
                 use_residual: bool = False, groups: bool = False,
                 batch_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        stages = _synthesizer_stage_channels(channels_org, channels_net,
                                             channels_bn, compression_level,
                                             channels_expansion)
        self._add_units("up", stages, kernel_size, use_bias, act_layer_type,
                        use_residual, groups, batch_norm, dropout,
                        UpsamplingUnit, ResidualUpsamplingUnit)
        for i, (_, cout, _) in enumerate(stages[:-1]):
            if multiscale_analysis:
                self.add_module(f"color_{i}", Conv2dReflect(
                    cout, channels_org, kernel_size, 1, use_bias,
                    channels_org if groups else 1))
        self.multiscale_analysis = multiscale_analysis

    def forward(self, x: torch.Tensor, train: bool = False,
                compute_dtype=None, masks=None, batch_stats=None
                ) -> Tuple[List[Optional[torch.Tensor]], List[torch.Tensor]]:
        x_r: List[Optional[torch.Tensor]] = []
        fx_brg: List[torch.Tensor] = []
        for i in range(len(self.names)):
            x = self._unit(i, x, train, compute_dtype, masks, batch_stats)
            if i == len(self.names) - 1:
                x_r_i = x
            elif self.multiscale_analysis:
                x_r_i = getattr(self, f"color_{i}")(x, compute_dtype)
            else:
                x_r_i = None
            x_r.insert(0, x_r_i)
            fx_brg.append(x)
        return x_r, fx_brg
