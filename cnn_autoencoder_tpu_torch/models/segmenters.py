"""Segmentation heads: UNet (with its own analysis track, or decoder-only)
and JNet, the port of the JAX package's ``models/segmenters.py``.

``UNet`` concatenates its bridges to the synthesis features; ``JNet`` is
the decoder-only U-Net whose bottleneck takes the CAE latent through a 1x1
conv and whose bridges, when ``concat_bridges``, are the CAE decoder's
features ``fx_brg`` (through a projection unit each).  Per-channel
GroupNorm (eps 1e-5) stands for batch norm when ``batch_norm``.  The 2x2
stride-2 transposed convolutions are ``models/layers.py:
ConvTranspose2x2`` (one product and an interleave, a fixed order of sums).
NHWC, float32 in both compute modes, as the classifiers
(``models/classifiers.py``); ``channels_in`` is the width the head is
given (the latent's for JNet, the image's for UNet by default).
``forward(x, fx_brg=None, train=False, batch_stats=None)`` returns
``(logits, None)``.
"""

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import Conv, ConvTranspose2x2, GroupNorm, max_pool, widen


def _gn(unit: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    norm = getattr(unit, name, None)
    return x if norm is None else norm(x)


class _ConvPair(nn.Module):
    """c1 (``k1`` x ``k1``) + norm + ReLU + c2 (3x3) + norm + ReLU."""

    def __init__(self, cin: int, cout: int, batch_norm: bool,
                 kernel_size: int = 3, k1: int = 3):
        super().__init__()
        self.c1 = Conv(cin, cout, k1, padding=k1 // 2, use_bias=False)
        self.c2 = Conv(cout, cout, kernel_size, padding=kernel_size // 2,
                       use_bias=False)
        if batch_norm:
            self.bn1 = GroupNorm(cout)
            self.bn2 = GroupNorm(cout)

    def pair(self, x: torch.Tensor) -> torch.Tensor:
        fx = F.relu(_gn(self, "bn1", self.c1(x)))
        return F.relu(_gn(self, "bn2", self.c2(fx)))


class ProjectionUnit(nn.Module):
    """Bridge projection: GN + ReLU + conv3x3 + GN + ReLU."""

    def __init__(self, cin: int, channels_out: int, kernel_size: int = 3,
                 batch_norm: bool = True):
        super().__init__()
        if batch_norm:
            self.bn1 = GroupNorm(cin)
            self.bn2 = GroupNorm(channels_out)
        self.c2 = Conv(cin, channels_out, kernel_size,
                       padding=kernel_size // 2, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fx = F.relu(_gn(self, "bn1", x))
        return F.relu(_gn(self, "bn2", self.c2(fx)))


class SegDownsamplingUnit(_ConvPair):

    def __init__(self, cin: int, channels_out: int, kernel_size: int = 3,
                 batch_norm: bool = True, downsample: bool = True):
        super().__init__(cin, channels_out, batch_norm, kernel_size,
                         kernel_size)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = max_pool(x, 2, 2)
        return self.pair(x)


class SegUpsamplingUnit(_ConvPair):

    def __init__(self, cin: int, channels_unit: int, channels_out: int,
                 kernel_size: int = 3, batch_norm: bool = True,
                 upsample: bool = True):
        super().__init__(cin, channels_unit, batch_norm, kernel_size,
                         kernel_size)
        if upsample:
            self.up = ConvTranspose2x2(channels_unit, channels_out)
        self.upsample = upsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fx = self.pair(x)
        return self.up(fx) if self.upsample else fx


class BottleneckUnit(_ConvPair):

    def __init__(self, cin: int, channels_out: int, channels_up: int,
                 kernel_size: int = 3, batch_norm: bool = True,
                 downsample: bool = True, conv1_kernel: int = 3):
        super().__init__(cin, channels_out, batch_norm, kernel_size,
                         conv1_kernel)
        self.up = ConvTranspose2x2(channels_out, channels_up)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = max_pool(x, 2, 2)
        return self.up(self.pair(x))


class UNet(nn.Module):
    """U-Net with an optional analysis track of its own and concatenated
    bridges (JAX ``models/segmenters.py:126``)."""

    def __init__(self, channels_org: int = 3, channels_net: int = 64,
                 channels_bn: int = 320, seg_channels_net: int = 64,
                 seg_channels_bn: int = 1024,
                 seg_channels_expansion: int = 2,
                 channels_expansion: int = 1, compression_level: int = 4,
                 num_classes: int = 1, use_analysis_track: bool = True,
                 concat_bridges: bool = True, batch_norm: bool = True,
                 bottleneck_from_latent: bool = False,
                 channels_in: Optional[int] = None, **_):
        super().__init__()
        level = compression_level
        snet, sexp = seg_channels_net, seg_channels_expansion
        self.level, self.use_analysis_track = level, use_analysis_track
        self.concat_bridges = concat_bridges
        if channels_in is None:
            channels_in = channels_org if use_analysis_track else channels_bn

        cin = channels_in
        if use_analysis_track:
            for i in range(level):
                cout = int(snet * sexp ** i)
                setattr(self, f"analysis_{i}", SegDownsamplingUnit(
                    cin, cout, batch_norm=batch_norm, downsample=i > 0))
                cin = cout
            bridge_channels = [int(snet * sexp ** c)
                               for c in reversed(range(level))]
            decoder_channels = [None] * level
        else:
            decoder_channels = [channels_net * channels_expansion ** c
                                for c in range(level - 1)]
            decoder_channels += [channels_org]
            bridge_channels = decoder_channels

        cup = int(snet * sexp ** (level - 1))
        self.bottleneck = BottleneckUnit(
            cin, seg_channels_bn, cup, batch_norm=batch_norm,
            downsample=not bottleneck_from_latent,
            conv1_kernel=1 if bottleneck_from_latent else 3)
        cin = cup

        ch_in_list = [int(snet * sexp ** c) for c in reversed(range(level))]
        ch_out_list = [int(snet * sexp ** (c - 1))
                       for c in reversed(range(level))]
        for i, (dch, ch_in, ch_out) in enumerate(
                zip(decoder_channels, ch_in_list, ch_out_list)):
            if concat_bridges:
                brg = bridge_channels[i]
                if dch is not None:
                    setattr(self, f"bridge_proj_{i}", ProjectionUnit(
                        dch, ch_in, batch_norm=batch_norm))
                    brg = ch_in
                cin += brg
            up = i < level - 1
            setattr(self, f"synthesis_{i}", SegUpsamplingUnit(
                cin, ch_in, ch_out, batch_norm=batch_norm, upsample=up))
            cin = ch_out if up else ch_in
        self.fc = Conv(cin, num_classes, 1)

    def forward(self, x: torch.Tensor,
                fx_brg: Optional[List[torch.Tensor]] = None,
                train: bool = False, batch_stats=None):
        del train, batch_stats  # no batch norm, no dropout
        fx = widen(x)
        if self.use_analysis_track:
            fx_brg = []
            for i in range(self.level):
                fx = getattr(self, f"analysis_{i}")(fx)
                fx_brg.insert(0, fx)
        fx = self.bottleneck(fx)
        for i in range(self.level):
            if self.concat_bridges:
                brg = widen(fx_brg[i])
                proj = getattr(self, f"bridge_proj_{i}", None)
                if proj is not None:
                    brg = proj(brg)
                fx = torch.cat([brg, fx], dim=-1)
            fx = getattr(self, f"synthesis_{i}")(fx)
        return self.fc(fx), None


def JNet(channels_org=3, channels_net=64, channels_bn=320,
         seg_channels_net=64, seg_channels_bn=1024,
         seg_channels_expansion=2, channels_expansion=1,
         compression_level=4, num_classes=1, concat_bridges=False,
         batch_norm=True, channels_in=None, **kwargs) -> UNet:
    """Decoder-only U-Net over the CAE latent (JAX
    ``models/segmenters.py:191``): the bottleneck is a 1x1 conv from
    ``channels_bn``, the bridges the CAE decoder's ``fx_brg``."""
    del kwargs
    return UNet(channels_org=channels_org, channels_net=channels_net,
                channels_bn=channels_bn, seg_channels_net=seg_channels_net,
                seg_channels_bn=seg_channels_bn,
                seg_channels_expansion=seg_channels_expansion,
                channels_expansion=channels_expansion,
                compression_level=compression_level,
                num_classes=num_classes, use_analysis_track=False,
                concat_bridges=concat_bridges, batch_norm=batch_norm,
                bottleneck_from_latent=True, channels_in=channels_in)


_UNET_KEYS = ("channels_org", "channels_net", "channels_bn",
              "seg_channels_net", "seg_channels_bn", "seg_channels_expansion",
              "channels_expansion", "compression_level", "num_classes",
              "use_analysis_track", "concat_bridges", "batch_norm",
              "bottleneck_from_latent", "channels_in")

SEG_MODELS = {
    "UNet": lambda **kw: UNet(**{k: v for k, v in kw.items()
                                 if k in _UNET_KEYS}),
    "JNet": JNet,
}


def segmenter_from_state_dict(checkpoint, train: bool = False, device=None,
                              **_):
    """A segmenter built from a checkpoint's config with its saved weights
    (JAX ``models/segmenters.py:210``); its first layer's width comes from
    the saved weights.  The head is returned on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    from ..training.checkpoint import load_checkpoint
    from ..utils.weights import head_from_jax
    from .classifiers import head_input_shape
    state = load_checkpoint(checkpoint)
    seg_type = state.get("seg_model_type") or state.get("segment_model_type")
    if seg_type not in SEG_MODELS:
        raise ValueError(f"unknown segmenter {seg_type!r}")
    saved = state.get("seg_model")
    module = SEG_MODELS[seg_type](
        channels_org=state.get("channels_org", 3),
        channels_net=state.get("channels_net", 64),
        channels_bn=state.get("channels_bn", 320),
        seg_channels_net=state.get("seg_channels_net", 64),
        seg_channels_bn=state.get("seg_channels_bn", 1024),
        seg_channels_expansion=state.get("seg_channels_expansion", 2),
        channels_expansion=state.get("channels_expansion", 1),
        compression_level=state.get("compression_level", 4),
        num_classes=state.get("num_classes", 1) or 1,
        batch_norm=bool(state.get("batch_norm", True)),
        **head_input_shape(saved, seg_type))
    if saved is not None:
        module.load_state_dict(head_from_jax(saved))
    return module.to(dev).train(train)
