"""Compressed-domain classifier heads: ViT-B/16, ResNet-152 and
Inception-V3, the port of the JAX package's ``models/classifiers.py``.

Each network is cut at ``cut_position`` and re-headed with a 1x1 conv from
the latent's channels, so it takes the quantized latent ``y_q`` itself;
``cut_position == 0`` runs the whole network on pixels.  NHWC, float32:
the heads compute in float32 in both compute modes, as flax's do when the
bf16 mode hands them a bf16 ``y_q`` (their float32 parameters promote it).
Module and parameter names are flax's (``models/layers.py``), so
``utils/weights.py`` maps the JAX package's variables one to one.

PyTorch fixes a layer's input width at construction where flax reads it
from the first input: ``channels_in`` is the width the head is given (the
latent's ``channels_bn`` by default, ``channels_org`` on pixels), and ViT's
``input_size`` the (H, W) its ``pos_embedding`` is sized for (flax sizes it
from the input it is initialised on).

* ViT: LayerNorm eps 1e-6, exact (erf) GELU, flax's
  ``MultiHeadDotProductAttention`` written out in its order (query scaled
  by 1/sqrt(D/H), products, a float32 softmax).
* ResNet: per-channel GroupNorm (eps 1e-5) for batch norm; the stem's max
  pool pads by 1, every other pool is VALID.
* Inception: BatchNorm eps 1e-3, flax momentum 0.9 (``ops/batchnorm.py``);
  the 3x3 average pools count their padding; the input is pre-padded by
  edge replication to the cut's native size; without a cut the cut comes
  from the patch size; the auxiliary logits run in eval mode too, past cut
  4 without ``conv0`` and with a 1x1 ``conv1_override``.

A head's ``forward(x, train=False, batch_stats=None)`` returns ``(logits,
aux logits or None)``; Inception's batch norms record their new running
statistics in ``batch_stats`` in train mode, as the CAE's units do.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batchnorm import BatchNorm
from ..parallel.distributed import full_param
from ..utils.device import full_f32, resolve_device
from .layers import (Conv, Dense, GroupNorm, LayerNorm, avg_pool, dropout,
                     lecun_normal_, max_pool, widen)


# --- ViT ---------------------------------------------------------------------


class DenseGeneral(nn.Module):
    """The attention's projections, flax's ``DenseGeneral`` kernels as
    stored: in (D, H, D/H) (``heads_out``) or out (H, D/H, D)."""

    def __init__(self, shape: Tuple[int, ...], bias_shape: Tuple[int, ...],
                 fan_in: int):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = nn.Parameter(torch.empty(*shape))
        self.bias = nn.Parameter(torch.empty(*bias_shape))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.kernel, self.fan_in, generator)
        with torch.no_grad():
            self.bias.zero_()


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention (no mask, no dropout on the weights)."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        dh = hidden_dim // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((hidden_dim, num_heads, dh),
                                             (num_heads, dh), hidden_dim))
        self.out = DenseGeneral((num_heads, dh, hidden_dim), (hidden_dim,),
                                hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def heads(p):
            return torch.einsum("bld,dhk->blhk", x, p.kernel) + p.bias

        with full_f32():
            q, k, v = heads(self.query), heads(self.key), heads(self.value)
            q = q / float(np.sqrt(np.float32(q.shape[-1])))
            w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", w, v)
            return torch.einsum("blhk,hkd->bld", o, self.out.kernel) \
                + full_param(self.out, "bias")


class MLPBlock(nn.Module):

    def __init__(self, hidden_dim: int, mlp_dim: int, dropout_rate=0.0):
        super().__init__()
        self.rate = dropout_rate
        self.fc1 = Dense(hidden_dim, mlp_dim)
        self.fc2 = Dense(mlp_dim, hidden_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.gelu(self.fc1(x), approximate="none")
        x = dropout(x, self.rate, train)
        return dropout(self.fc2(x), self.rate, train)


class EncoderBlock(nn.Module):

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.rate = dropout_rate
        self.ln_1 = LayerNorm(hidden_dim, 1e-6)
        self.self_attention = MultiHeadDotProductAttention(hidden_dim,
                                                           num_heads)
        self.ln_2 = LayerNorm(hidden_dim, 1e-6)
        self.mlp = MLPBlock(hidden_dim, mlp_dim, dropout_rate)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.self_attention(self.ln_1(x))
        x = x + dropout(h, self.rate, train)
        return x + self.mlp(self.ln_2(x), train)


class ViTClassifierHead(nn.Module):
    """ViT-B/16 cut at ``cut_position`` encoder layers (JAX
    ``models/classifiers.py:57``)."""

    def __init__(self, channels_org: int = 3, channels_bn: int = 768,
                 cut_position: Optional[int] = 6, patch_size: int = 128,
                 compression_level: int = 4, num_classes: int = 1000,
                 dropout: float = 0.0, hidden_dim: int = 768,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 channels_in: Optional[int] = None,
                 input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        cut = 6 if cut_position is None else cut_position
        self.cut, self.rate, self.hidden_dim = cut, dropout, hidden_dim
        if input_size is None:
            side = patch_size // 2 ** compression_level if cut > 0 \
                else patch_size
            input_size = (side, side)
        h, w = input_size
        if cut > 0:
            self.conv_proj = Conv(channels_in or channels_bn, hidden_dim, 1,
                                  use_bias=False)
        else:
            self.conv_proj = Conv(channels_in or channels_org, hidden_dim,
                                  16, 16)
            h, w = -(-h // 16), -(-w // 16)
        self.class_token = nn.Parameter(torch.empty(1, 1, hidden_dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, h * w + 1,
                                                      hidden_dim))
        for i in range(12 - cut):
            setattr(self, f"encoder_layer_{i}",
                    EncoderBlock(hidden_dim, num_heads, mlp_dim, dropout))
        self.num_layers = 12 - cut
        self.ln = LayerNorm(hidden_dim, 1e-6)
        self.head = Dense(hidden_dim, num_classes)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.class_token.zero_()
            self.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                batch_stats=None):
        del batch_stats  # no batch norm
        x = self.conv_proj(widen(x))
        b, h, w, d = x.shape
        tokens = torch.cat([self.class_token.expand(b, 1, d),
                            x.reshape(b, h * w, d)], dim=1)
        tokens = dropout(tokens + self.pos_embedding, self.rate, train)
        for i in range(self.num_layers):
            tokens = getattr(self, f"encoder_layer_{i}")(tokens, train)
        return self.head(self.ln(tokens)[:, 0]), None


# --- ResNet ------------------------------------------------------------------


class GroupNormPerChannel(nn.Module):
    """torch's ``GroupNorm(num_groups=C, num_channels=C)``, as the JAX
    package wraps flax's (``GroupNorm_0`` inside)."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels, 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


class ResNetBottleneck(nn.Module):

    def __init__(self, channels_in: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(channels_in, planes, 1, use_bias=False)
        self.bn1 = GroupNormPerChannel(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, use_bias=False)
        self.bn2 = GroupNormPerChannel(planes)
        self.conv3 = Conv(planes, planes * 4, 1, use_bias=False)
        self.bn3 = GroupNormPerChannel(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(channels_in, planes * 4, 1, stride,
                                        use_bias=False)
            self.downsample_bn = GroupNormPerChannel(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class ResNetClassifierHead(nn.Module):
    """ResNet-152 (GroupNorm) cut at ``cut_position`` (JAX
    ``models/classifiers.py:150``)."""

    def __init__(self, channels_org: int = 3, channels_bn: int = 768,
                 cut_position: Optional[int] = 3, patch_size: int = 128,
                 compression_level: int = 4, num_classes: int = 1000,
                 layers: Sequence[int] = (3, 8, 36, 3),
                 channels_in: Optional[int] = None, **_):
        super().__init__()
        cut = compression_level if cut_position is None else cut_position
        self.cut = cut
        out_channels = [64, 64 * 4, 128 * 4, 256 * 4, 512 * 4]
        if cut > 0:
            self.conv1 = Conv(channels_in or channels_bn,
                              out_channels[cut - 1], 1, use_bias=False)
            cin = out_channels[cut - 1]
        else:
            self.conv1 = Conv(channels_in or channels_org, 64, 7, 2, 3,
                              use_bias=False)
            cin = 64
        self.bn1 = GroupNormPerChannel(cin)
        planes = (64, 128, 256, 512)
        self.blocks = []
        for stage in range(4):
            if cut > stage + 1:
                continue
            stride = 1 if stage == 0 else 2
            for blk in range(layers[stage]):
                name = f"layer{stage + 1}_block{blk}"
                setattr(self, name, ResNetBottleneck(
                    cin, planes[stage], stride if blk == 0 else 1,
                    downsample=blk == 0))
                self.blocks.append(name)
                cin = planes[stage] * 4
        self.fc = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                batch_stats=None):
        del train, batch_stats  # no batch norm, no dropout
        x = F.relu(self.bn1(self.conv1(widen(x))))
        if self.cut == 0:
            x = max_pool(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.fc(x.mean((1, 2))), None


# --- Inception V3 ------------------------------------------------------------


class BasicConv2d(nn.Module):

    def __init__(self, channels_in: int, features: int, kernel,
                 strides=1, padding=0):
        super().__init__()
        self.conv = Conv(channels_in, features, kernel, strides, padding,
                         use_bias=False)
        self.bn = BatchNorm(features, momentum=0.9, epsilon=1e-3)

    def forward(self, x, train=False, batch_stats=None):
        return F.relu(self.bn(self.conv(x), train, batch_stats))


def _avg_pool_3(x: torch.Tensor) -> torch.Tensor:
    # torchvision's F.avg_pool2d(..., padding=1): count_include_pad=True
    return avg_pool(x, 3, 1, 1)


class _Block(nn.Module):
    """Runs named BasicConv2d children with the train flags."""

    def c(self, name, x, train, stats):
        return getattr(self, name)(x, train, stats)


class InceptionA(_Block):

    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)
        self.channels_out = 224 + pool_features

    def forward(self, x, train=False, stats=None):
        c = self.c
        b1 = c("branch1x1", x, train, stats)
        b5 = c("branch5x5_2", c("branch5x5_1", x, train, stats), train, stats)
        b3 = c("branch3x3dbl_1", x, train, stats)
        b3 = c("branch3x3dbl_3", c("branch3x3dbl_2", b3, train, stats),
               train, stats)
        bp = c("branch_pool", _avg_pool_3(x), train, stats)
        return torch.cat([b1, b5, b3, bp], dim=-1)


class InceptionB(_Block):

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, 2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 2)
        self.channels_out = 480 + cin

    def forward(self, x, train=False, stats=None):
        c = self.c
        b3 = c("branch3x3", x, train, stats)
        bd = c("branch3x3dbl_1", x, train, stats)
        bd = c("branch3x3dbl_3", c("branch3x3dbl_2", bd, train, stats),
               train, stats)
        return torch.cat([b3, bd, max_pool(x, 3, 2)], dim=-1)


class InceptionC(_Block):

    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)
        self.channels_out = 768

    def forward(self, x, train=False, stats=None):
        c = self.c
        b1 = c("branch1x1", x, train, stats)
        b7 = x
        for name in ("branch7x7_1", "branch7x7_2", "branch7x7_3"):
            b7 = c(name, b7, train, stats)
        bd = x
        for i in range(1, 6):
            bd = c(f"branch7x7dbl_{i}", bd, train, stats)
        bp = c("branch_pool", _avg_pool_3(x), train, stats)
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(_Block):

    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 2)
        self.channels_out = 512 + cin

    def forward(self, x, train=False, stats=None):
        c = self.c
        b3 = c("branch3x3_2", c("branch3x3_1", x, train, stats), train,
               stats)
        b7 = x
        for i in range(1, 5):
            b7 = c(f"branch7x7x3_{i}", b7, train, stats)
        return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=-1)


class InceptionE(_Block):

    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)
        self.channels_out = 2048

    def forward(self, x, train=False, stats=None):
        c = self.c
        b1 = c("branch1x1", x, train, stats)
        b3 = c("branch3x3_1", x, train, stats)
        b3 = torch.cat([c("branch3x3_2a", b3, train, stats),
                        c("branch3x3_2b", b3, train, stats)], dim=-1)
        bd = c("branch3x3dbl_2", c("branch3x3dbl_1", x, train, stats),
               train, stats)
        bd = torch.cat([c("branch3x3dbl_3a", bd, train, stats),
                        c("branch3x3dbl_3b", bd, train, stats)], dim=-1)
        bp = c("branch_pool", _avg_pool_3(x), train, stats)
        return torch.cat([b1, b3, bd, bp], dim=-1)


class InceptionAux(nn.Module):

    def __init__(self, cin: int, num_classes: int, skip_conv0: bool = False,
                 conv1_in_override: bool = False):
        super().__init__()
        self.skip_conv0 = skip_conv0
        self.conv1_in_override = conv1_in_override
        if not skip_conv0:
            self.conv0 = BasicConv2d(cin, 128, 1)
            cin = 128
        if conv1_in_override:
            self.conv1_override = Conv(cin, 768, 1)
        else:
            self.conv1 = BasicConv2d(cin, 768, 5)
        self.fc = Dense(768, num_classes)

    def forward(self, x, train=False, stats=None):
        x = avg_pool(x, 5, 3)
        if not self.skip_conv0:
            x = self.conv0(x, train, stats)
        if self.conv1_in_override:
            x = self.conv1_override(x)
        else:
            x = self.conv1(x, train, stats)
        return self.fc(x.mean((1, 2)))


IN_SHAPES = (299, 149, 73, 35, 17, 8, 1)


def inception_cut(patch_size: int, compression_level: int) -> int:
    """The cut whose native size is nearest the latent's side."""
    side = patch_size // 2 ** compression_level
    return int(np.argmin([abs(s - side) for s in IN_SHAPES]))


class InceptionV3ClassifierHead(nn.Module):
    """Inception-V3 with auxiliary logits, cut at ``cut_position``, the
    input edge-padded to the cut's native size (JAX
    ``models/classifiers.py:334``)."""

    def __init__(self, channels_org: int = 3, channels_bn: int = 768,
                 cut_position: Optional[int] = 6, patch_size: int = 128,
                 compression_level: int = 4, num_classes: int = 1000,
                 dropout: float = 0.0, channels_in: Optional[int] = None,
                 **_):
        super().__init__()
        out_channels = [32, 64, 192, 768, 1280, 2048]
        cut = (inception_cut(patch_size, compression_level)
               if cut_position is None else cut_position)
        self.cut, self.rate = cut, dropout
        self.stages = []

        def add(name, module):
            setattr(self, name, module)
            self.stages.append(name)
            return getattr(module, "channels_out", None)

        if cut > 0:
            self.Conv2d_1a_1x1 = Conv(channels_in or channels_bn,
                                      out_channels[cut - 1], 1,
                                      use_bias=False)
            cin = out_channels[cut - 1]
        else:
            self.Conv2d_1a_3x3 = BasicConv2d(channels_in or channels_org, 32,
                                             3, 2)
            cin = 32
        if cut <= 1:
            self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
            self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
            cin = 64
        if cut <= 2:
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
            cin = 192
        if cut <= 3:
            cin = add("Mixed_5b", InceptionA(cin, 32))
            cin = add("Mixed_5c", InceptionA(cin, 64))
            cin = add("Mixed_5d", InceptionA(cin, 64))
            cin = add("Mixed_6a", InceptionB(cin))
        if cut <= 4:
            for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160),
                             ("Mixed_6d", 160), ("Mixed_6e", 192)):
                cin = add(name, InceptionC(cin, c7))
        self.n_before_aux = len(self.stages)
        self.AuxLogits = InceptionAux(cin, num_classes, skip_conv0=cut > 4,
                                      conv1_in_override=cut > 4)
        if cut <= 4:
            cin = add("Mixed_7a", InceptionD(cin))
        if cut <= 5:
            cin = add("Mixed_7b", InceptionE(cin))
            cin = add("Mixed_7c", InceptionE(cin))
        self.fc = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                batch_stats=None):
        x, stats = widen(x), batch_stats
        side = x.shape[1]
        pad_lt = max(0, (IN_SHAPES[self.cut] - side) // 2)
        pad_rb = max(0, IN_SHAPES[self.cut] - side - pad_lt)
        if pad_lt > 0 or pad_rb > 0:
            x = F.pad(x.permute(0, 3, 1, 2),
                      (pad_lt, pad_rb, pad_lt, pad_rb),
                      mode="replicate").permute(0, 2, 3, 1)
        if self.cut > 0:
            x = self.Conv2d_1a_1x1(x)
        else:
            x = self.Conv2d_1a_3x3(x, train, stats)
        if self.cut <= 1:
            x = self.Conv2d_2a_3x3(x, train, stats)
            x = max_pool(self.Conv2d_2b_3x3(x, train, stats), 3, 2)
        if self.cut <= 2:
            x = self.Conv2d_3b_1x1(x, train, stats)
            x = max_pool(self.Conv2d_4a_3x3(x, train, stats), 3, 2)
        for name in self.stages[:self.n_before_aux]:
            x = getattr(self, name)(x, train, stats)
        aux = self.AuxLogits(x, train, stats)
        for name in self.stages[self.n_before_aux:]:
            x = getattr(self, name)(x, train, stats)
        x = dropout(x.mean((1, 2)), self.rate, train)
        return self.fc(x), aux


CLASS_MODELS = {
    "ViT": ViTClassifierHead,
    "ResNet": ResNetClassifierHead,
    "InceptionV3": InceptionV3ClassifierHead,
}


def classifier_from_state_dict(checkpoint, train: bool = False, device=None,
                               **_):
    """A classifier head built from a checkpoint's config with its saved
    weights (JAX ``models/classifiers.py:419``); its first layer's width
    and ViT's token count come from the saved weights.  The head is
    returned on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    from ..training.checkpoint import load_checkpoint
    from ..utils.weights import head_from_jax
    state = load_checkpoint(checkpoint)
    kind = state.get("class_model_type")
    if kind not in CLASS_MODELS:
        raise ValueError(f"unknown classifier {kind!r}")
    saved = state.get("class_model")
    kwargs = head_input_shape(saved, kind)
    module = CLASS_MODELS[kind](
        channels_org=state.get("channels_org", 3),
        channels_bn=state.get("channels_bn", 768),
        cut_position=state.get("cut_position"),
        patch_size=state.get("patch_size", 128),
        compression_level=state.get("compression_level", 4),
        num_classes=state.get("num_classes", 1000) or 1000,
        dropout=state.get("dropout", 0.0) or 0.0, **kwargs)
    if saved is not None:
        module.load_state_dict(head_from_jax(saved))
    return module.to(dev).train(train)


# the first layer of each head, by its flax path
FIRST_LAYER = {"ViT": ("conv_proj",), "ResNet": ("conv1",),
               "InceptionV3": ("Conv2d_1a_1x1", "Conv2d_1a_3x3/conv"),
               "UNet": ("analysis_0/c1",), "JNet": ("bottleneck/c1",)}


def head_input_shape(saved, kind: str) -> dict:
    """``channels_in`` (and ViT's ``input_size``) of a head from its saved
    variables; empty when there are none."""
    if not saved:
        return {}
    out = {}
    for path in FIRST_LAYER[kind]:
        node = saved["params"]
        for part in path.split("/"):
            node = node.get(part) if isinstance(node, dict) else None
        if node is not None:
            out["channels_in"] = int(np.shape(node["kernel"])[2])
    if kind == "ViT":
        tokens = int(np.shape(saved["params"]["pos_embedding"])[1]) - 1
        side = int(round(np.sqrt(tokens)))
        out["input_size"] = (side, tokens // side)
        if int(np.shape(saved["params"]["conv_proj"]["kernel"])[0]) == 16:
            out["input_size"] = (side * 16, tokens // side * 16)
    return out
