"""Model factory: the CAE as one ``nn.Module`` built from a checkpoint's
config, with ``encoder``, ``decoder`` and ``fact_ent`` children, and a
``class_model`` / ``seg_model`` head when the config names one
(``class_model_type``: ViT, ResNet or InceptionV3; ``seg_model_type``: UNet
or JNet).

Counterpart of the JAX package's ``setup_modules``, ``CAEModel``,
``build_model`` and ``autoencoder_from_state_dict`` (``models/factory.py:
41-227`` there).  Config keys and defaults are the same (a head's
``cut_position`` 0 when unset, ``seg_channels_net`` 128,
``seg_channels_bn`` 48, ``seg_channels_expansion`` 1, ...); the config
dict is kept on the model.  The heads take the quantized latent, so their
input width is ``channels_bn``, and ViT's token count is the latent's of
an input of ``init_input_size`` or ``patch_size`` (64 without either), as
the JAX package initialises them.
"""

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..training.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.weights import HEADS, state_from_jax
from .autoencoder import Analyzer, Synthesizer
from .classifiers import CLASS_MODELS
from .entropy import FactorizedEntropyBottleneck
from .segmenters import SEG_MODELS


def _net_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    keys = ("channels_org", "channels_net", "channels_bn",
            "compression_level", "channels_expansion", "kernel_size",
            "act_layer_type", "use_residual", "groups", "batch_norm",
            "dropout")
    out = {k: config[k] for k in keys if config.get(k) is not None}
    if config.get("bias") is not None:
        out["use_bias"] = bool(config["bias"])
    return out


class CAEModel(nn.Module):
    """Encoder + decoder + entropy-bottleneck parameters of one CAE."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        self.config = dict(config)
        net = _net_kwargs(config)
        net.setdefault("channels_bn", 192)
        net.setdefault("compression_level", 4)
        self.encoder = Analyzer(**net)
        self.decoder = Synthesizer(multiscale_analysis=bool(
            config.get("multiscale_analysis", False)), **net)
        self.fact_ent = FactorizedEntropyBottleneck(self.channels_bn,
                                                    self.filters)
        if config.get("class_model_type"):
            self.class_model = _classifier(config, self.channels_bn,
                                           self.compression_level)
        if config.get("seg_model_type"):
            self.seg_model = _segmenter(config, self.channels_bn,
                                        self.compression_level)

    @property
    def compression_level(self) -> int:
        return int(self.config.get("compression_level", 4))

    @property
    def channels_bn(self) -> int:
        return int(self.config.get("channels_bn", 192))

    @property
    def filters(self) -> Tuple[int, ...]:
        k = int(self.config.get("K", 4))
        r = int(self.config.get("r", 3))
        return tuple([r] * k)


def _latent_side(config: Dict[str, Any], level: int) -> int:
    """The latent's side for the JAX package's init input (``init_input_
    size`` or ``patch_size``, 64 without either): ceil(h / 2) a stage."""
    side = (config.get("init_input_size") or [config.get("patch_size")
                                              or 64])[0]
    for _ in range(level):
        side = (side + 1) // 2
    return int(side)


def _classifier(config: Dict[str, Any], channels_bn: int, level: int):
    """The JAX ``setup_modules``' classifier (``models/factory.py:80``)."""
    kind = config["class_model_type"]
    if kind not in CLASS_MODELS:
        raise ValueError(f"unknown classifier {kind!r}")
    extra = {"channels_in": channels_bn}
    if kind == "ViT":
        side = _latent_side(config, level)
        extra["input_size"] = (side, side)
    return CLASS_MODELS[kind](
        channels_bn=channels_bn,
        cut_position=config.get("cut_position", 0) or 0,
        num_classes=config.get("num_classes", 1000),
        compression_level=level,
        patch_size=config.get("patch_size", 128), **extra)


def _segmenter(config: Dict[str, Any], channels_bn: int, level: int):
    """The JAX ``setup_modules``' segmenter (``models/factory.py:88``)."""
    kind = config["seg_model_type"]
    if kind not in SEG_MODELS:
        raise ValueError(f"unknown segmenter {kind!r}")
    return SEG_MODELS[kind](
        channels_org=config.get("channels_org", 3),
        channels_bn=channels_bn, compression_level=level,
        seg_channels_net=config.get("seg_channels_net", 128),
        seg_channels_bn=config.get("seg_channels_bn", 48),
        seg_channels_expansion=config.get("seg_channels_expansion", 1),
        num_classes=config.get("num_classes", 1),
        batch_norm=bool(config.get("batch_norm", False)),
        channels_in=channels_bn)


def build_model(config: Dict[str, Any], generator=None,
                device=None) -> CAEModel:
    """A fresh CAE with the JAX package's initialisers: convs and deconvs
    xavier-uniform with gain sqrt(2/1.01) and bias 0.01, GDN beta 1 and
    gamma 0.1 I, batch norms' scale 1, bias 0, mean 0 and var 1 (flax's),
    the bottleneck's constant matrices, U(-0.5, 0.5) biases and
    (-10, 0, 10) quantiles.  Every draw comes from ``generator`` (a CPU
    ``torch.Generator``; None: torch's default), module by module in
    registration order.  The JAX package draws other bits from the same
    seed.  Returned in train mode on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    model = CAEModel(config)
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model.to(dev).train()


def autoencoder_from_state_dict(checkpoint, device=None) -> CAEModel:
    """Load a CAE from a ``.msgpack`` checkpoint, a reference torch ``.pth``
    / ``.pt`` (converted by ``utils/torch_import.py``) or an in-memory state
    dict of the msgpack's form (config scalars + module variable trees).
    Every weight of the model must be present but the color layers: a
    multiscale model built from a checkpoint without them (training a
    multiscale criterion from a single-scale model) initialises them from
    seed 0, as the JAX package fills what a checkpoint lacks from its
    init; a head the checkpoint holds no weights for starts from seed 0
    too, as the JAX package leaves such a head at its init.  A batch-norm
    model's (and Inception's) running statistics come from the
    checkpoint's ``batch_stats``.  A config that does not say ``multiscale_analysis`` takes it from
    the decoder's weights: the train CLI's checkpoints record the
    criterion, not the flag (the JAX package drops their color layers on
    load); one that says False drops them, as the JAX package does.  The
    model is returned in eval mode on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    state = load_checkpoint(checkpoint)
    config = {k: v for k, v in state.items()
              if not isinstance(v, dict) and k != "step"}
    colors = any(u.startswith("color_") for u in
                 (state.get("decoder") or {}).get("params", {}))
    if config.get("multiscale_analysis") is None and colors:
        config["multiscale_analysis"] = True
    model = CAEModel(config)
    weights = state_from_jax(state, config)
    if not model.decoder.multiscale_analysis:
        weights = {k: v for k, v in weights.items()
                   if not k.startswith("decoder.color_")}
    missing = set(model.state_dict()) - set(weights)
    fresh = {k for k in missing if k.startswith("decoder.color_")
             or k.split(".")[0] in HEADS}
    if missing - fresh:
        raise ValueError(f"checkpoint lacks weights: "
                         f"{sorted(missing - fresh)}")
    generator = torch.Generator().manual_seed(0)
    for name in sorted({k.split(".")[1] for k in fresh
                        if k.startswith("decoder.")}):
        getattr(model.decoder, name).reset_parameters(generator)
    for head in HEADS:
        if hasattr(model, head) and not any(
                k.startswith(head + ".") for k in weights):
            for module in getattr(model, head).modules():
                if hasattr(module, "reset_parameters"):
                    module.reset_parameters(generator)
        elif any(k.startswith(head + ".") for k in fresh):
            lacks = sorted(k for k in fresh if k.startswith(head + "."))
            raise ValueError(f"checkpoint lacks weights: {lacks}")
    model.load_state_dict(weights, strict=not fresh)
    return model.to(dev).eval()
