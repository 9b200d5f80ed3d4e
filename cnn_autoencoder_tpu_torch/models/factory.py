"""Model factory: the CAE as one ``nn.Module`` built from a checkpoint's
config, with ``encoder``, ``decoder`` and ``fact_ent`` children.

Counterpart of the JAX package's ``CAEModel``, ``build_model`` and
``autoencoder_from_state_dict`` (``models/factory.py:41-227`` there).
Config keys and defaults are the same; the config dict is kept on the
model.
"""

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..training.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.weights import state_from_jax
from .autoencoder import Analyzer, Synthesizer
from .entropy import FactorizedEntropyBottleneck

# options of the JAX package that the port does not have yet (the heads)
_NOT_PORTED = ("class_model_type", "seg_model_type")


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
        for key in _NOT_PORTED:
            if config.get(key):
                raise ValueError(f"model option {key}={config[key]!r} is "
                                 "not ported yet")
        self.config = dict(config)
        net = _net_kwargs(config)
        net.setdefault("channels_bn", 192)
        net.setdefault("compression_level", 4)
        self.encoder = Analyzer(**net)
        self.decoder = Synthesizer(multiscale_analysis=bool(
            config.get("multiscale_analysis", False)), **net)
        self.fact_ent = FactorizedEntropyBottleneck(self.channels_bn,
                                                    self.filters)

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
    init.  A batch-norm model's running statistics come from the
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
    fresh = {k for k in missing if k.startswith("decoder.color_")}
    if missing - fresh:
        raise ValueError(f"checkpoint lacks weights: "
                         f"{sorted(missing - fresh)}")
    generator = torch.Generator().manual_seed(0)
    for name in sorted({k.split(".")[1] for k in fresh}):
        getattr(model.decoder, name).reset_parameters(generator)
    model.load_state_dict(weights, strict=not fresh)
    return model.to(dev).eval()
