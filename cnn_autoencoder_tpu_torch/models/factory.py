"""Model factory: the CAE as one ``nn.Module`` built from a checkpoint's
config, with ``encoder``, ``decoder`` and ``fact_ent`` children.

Counterpart of the JAX package's ``CAEModel``, ``build_model`` and
``autoencoder_from_state_dict`` (``models/factory.py:41-227`` there).
Config keys and defaults are the same; the config dict is kept on the
model.
"""

from typing import Any, Dict, Tuple

from torch import nn

from ..training.checkpoint import load_checkpoint
from ..utils.device import resolve_device
from ..utils.weights import state_from_jax
from .autoencoder import Analyzer, Synthesizer
from .entropy import FactorizedEntropyBottleneck

# options of the JAX package that this slice does not port yet
_NOT_PORTED = ("batch_norm", "use_residual", "groups", "multiscale_analysis",
               "class_model_type", "seg_model_type")


def _net_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    keys = ("channels_org", "channels_net", "channels_bn",
            "compression_level", "channels_expansion", "kernel_size",
            "act_layer_type")
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
        if float(config.get("dropout") or 0.0) > 0.0:
            raise ValueError("dropout is not ported yet")
        self.config = dict(config)
        net = _net_kwargs(config)
        net.setdefault("channels_bn", 192)
        net.setdefault("compression_level", 4)
        self.encoder = Analyzer(**net)
        self.decoder = Synthesizer(**net)
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
    gamma 0.1 I, the bottleneck's constant matrices, U(-0.5, 0.5) biases and
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
    """Load a CAE from a ``.msgpack`` checkpoint path or an in-memory state
    dict of the same form (config scalars + module variable trees); every
    weight of the model must be present.  The model is returned in eval mode
    on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    state = load_checkpoint(checkpoint)
    config = {k: v for k, v in state.items()
              if not isinstance(v, dict) and k != "step"}
    model = CAEModel(config)
    weights = state_from_jax(state, config)
    missing = set(model.state_dict()) - set(weights)
    if missing:
        raise ValueError(f"checkpoint lacks weights: {sorted(missing)}")
    model.load_state_dict(weights, strict=True)
    return model.to(dev).eval()
