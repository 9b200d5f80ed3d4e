"""Carry the JAX package's variables (numpy trees) across to the port.

The JAX package stores conv kernels HWIO and transposed-conv kernels as
spatially flipped HWIO (its transposed conv is an input-dilated conv); the
port uses PyTorch's layouts.  This inverts
``cnn_autoencoder_tpu/utils/torch_import.py:36-44``:

* conv ``kernel`` (``conv_*``, ``res_conv*``, ``color_i``) HWIO ->
  ``weight`` OIHW: ``transpose(3, 2, 0, 1)``, grouped or not (both keep
  ``in / groups`` inputs per output);
* deconv ``kernel`` (``deconv_*``, ``res_deconv*``), flipped HWIO
  ``(k, k, in / g, out)`` with g groups -> ``ConvTranspose2d`` ``weight``
  ``(in, out / g, kh, kw)``, group by group: the flipped kernel's output
  axis splits into g blocks of ``out / g``, and block j takes the inputs
  of group j;
* biases, GDN ``beta``/``gamma`` (stored reparameterized in both), batch
  norms' ``scale``/``bias`` and the ``fact_ent`` parameters carry over as
  stored;
* the ``batch_stats`` collection's ``mean``/``var`` map to the batch
  norms' buffers of the same names;
* a multiscale decoder's color layers (``decoder/color_i``, a conv whose
  ``kernel`` and ``bias`` sit at the unit's level) map to
  ``decoder.color_i.weight`` / ``.bias``;
* the heads (``class_model``, ``seg_model``; ``models/layers.py``) keep
  flax's paths: a 4-D ``kernel`` (a conv's HWIO, or a 2x2 transposed
  conv's (kh, kw, in, out)) is an OIHW ``weight``, a 2-D one (dense,
  (in, out)) a (out, in) ``weight``; every other leaf (biases, scales,
  the attention's 3-D kernels, ViT's tokens, ``batch_stats``) as stored
  (``head_from_jax`` / ``head_to_jax``).

A grouped model (config ``groups``) gives each unit's convolutions as many
groups as the unit has input channels, so the decoder's group counts come
from the config's stage widths.  ``state_to_jax`` is the inverse, for
checkpoints the JAX package reads.
"""

from typing import Any, Dict

import numpy as np
import torch

from ..models.autoencoder import _synthesizer_stage_channels

_STATS = ("mean", "var")
# the model's head children, carried by head_from_jax / head_to_jax
HEADS = ("class_model", "seg_model")


def _kind(where: str) -> str:
    """The kind of a unit's layer, by the JAX package's names."""
    if where.startswith(("deconv", "res_deconv")):
        return "deconv"
    if where.startswith(("conv", "res_conv", "color")):
        return "conv"
    if where.startswith("gdn"):
        return "gdn"
    if where.startswith(("norm", "res_norm")):
        return "norm"
    raise ValueError(f"layer {where} is not a layer of the CAE")


def _deconv_groups(config: Dict[str, Any]) -> Dict[str, int]:
    """{decoder unit: group count of its transposed convolutions} of a
    grouped model (each unit's input width); empty otherwise."""
    if not config.get("groups"):
        return {}
    stages = _synthesizer_stage_channels(
        config.get("channels_org", 3), config.get("channels_net", 8),
        config.get("channels_bn", 192), config.get("compression_level", 4),
        config.get("channels_expansion", 1))
    return {f"up_{i}": cin for i, (cin, _, _) in enumerate(stages)}


def _conv(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))


def _deconv(kernel: np.ndarray, groups: int = 1) -> np.ndarray:
    k1, k2, cin_g, cout = kernel.shape
    blocks = kernel[::-1, ::-1].reshape(k1, k2, cin_g, groups, cout // groups)
    return np.transpose(blocks, (3, 2, 4, 0, 1)).reshape(
        groups * cin_g, cout // groups, k1, k2)


def _layer(prefix: str, layer: str, params: Dict[str, Any],
           groups: int = 1) -> Dict[str, np.ndarray]:
    out = {}
    params = {k: v for k, v in params.items() if v is not None}
    kind = _kind(layer)
    allowed = {"conv": ("kernel", "bias"), "deconv": ("kernel", "bias"),
               "gdn": ("beta", "gamma"), "norm": ("scale", "bias")}[kind]
    for name, value in params.items():
        if name not in allowed:
            raise ValueError(f"unknown parameter {prefix}/{layer}/{name}")
        if name == "kernel":
            value = (_conv(np.asarray(value)) if kind == "conv"
                     else _deconv(np.asarray(value), groups))
            name = "weight"
        out[f"{prefix}.{layer}.{name}"] = np.asarray(value)
    return out


def state_from_jax(variables: Dict[str, Any], config: Dict[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """``{"encoder"|"decoder"|"fact_ent"|"class_model"|"seg_model":
    {"params": tree[, "batch_stats": tree]}}`` (numpy arrays, as a
    checkpoint holds them) -> the port's ``CAEModel`` state dict.  Other
    top-level entries (config scalars,
    optimizer state) are ignored, and so are None leaves (the holes of an
    optimizer slot's moment trees, where a parameter belongs to the other
    slot of its module)."""
    arrays: Dict[str, np.ndarray] = {}
    levels = int(config.get("compression_level", 4))
    groups = _deconv_groups(config)
    for module in ("encoder", "decoder"):
        tree = variables.get(module)
        if tree is None:
            continue
        unknown = set(tree) - {"params", "batch_stats"}
        if unknown:
            raise ValueError(f"{module}: unknown collections "
                             f"{sorted(unknown)}")
        units = {k: v for k, v in tree["params"].items()
                 if not k.startswith("color_")}
        if len(units) != levels:
            raise ValueError(f"{module} holds {len(units)} stages, "
                             f"config says compression_level {levels}")
        for unit, layers in tree["params"].items():
            if unit.startswith("color_"):
                arrays.update(_layer(module, unit, layers))
                continue
            for layer, params in layers.items():
                arrays.update(_layer(f"{module}.{unit}", layer, params,
                                     groups.get(unit, 1)))
        for unit, layers in tree.get("batch_stats", {}).items():
            for layer, stats in layers.items():
                if _kind(layer) != "norm" or set(stats) - set(_STATS):
                    raise ValueError(f"unknown batch statistics {module}/"
                                     f"{unit}/{layer}: {sorted(stats)}")
                for name, value in stats.items():
                    arrays[f"{module}.{unit}.{layer}.{name}"] = \
                        np.asarray(value)
    fact_ent = variables.get("fact_ent")
    if fact_ent is not None:
        for name, value in fact_ent["params"].items():
            if value is not None:
                arrays[f"fact_ent.{name}"] = np.asarray(value)
    out = {k: torch.from_numpy(np.array(v, np.float32))
           for k, v in arrays.items()}
    for module in HEADS:
        if variables.get(module) is not None:
            out.update({f"{module}.{k}": v for k, v in
                        head_from_jax(variables[module]).items()})
    return out


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def head_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A head's ``{"params": tree[, "batch_stats": tree]}`` -> its module's
    state dict (None leaves skipped)."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"head: unknown collections {sorted(unknown)}")
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection) or {}):
            if value is None:
                continue
            value = np.asarray(value, np.float32)
            if path[-1] == "kernel" and value.ndim in (2, 4):
                value = value.T if value.ndim == 2 else _conv(value)
                path = path[:-1] + ("weight",)
            out[".".join(path)] = torch.from_numpy(np.array(value))
    return out


def head_to_jax(weights: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``head_from_jax`` on a head's state dict (keys
    relative to the head; None values stay None leaves)."""
    tree: Dict[str, Any] = {"params": {}}
    for key, value in weights.items():
        arr = None if value is None else value.detach().cpu().float().numpy()
        *where, name = key.split(".")
        node = tree.setdefault("batch_stats" if name in _STATS else "params",
                               {})
        if name == "weight":
            if arr is not None:
                arr = arr.T if arr.ndim == 2 else _conv_to_hwio(arr)
            name = "kernel"
        for part in where:
            node = node.setdefault(part, {})
        node[name] = _contiguous(arr)
    return tree


def _conv_to_hwio(weight: np.ndarray) -> np.ndarray:
    return np.transpose(weight, (2, 3, 1, 0))


def _deconv_to_hwio(weight: np.ndarray, groups: int = 1) -> np.ndarray:
    cin, cout_g, k1, k2 = weight.shape
    blocks = weight.reshape(groups, cin // groups, cout_g, k1, k2)
    return np.transpose(blocks, (3, 4, 1, 0, 2)).reshape(
        k1, k2, cin // groups, groups * cout_g)[::-1, ::-1]


def state_to_jax(weights: Dict[str, torch.Tensor], config: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """The port's ``CAEModel`` state dict -> the JAX package's variable
    trees ``{"encoder"|"decoder"|"fact_ent"|"class_model"|"seg_model":
    {"params": tree[, "batch_stats": tree]}}`` of contiguous float32 numpy
    arrays (the inverse
    of ``state_from_jax``; ``config`` gives a grouped model's layout).  A
    None value stays a None leaf at its parameter's place."""
    tree: Dict[str, Any] = {}
    groups = _deconv_groups(config)
    heads: Dict[str, Dict[str, Any]] = {}
    for key, value in weights.items():
        module, *path = key.split(".")
        if module in HEADS:
            heads.setdefault(module, {})[".".join(path)] = value
            continue
        arr = None if value is None else value.detach().cpu().float().numpy()
        collections = tree.setdefault(module, {"params": {}})
        if module == "fact_ent":
            collections["params"][path[0]] = _contiguous(arr)
            continue
        *where, name = path     # unit and layer, or a color layer
        params = collections.setdefault(
            "batch_stats" if name in _STATS else "params", {})
        if name == "weight":
            if arr is not None:
                arr = (_deconv_to_hwio(arr, groups.get(where[0], 1))
                       if _kind(where[-1]) == "deconv"
                       else _conv_to_hwio(arr))
            name = "kernel"
        for part in where:
            params = params.setdefault(part, {})
        params[name] = _contiguous(arr)
    for module, head in heads.items():
        tree[module] = head_to_jax(head)
    return tree


def _contiguous(arr):
    return None if arr is None else np.ascontiguousarray(arr)
