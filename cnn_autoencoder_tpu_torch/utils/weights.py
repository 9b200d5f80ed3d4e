"""Carry the JAX package's parameters (numpy trees) across to the port.

The JAX package stores conv kernels HWIO and transposed-conv kernels as
spatially flipped HWIO (its transposed conv is an input-dilated conv); the
port uses PyTorch's layouts.  This inverts
``cnn_autoencoder_tpu/utils/torch_import.py:36-44``:

* conv ``kernel`` HWIO -> ``weight`` OIHW: ``transpose(3, 2, 0, 1)``;
* deconv ``kernel`` (flipped HWIO) -> ``ConvTranspose2d`` ``weight``
  (in, out, kh, kw): ``transpose(hwio[::-1, ::-1], (2, 3, 0, 1))``;
* biases, GDN ``beta``/``gamma`` (stored reparameterized in both) and the
  ``fact_ent`` parameters carry over as stored.

``state_to_jax`` is the inverse, for checkpoints the JAX package reads.
"""

from typing import Any, Dict

import numpy as np
import torch


def _conv(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))


def _deconv(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1))


def _layer(prefix: str, layer: str, params: Dict[str, Any]
           ) -> Dict[str, np.ndarray]:
    out = {}
    if layer.startswith(("conv", "deconv")):
        convert = _deconv if layer.startswith("deconv") else _conv
        for name, value in params.items():
            if name == "kernel":
                out[f"{prefix}.{layer}.weight"] = convert(np.asarray(value))
            elif name == "bias":
                out[f"{prefix}.{layer}.bias"] = np.asarray(value)
            else:
                raise ValueError(f"unknown parameter {prefix}/{layer}/{name}")
    elif layer.startswith("gdn"):
        for name, value in params.items():
            if name not in ("beta", "gamma"):
                raise ValueError(f"unknown parameter {prefix}/{layer}/{name}")
            out[f"{prefix}.{layer}.{name}"] = np.asarray(value)
    else:
        raise ValueError(f"layer {prefix}/{layer} is not ported yet")
    return out


def state_from_jax(variables: Dict[str, Any], config: Dict[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """``{"encoder"|"decoder"|"fact_ent": {"params": tree}}`` (numpy arrays,
    as a checkpoint holds them) -> the port's ``CAEModel`` state dict.
    Other top-level entries (config scalars, optimizer state) are ignored."""
    arrays: Dict[str, np.ndarray] = {}
    levels = int(config.get("compression_level", 4))
    for module in ("encoder", "decoder"):
        tree = variables.get(module)
        if tree is None:
            continue
        if set(tree) - {"params"}:
            raise ValueError(f"{module}: collections "
                             f"{sorted(set(tree) - {'params'})} are not "
                             "ported yet (batch norm)")
        if len(tree["params"]) != levels:
            raise ValueError(f"{module} holds {len(tree['params'])} stages, "
                             f"config says compression_level {levels}")
        for unit, layers in tree["params"].items():
            for layer, params in layers.items():
                arrays.update(_layer(f"{module}.{unit}", layer, params))
    fact_ent = variables.get("fact_ent")
    if fact_ent is not None:
        for name, value in fact_ent["params"].items():
            arrays[f"fact_ent.{name}"] = np.asarray(value)
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in arrays.items()}


def _conv_to_hwio(weight: np.ndarray) -> np.ndarray:
    return np.transpose(weight, (2, 3, 1, 0))


def _deconv_to_hwio(weight: np.ndarray) -> np.ndarray:
    return np.transpose(weight, (2, 3, 0, 1))[::-1, ::-1]


def state_to_jax(weights: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``CAEModel`` state dict -> the JAX package's variable
    trees ``{"encoder"|"decoder"|"fact_ent": {"params": tree}}`` of
    contiguous float32 numpy arrays (the inverse of ``state_from_jax``)."""
    tree: Dict[str, Any] = {}
    for key, value in weights.items():
        arr = value.detach().cpu().float().numpy()
        module, *path = key.split(".")
        params = tree.setdefault(module, {"params": {}})["params"]
        if module == "fact_ent":
            params[path[0]] = np.ascontiguousarray(arr)
            continue
        unit, layer, name = path
        if name == "weight":
            arr = (_deconv_to_hwio if layer.startswith("deconv")
                   else _conv_to_hwio)(arr)
            name = "kernel"
        params.setdefault(unit, {}).setdefault(layer, {})[name] = \
            np.ascontiguousarray(arr)
    return tree
