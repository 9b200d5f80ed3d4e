"""Reference (torch) checkpoint import: the port's copy of the JAX package's
``utils/torch_import.py:1-278``.

A reference ``.pth`` training checkpoint is a flat dict (the reference's
``src/utils/_loggers.py:104-129``): the run's args and a torch state dict
per module.  ``convert_reference_checkpoint`` turns it into the JAX
package's state layout (config scalars + flax variable trees of numpy
arrays), which ``utils/weights.py:state_from_jax`` and
``models/factory.py:autoencoder_from_state_dict`` take from there:

* Conv2d OIHW -> HWIO;
* ConvTranspose2d (in, out, kh, kw) -> HWIO spatially flipped (the JAX
  package's transposed conv is an lhs-dilated conv with pre-flipped
  kernels);
* GDN beta / gamma as stored (both keep the non-negative
  reparameterized form), gamma (C, C, 1, 1) -> (C, C);
* the bottleneck's ``_matrixK`` / ``_biasK`` / ``_factorK`` /
  ``quantiles`` -> ``matrix_K`` / ``bias_K`` / ``factor_K`` /
  ``quantiles``;
* BatchNorm weight / bias / running_mean / running_var -> scale / bias /
  mean / var, the ``batch_stats`` collection;
* a multiscale decoder's ``color_layers.i.0`` -> ``color_i``.

The torch Sequential index layout inside each unit depends on the
architecture flags; ``_unit_layout`` rebuilds it from the config as the
reference's constructors build it.  A checkpoint holding classifier or
segmenter state raises: the heads' importers (JAX ``:279-509``) are not
ported yet.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def conv_weight_to_hwio(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 1, 0))


def deconv_weight_to_hwio_flipped(w) -> np.ndarray:
    w = np.transpose(_np(w), (2, 3, 0, 1))
    return np.ascontiguousarray(w[::-1, ::-1])


def _strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return sd


def _unit_layout(act: Optional[str], batch_norm: bool, residual: bool,
                 track: str) -> List[Tuple[str, int, str, str]]:
    """(torch_sequential, torch_idx, kind, flax_name) for one unit.

    ``kind`` in {conv, deconv, bn, gdn}; parameterless activation and
    dropout slots only advance the index.  Mirrors the reference's
    constructors (``_autoencoders.py:53-304``)."""
    down = track == "analysis"
    conv_kind = "conv" if down else "deconv"
    pre = act is not None and act != "GDN"
    entries: List[Tuple[str, int, str, str]] = []

    if not residual:
        i = 0
        if pre:
            entries.append(("model", i, conv_kind,
                            "conv_pre" if down else "deconv_pre"))
            i += 1
            if batch_norm:
                entries.append(("model", i, "bn", "norm_pre"))
                i += 1
            i += 1  # elementwise activation
        entries.append(("model", i, conv_kind,
                        "conv_down" if down else "deconv_up"))
        i += 1
        if batch_norm:
            entries.append(("model", i, "bn",
                            "norm_down" if down else "norm_up"))
            i += 1
        if act == "GDN":
            entries.append(("model", i, "gdn",
                            "gdn_down" if down else "gdn_up"))
        return entries

    # residual units: a res_model branch, then the strided model branch
    i = 0
    entries.append(("res_model", i, conv_kind,
                    "res_conv1" if down else "res_deconv1"))
    i += 1
    if batch_norm:
        entries.append(("res_model", i, "bn", "res_norm1"))
        i += 1
    if act == "GDN":
        entries.append(("res_model", i, "gdn", "gdn_res"))
    i += 1  # activation slot (GDN, elementwise or Identity)
    if pre:
        entries.append(("res_model", i, conv_kind,
                        "res_conv2" if down else "res_deconv2"))
        i += 1
        if batch_norm:
            entries.append(("res_model", i, "bn", "res_norm2"))
            i += 1
        if not down:
            i += 1  # the up variant ends its res branch with an activation

    j = 0
    if pre:
        j += 1  # leading activation in the strided branch
    entries.append(("model", j, conv_kind,
                    "conv_down" if down else "deconv_up"))
    j += 1
    if batch_norm:
        entries.append(("model", j, "bn",
                        "norm_down" if down else "norm_up"))
        j += 1
    if act == "GDN":
        entries.append(("model", j, "gdn",
                        "gdn_down" if down else "gdn_up"))
    return entries


def _import_unit(sd: Dict[str, Any], prefix: str, layout
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The flax ``params`` and ``batch_stats`` dicts of one unit."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for seq, idx, kind, flax_name in layout:
        base = f"{prefix}.{seq}.{idx}"
        if kind in ("conv", "deconv"):
            w = sd.get(f"{base}.weight")
            if w is None:
                continue
            kernel = (conv_weight_to_hwio(w) if kind == "conv"
                      else deconv_weight_to_hwio_flipped(w))
            p = {"kernel": kernel}
            if f"{base}.bias" in sd:
                p["bias"] = _np(sd[f"{base}.bias"])
            params[flax_name] = p
        elif kind == "gdn":
            if f"{base}.beta" not in sd:
                continue
            params[flax_name] = {"beta": _np(sd[f"{base}.beta"]),
                                 "gamma": _np(sd[f"{base}.gamma"])
                                 .reshape(sd[f"{base}.gamma"].shape[:2])}
        elif kind == "bn":
            if f"{base}.weight" not in sd:
                continue
            params[flax_name] = {"scale": _np(sd[f"{base}.weight"]),
                                 "bias": _np(sd[f"{base}.bias"])}
            stats[flax_name] = {"mean": _np(sd[f"{base}.running_mean"]),
                                "var": _np(sd[f"{base}.running_var"])}
    return params, stats


def _track(sd, track, compression_level, act_layer_type, batch_norm,
           use_residual):
    sd = _strip_module_prefix(sd)
    prefix, unit = (("analysis_track", "down") if track == "analysis"
                    else ("synthesis_track", "up"))
    params, stats = {}, {}
    for stage in range(compression_level):
        act = act_layer_type if stage < compression_level - 1 else None
        layout = _unit_layout(act, batch_norm, use_residual, track)
        p, s = _import_unit(sd, f"{prefix}.{stage}", layout)
        if p:
            params[f"{unit}_{stage}"] = p
        if s:
            stats[f"{unit}_{stage}"] = s
    return sd, params, stats


def _variables(params, stats) -> Dict[str, Any]:
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def import_analyzer(sd: Dict[str, Any], compression_level: int,
                    act_layer_type: Optional[str], batch_norm: bool,
                    use_residual: bool) -> Dict[str, Any]:
    _, params, stats = _track(sd, "analysis", compression_level,
                              act_layer_type, batch_norm, use_residual)
    return _variables(params, stats)


def import_synthesizer(sd: Dict[str, Any], compression_level: int,
                       act_layer_type: Optional[str], batch_norm: bool,
                       use_residual: bool,
                       multiscale_analysis: bool = False) -> Dict[str, Any]:
    sd, params, stats = _track(sd, "synthesis", compression_level,
                               act_layer_type, batch_norm, use_residual)
    if multiscale_analysis:
        for i in range(compression_level - 1):
            key = f"color_layers.{i}.0.weight"
            if key in sd:
                p = {"kernel": conv_weight_to_hwio(sd[key])}
                bkey = f"color_layers.{i}.0.bias"
                if bkey in sd:
                    p["bias"] = _np(sd[bkey])
                params[f"color_{i}"] = p
    return _variables(params, stats)


def import_fact_ent(sd: Dict[str, Any], num_filters: int = 4
                    ) -> Dict[str, Any]:
    sd = _strip_module_prefix(sd)
    params: Dict[str, Any] = {}
    for i in range(num_filters + 1):
        if f"_matrix{i}" in sd:
            params[f"matrix_{i}"] = _np(sd[f"_matrix{i}"])
        if f"_bias{i}" in sd:
            params[f"bias_{i}"] = _np(sd[f"_bias{i}"])
        if i < num_filters and f"_factor{i}" in sd:
            params[f"factor_{i}"] = _np(sd[f"_factor{i}"])
    if "quantiles" in sd:
        params["quantiles"] = _np(sd["quantiles"])
    return {"params": params}


def convert_reference_checkpoint(chk: Dict[str, Any]) -> Dict[str, Any]:
    """A reference training-checkpoint dict -> the JAX package's state dict.

    Config scalars pass through; module state dicts are converted; the
    optimizer and scheduler states are dropped.  The reference's persisted
    CDF buffers are ignored: the tables are baked again from the quantiles
    (the reference itself updates them on load, ``_autoencoders.py:502``).
    Classifier or segmenter state raises "not ported"."""
    for head in ("class_model", "seg_model"):
        if chk.get(head):
            raise ValueError(f"the checkpoint holds {head} state: importing "
                             "the classifier and segmenter heads is not "
                             "ported yet")
    state: Dict[str, Any] = {}
    module_keys = ("encoder", "decoder", "fact_ent", "class_model",
                   "seg_model")
    for k, v in chk.items():
        if k in module_keys or k.startswith("optimizer_") or \
                k.startswith("scheduler_"):
            continue
        if isinstance(v, (str, int, float, bool, list, tuple)) or v is None:
            state[k] = v

    level = int(chk.get("compression_level", 4))
    act = chk.get("act_layer_type")
    bn = bool(chk.get("batch_norm", False))
    res = bool(chk.get("use_residual", False))
    k_filters = int(chk.get("K", 4))

    if isinstance(chk.get("encoder"), dict):
        state["encoder"] = import_analyzer(chk["encoder"], level, act, bn,
                                           res)
    if isinstance(chk.get("decoder"), dict):
        state["decoder"] = import_synthesizer(
            chk["decoder"], level, act, bn, res,
            bool(chk.get("multiscale_analysis", False)))
    if isinstance(chk.get("fact_ent"), dict):
        state["fact_ent"] = import_fact_ent(chk["fact_ent"], k_filters)
    return state


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load and convert a reference ``.pth`` / ``.pt`` checkpoint.  It is
    read with ``torch.load(weights_only=False)``, as the JAX package reads
    it: that unpickles the file, which runs any code its pickles name, so
    load only checkpoints from a source you trust."""
    chk = torch.load(path, map_location="cpu", weights_only=False)
    return convert_reference_checkpoint(chk)
