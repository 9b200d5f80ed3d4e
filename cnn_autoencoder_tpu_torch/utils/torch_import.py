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
reference's constructors build it.  The heads' importers (JAX
``:279-509``: ``import_vit``, ``import_resnet``, ``import_inception``,
``import_class_model``, ``import_unet``) turn torchvision-layout state
dicts of the cut ViT, ResNet and Inception heads and the reference's
UNet / JNet into the JAX package's variable trees.
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
    A classifier (``class_model_type``) or segmenter (``seg_model_type``)
    state dict goes through the head importers below."""
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
    if isinstance(chk.get("class_model"), dict) and \
            chk.get("class_model_type"):
        state["class_model"] = import_class_model(
            chk["class_model"], chk["class_model_type"],
            cut_position=chk.get("cut_position"))
    if isinstance(chk.get("seg_model"), dict) and chk.get("seg_model_type"):
        state["seg_model"] = import_unet(
            chk["seg_model"], compression_level=level,
            use_analysis_track=chk.get("seg_model_type") == "UNet")
    return state


# --- classifier / segmenter head importers ----------------------------------
#
# The reference's heads are torchvision modules cut and re-headed (reference
# src/models/tasks/_classifiers.py); the JAX package's heads, and the
# port's after them, keep torchvision's module names, so importing is a
# per-layer-kind conversion into the JAX package's variable trees, which
# ``utils/weights.py:head_from_jax`` takes to the port's heads.


def _linear(sd, key):
    """torch Linear -> flax Dense params."""
    p = {"kernel": _np(sd[key + ".weight"]).T}
    if key + ".bias" in sd:
        p["bias"] = _np(sd[key + ".bias"])
    return p


def _conv(sd, key):
    p = {"kernel": conv_weight_to_hwio(sd[key + ".weight"])}
    if key + ".bias" in sd:
        p["bias"] = _np(sd[key + ".bias"])
    return p


def _norm_affine(sd, key):
    return {"scale": _np(sd[key + ".weight"]), "bias": _np(sd[key + ".bias"])}


def _bn_stats(sd, key):
    return {"mean": _np(sd[key + ".running_mean"]),
            "var": _np(sd[key + ".running_var"])}


def import_vit(sd: Dict[str, Any], num_layers: int, num_heads: int = 12
               ) -> Dict[str, Any]:
    """torchvision VisionTransformer state dict -> ViTClassifierHead vars.

    Handles the reference's cut variant: ``conv_proj`` may be the re-headed
    1x1 conv (reference _classifiers.py:46-50)."""
    sd = _strip_module_prefix(sd)
    params: Dict[str, Any] = {}
    params["conv_proj"] = _conv(sd, "conv_proj")
    params["class_token"] = _np(sd["class_token"])
    params["pos_embedding"] = _np(sd["encoder.pos_embedding"])
    hidden = params["class_token"].shape[-1]
    dh = hidden // num_heads

    for i in range(num_layers):
        base = f"encoder.layers.encoder_layer_{i}"
        blk: Dict[str, Any] = {}
        blk["ln_1"] = _norm_affine(sd, base + ".ln_1")
        blk["ln_2"] = _norm_affine(sd, base + ".ln_2")

        in_w = _np(sd[base + ".self_attention.in_proj_weight"])  # (3D, D)
        in_b = _np(sd[base + ".self_attention.in_proj_bias"])
        out_w = _np(sd[base + ".self_attention.out_proj.weight"])
        out_b = _np(sd[base + ".self_attention.out_proj.bias"])
        qw, kw, vw = np.split(in_w, 3, axis=0)
        qb, kb, vb = np.split(in_b, 3, axis=0)

        def proj(w, b):
            # torch (D_out, D_in) -> flax (D_in, heads, dh)
            return {"kernel": w.T.reshape(hidden, num_heads, dh),
                    "bias": b.reshape(num_heads, dh)}

        blk["self_attention"] = {
            "query": proj(qw, qb), "key": proj(kw, kb),
            "value": proj(vw, vb),
            "out": {"kernel": out_w.T.reshape(num_heads, dh, hidden),
                    "bias": out_b},
        }
        blk["mlp"] = {"fc1": _linear(sd, base + ".mlp.0"),
                      "fc2": _linear(sd, base + ".mlp.3")}
        params[f"encoder_layer_{i}"] = blk

    params["ln"] = _norm_affine(sd, "encoder.ln")
    if "heads.head.weight" in sd:
        params["head"] = _linear(sd, "heads.head")
    elif "heads.weight" in sd:
        params["head"] = _linear(sd, "heads")
    return {"params": params}


def import_resnet(sd: Dict[str, Any], layers=(3, 8, 36, 3)
                  ) -> Dict[str, Any]:
    """torchvision ResNet (GroupNorm norm layer) state dict ->
    ResNetClassifierHead vars.  Cut stages simply have no keys."""
    sd = _strip_module_prefix(sd)
    params: Dict[str, Any] = {}

    def gn(key):
        return {"GroupNorm_0": _norm_affine(sd, key)}

    if "conv1.weight" in sd:
        params["conv1"] = _conv(sd, "conv1")
    if "bn1.weight" in sd:
        params["bn1"] = gn("bn1")

    for stage in range(4):
        for blk in range(layers[stage]):
            base = f"layer{stage + 1}.{blk}"
            if base + ".conv1.weight" not in sd:
                continue
            p: Dict[str, Any] = {}
            for j in (1, 2, 3):
                p[f"conv{j}"] = _conv(sd, f"{base}.conv{j}")
                p[f"bn{j}"] = gn(f"{base}.bn{j}")
            if base + ".downsample.0.weight" in sd:
                p["downsample_conv"] = _conv(sd, base + ".downsample.0")
                p["downsample_bn"] = gn(base + ".downsample.1")
            params[f"layer{stage + 1}_block{blk}"] = p

    if "fc.weight" in sd:
        params["fc"] = _linear(sd, "fc")
    return {"params": params}


def import_inception(sd: Dict[str, Any]) -> Dict[str, Any]:
    """torchvision Inception3 state dict -> InceptionV3ClassifierHead vars.

    Exploits the 1:1 module naming: every torchvision submodule path maps to
    the same flax module name; BasicConv2d's conv/bn pairs convert per kind.
    Identity-replaced (cut) stages have no keys and are skipped."""
    sd = _strip_module_prefix(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    conv_keys = [k[:-len(".conv.weight")] for k in sd
                 if k.endswith(".conv.weight")]
    for path in conv_keys:
        parts = path.split(".")
        node_p = params
        node_s = stats
        for part in parts[:-1]:
            node_p = node_p.setdefault(part, {})
            node_s = node_s.setdefault(part, {})
        leaf = parts[-1]
        node_p[leaf] = {"conv": _conv(sd, path + ".conv"),
                        "bn": _norm_affine(sd, path + ".bn")}
        node_s[leaf] = {"bn": _bn_stats(sd, path + ".bn")}

    # the reference's cut>0 1x1 re-head is a bare conv (no bn)
    if "Conv2d_1a_3x3.weight" in sd:
        params["Conv2d_1a_1x1"] = _conv(sd, "Conv2d_1a_3x3")

    if "AuxLogits.fc.weight" in sd:
        params.setdefault("AuxLogits", {})["fc"] = _linear(sd, "AuxLogits.fc")
        if "AuxLogits.conv1.weight" in sd and \
                "AuxLogits.conv1.bn.weight" not in sd:
            params["AuxLogits"]["conv1_override"] = _conv(sd,
                                                          "AuxLogits.conv1")
    if "fc.weight" in sd:
        params["fc"] = _linear(sd, "fc")

    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


HEAD_IMPORTERS = {
    "ViT": import_vit,
    "ResNet": import_resnet,
    "InceptionV3": import_inception,
}


def import_class_model(sd: Dict[str, Any], class_model_type: str,
                       cut_position=None, **kwargs) -> Dict[str, Any]:
    if class_model_type == "ViT":
        cut = 6 if cut_position is None else cut_position
        return import_vit(sd, num_layers=12 - cut)
    if class_model_type == "ResNet":
        return import_resnet(sd)
    if class_model_type == "InceptionV3":
        return import_inception(sd)
    raise ValueError(class_model_type)


def import_unet(sd: Dict[str, Any], compression_level: int = 4,
                use_analysis_track: bool = True) -> Dict[str, Any]:
    """Reference UNet/JNet state dict -> flax segmenter vars.

    Reference layout (src/models/tasks/_segmenters.py): tracks are
    ModuleLists of units with submodules ``_c1/_c2/_bn1/_bn2/_up_sample/
    _dwn_sample``; bridges in ``bridges_projection``; the JNet bottleneck's
    1x1 ingest conv is ``bottleneck._c1``.
    """
    sd = _strip_module_prefix(sd)
    params: Dict[str, Any] = {}

    def gn(key):
        if key + ".weight" not in sd:
            return None
        return {"GroupNorm_0": _norm_affine(sd, key)}

    def unit(prefix, names):
        p = {}
        for torch_name, flax_name, kind in names:
            key = f"{prefix}.{torch_name}"
            if kind == "conv" and key + ".weight" in sd:
                p[flax_name] = _conv(sd, key)
            elif kind == "deconv" and key + ".weight" in sd:
                p[flax_name] = {
                    "kernel": deconv_weight_to_hwio_flipped(
                        sd[key + ".weight"])}
                if key + ".bias" in sd:
                    p[flax_name]["bias"] = _np(sd[key + ".bias"])
            elif kind == "gn":
                g = gn(key)
                if g is not None:
                    p[flax_name] = g
        return p

    conv_pair = [("_c1", "c1", "conv"), ("_bn1", "bn1", "gn"),
                 ("_c2", "c2", "conv"), ("_bn2", "bn2", "gn")]

    if use_analysis_track:
        for i in range(compression_level):
            p = unit(f"analysis_track.{i}", conv_pair)
            if p:
                params[f"analysis_{i}"] = p

    for i in range(compression_level):
        p = unit(f"synthesis_track.{i}",
                 conv_pair + [("_up_sample", "up", "deconv")])
        if p:
            params[f"synthesis_{i}"] = p
        bp = unit(f"bridges_projection.{i}",
                  [("_bn1", "bn1", "gn"), ("_c2", "c2", "conv"),
                   ("_bn2", "bn2", "gn")])
        if bp:
            params[f"bridge_proj_{i}"] = bp

    p = unit("bottleneck", conv_pair + [("_up_sample", "up", "deconv")])
    if p:
        params["bottleneck"] = p
    if "fc.weight" in sd:
        params["fc"] = _conv(sd, "fc")
    return {"params": params}


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load and convert a reference ``.pth`` / ``.pt`` checkpoint.  It is
    read with ``torch.load(weights_only=False)``, as the JAX package reads
    it: that unpickles the file, which runs any code its pickles name, so
    load only checkpoints from a source you trust."""
    chk = torch.load(path, map_location="cpu", weights_only=False)
    return convert_reference_checkpoint(chk)
