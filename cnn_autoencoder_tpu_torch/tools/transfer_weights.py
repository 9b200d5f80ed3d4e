"""Weight transfer between checkpoint families: the port of the JAX
package's ``scripts/transfer_weights.py``.

    python -m cnn_autoencoder_tpu_torch.tools.transfer_weights -m MODE \
        -s source [-d destination] -o output

Bidirectional key renaming between compressai-style torch checkpoints
(``g_a./g_s./entropy_bottleneck.``, ``_matrices.N``) and CAE-style ones
(``analysis_track.N.model.M``, ``_matrixN``), plus checkpoint upgrades, and
``torch2jax``: a reference ``.pth`` training checkpoint converted into the
native msgpack that both packages read (layout transposes by
``utils/torch_import.py``; the mode keeps the name users type).  The rename
tables are this module's own copies of the JAX script's, and every mode
writes what the JAX script writes.  In the ``cae2cai`` direction the
entropy model's tag ``fact_ent`` is cut without its dot, so its keys come
out as ``entropy_bottleneck.._matrixN``, and ``cai2cae`` gives back only
``.quantiles`` of them, as the JAX script does.

Modes: cai2cae | cae2cai | cae2cae | last2best | torch2jax
"""

import argparse
import re

import torch

from ..training.checkpoint import save_checkpoint
from ..utils.torch_import import load_torch_checkpoint

# Checkpoint-format compatibility constants -----------------------------------
#
# Entropy-bottleneck keys that carry the same name in both families (matched
# as substrings, mirroring the reference's rename tables).
_PASSTHROUGH = (
    "quantiles",
    "_offset",
    "_quantized_cdf",
    "_cdf_length",
    "target",
    "likelihood_lower_bound.bound",
)

# compressai stores the factorized-prior parameters as indexed lists
# ("_matrices.3"); the CAE family flattens them ("_matrix3").
_PARAM_LISTS = (
    ("_matrices.", "_matrix"),
    ("_biases.", "_bias"),
    ("_factors.", "_factor"),
)

# (module name, tag identifying its keys in the source, prefix in the output)
_CAI_TO_CAE_MODULES = (
    ("encoder", "g_a.", "analysis_track."),
    ("decoder", "g_s.", "synthesis_track."),
    ("fact_entropy", "entropy_bottleneck.", ""),
)
_CAE_TO_CAI_MODULES = (
    ("encoder", "analysis_track.", "g_a."),
    ("decoder", "synthesis_track.", "g_s."),
    ("fact_entropy", "fact_ent", "entropy_bottleneck."),
)

# "3.weight": compressai nn.Sequential position + field
_SEQ_KEY = re.compile(r"^(\d+)\.(weight|bias|gamma|beta)$")
# "1.model.0.weight": CAE (unit, op-within-unit) + field
_UNIT_KEY = re.compile(r"^(\d+)\.model\.(\d+)\.(weight|bias|gamma|beta)$")


def _rename_cai_to_cae(key):
    """Module-stripped compressai key -> CAE-style key, or None to drop.

    compressai lays convolutions flat in one nn.Sequential; the CAE groups
    them two ops per "unit" (down/up conv + activation), so sequential
    position p becomes unit p//2, op p%2.
    """
    if any(name in key for name in _PASSTHROUGH):
        return key
    for list_prefix, flat_prefix in _PARAM_LISTS:
        if list_prefix in key:
            _, _, index = key.partition(list_prefix)
            return "%s%d" % (flat_prefix, int(index))
    m = _SEQ_KEY.match(key)
    if m:
        pos, field = int(m.group(1)), m.group(2)
        return "%d.model.%d.%s" % (pos // 2, pos % 2, field)
    return None


def _rename_cae_to_cai(key):
    """Module-stripped CAE key -> compressai-style key, or None if unknown.

    The flat ``_matrixN``/``_biasN``/``_factorN`` names are already what
    compressai's load_state_dict accepts (it re-lists them itself), so they
    pass through unchanged.
    """
    if any(name in key for name in _PASSTHROUGH):
        return key
    if any(key.startswith(flat) or flat in key
           for _, flat in _PARAM_LISTS):
        return key
    m = _UNIT_KEY.match(key)
    if m:
        unit, op, field = int(m.group(1)), int(m.group(2)), m.group(3)
        return "%d.%s" % (unit * 2 + op, field)
    return None


def transfer_weights(chk_src, cai2cae=True):
    """Key-map a flat torch state dict between the two families
    (behavior of reference transfer_weights.py:72-120).

    Returns {"encoder": {...}, "decoder": {...}, "fact_entropy": {...}}.
    Keys the target family has no use for are dropped in the cai->cae
    direction (buffers are re-derived on load) and kept verbatim, without
    the module prefix, in the cae->cai direction.
    """
    if cai2cae:
        modules, rename = _CAI_TO_CAE_MODULES, _rename_cai_to_cae
    else:
        modules, rename = _CAE_TO_CAI_MODULES, _rename_cae_to_cai

    out = {}
    for module, src_tag, dst_prefix in modules:
        group = {}
        for full_key, weight in chk_src.items():
            if src_tag not in full_key:
                continue
            key = full_key.split(src_tag, 1)[1]
            new_key = rename(key)
            if new_key is not None:
                group[dst_prefix + new_key] = weight
            elif not cai2cae:
                group[key] = weight
        out[module] = group
    return out


# Per-mode checkpoint surgery --------------------------------------------------


def _mode_torch2jax(args):
    state = load_torch_checkpoint(args.source)
    save_checkpoint(args.output, state)
    print("Converted %s -> %s (native msgpack)" % (args.source, args.output))


def _mode_cai2cae(chk_src, chk_dst):
    """Graft a compressai model's weights into a CAE training checkpoint."""
    grafted = transfer_weights(chk_src, cai2cae=True)
    chk_dst["encoder"] = grafted["encoder"]
    chk_dst["decoder"] = grafted["decoder"]
    chk_dst["fact_ent"] = grafted["fact_entropy"]
    return chk_dst


def _mode_cae2cai(chk_src, chk_dst):
    """Flatten a CAE checkpoint's modules into one compressai state dict."""
    del chk_dst
    flat = dict(chk_src["decoder"])
    flat.update(chk_src["encoder"])
    flat.update(("fact_ent." + key, weight)
                for key, weight in chk_src["fact_ent"].items())
    grafted = transfer_weights(flat, cai2cae=False)
    merged = {}
    for module in ("fact_entropy", "encoder", "decoder"):
        merged.update(grafted[module])
    return merged


def _mode_cae2cae(chk_src, chk_dst):
    """Refresh a checkpoint's stored args from another checkpoint."""
    chk_dst.pop("args")
    chk_dst.update(chk_src["args"])
    return chk_dst


_MODEL_MODULES = ("encoder", "decoder", "fact_ent", "seg_model",
                  "class_model")


def _mode_last2best(chk_src, chk_dst):
    """Carry training bookkeeping from 'last' into 'best', keeping the
    best checkpoint's model weights."""
    chk_dst.update((key, value) for key, value in chk_src.items()
                   if key not in _MODEL_MODULES)
    return chk_dst


_TORCH_MODES = {
    "cai2cae": _mode_cai2cae,
    "cae2cai": _mode_cae2cai,
    "cae2cae": _mode_cae2cae,
    "last2best": _mode_last2best,
}


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Transfer weights between compressai-style, CAE-style and "
        "native-JAX checkpoints")
    parser.add_argument("-d", "--destination", help="Destination checkpoint")
    parser.add_argument("-s", "--source", help="Source checkpoint")
    parser.add_argument("-o", "--output", help="Output model filename")
    parser.add_argument("-m", "--mode", dest="transfer_mode", type=str,
                        choices=sorted(_TORCH_MODES) + ["torch2jax"])
    args = parser.parse_args(argv)

    if args.transfer_mode == "torch2jax":
        _mode_torch2jax(args)
        return

    chk_src = torch.load(args.source, map_location="cpu", weights_only=False)
    chk_dst = torch.load(args.destination, map_location="cpu",
                         weights_only=False) if args.destination else {}
    chk_out = _TORCH_MODES[args.transfer_mode](chk_src, chk_dst)
    torch.save(chk_out, args.output)


if __name__ == "__main__":
    main()
