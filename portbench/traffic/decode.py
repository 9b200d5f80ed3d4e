"""Decode traffic: cae_tpu frames in, host uint8 tiles out, through the
program's ``CAETurboCore.decode_tiles`` on the configuration's weights.

Parameters: as the encode traffic's (``traffic/encode.py``).  The frames
are the bank's tiles encoded once in set-up by the program, which the
traffic needs: they are the requests.  Besides the rate it counts the 95th
percentile over every request of the window of the time from its
submission to its pixels on the host (a failed request counts as
infinite), which ``metrics/decode_p95_ms.py`` reads.

The comparison: the reference reads the frames of the sampled requests
with its own rANS reader and tables, runs its float32 synthesis on the
symbols, scales, clips and truncates to uint8 as the codec does, and the
number is the share of the program's uint8 values that differ from its.
A frame that is not sound counts all of its tile's values.
"""

import numpy as np
import torch

from .. import serving
from ..reference import cae, rans


def setup(config, params, seed: int, device):
    bank = serving.tile_bank(params, seed, device)
    b = params["batch"]
    if len(bank) % b:
        raise ValueError(f"{len(bank)} tiles do not make batches of {b}")
    core = serving.program_core(config, device)
    frames = [core.encode_tiles(bank[i:i + b])
              for i in range(0, len(bank), b)]
    loop = serving.ClosedLoop(params["clients"], len(frames))
    state = {"config": config, "params": params, "seed": seed,
             "device": device, "frames": frames, "core": core,
             "loop": loop}
    loop.warm(lambda i: request(state, i))
    return state


def request(state, i: int):
    with torch.autograd.profiler.record_function("portbench.decode_tiles"):
        return state["core"].decode_tiles(state["frames"][i])


def trace_spans(state, spans) -> None:
    """Every transposed convolution of the decoder's forward under the
    range ``portbench.deconv`` (``deconv_ms.decode``)."""
    from cnn_autoencoder_tpu_torch.ops.convops import ConvTranspose2dTorch
    for m in state["core"].model.decoder.modules():
        if isinstance(m, ConvTranspose2dTorch):
            spans.attach(m, "portbench.deconv")


def run(state, seconds: float):
    keep = serving.Reservoir(state["params"]["sample"], state["seed"])
    out = state["loop"].run(lambda i: request(state, i), seconds,
                            lambda b, px: keep.offer((b, px)))
    ok = serving.ok_records(out)
    p = state["params"]
    mp = len(ok) * p["batch"] * p["tile"] ** 2 / 1e6
    lat = sorted((r[1] - r[0]) if r[3] else float("inf")
                 for r in out["records"])
    out.update(serving.counts(out))
    out["sample"] = keep.items
    out["e2e"] = {"decode_MPps": mp / out["window_s"]}
    payload = [sum(len(f) - rans.HEADER_BYTES for f in fr)
               for fr in state["frames"]]
    out["work"] = {"batches": len(ok), "tiles": len(ok) * p["batch"],
                   "payload_bytes": sum(payload[r[2]] for r in ok),
                   "p95_ms": 1e3 * float(np.percentile(
                       np.asarray(lat), 95, method="higher"))}
    return out


def check(state, out, product: str = "float32"):
    """{"pixel_off_share": share} of the sampled requests; with
    ``product`` "tf32" the reference in that precision takes the program's
    place (the control)."""
    serving.release(state)
    p_cell, dev = state["params"], state["device"]
    tree, p, tables = serving.reference(state["config"], dev)
    chunk = p_cell["chunk"]

    def synth(sym, prod):
        parts = []
        with torch.no_grad():
            for i in range(0, len(sym), chunk):
                s = torch.from_numpy(sym[i:i + chunk]).to(dev)
                parts.append(cae.pixels(p, s, tree, prod).cpu().numpy())
        return np.concatenate(parts)

    ref = {}
    for b in sorted({b for b, _ in out["sample"]}):
        sym, sound = rans.decode(state["frames"][b], tables,
                                 tree["channels_bn"],
                                 tree["compression_level"])
        ref[b] = (synth(sym, "float32"), sound,
                  synth(sym, product) if product != "float32" else None)
    differ = total = 0
    for b, px in out["sample"]:
        want, sound, control = ref[b]
        got = px if control is None else control
        diff = np.asarray(got) != want
        diff[~sound] = True
        differ += int(diff.sum())
        total += diff.size
    return {"pixel_off_share": differ / total}
