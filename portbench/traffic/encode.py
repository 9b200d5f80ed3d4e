"""Encode traffic: host uint8 tiles in, cae_tpu frames out, through the
program's ``CAETurboCore.encode_tiles`` on the configuration's weights.

Parameters (the cell's file): ``tile`` (side), ``batch`` (tiles a
request), ``slide_h`` x ``slide_w`` (the synthetic slide the bank of
tiles is cut from, every tile of it used), ``clients`` (closed-loop
threads), ``sample`` (requests kept for the comparison), ``chunk`` (tiles
the reference takes at once) and ``limits``.

The comparison: the reference decodes every frame of the sampled requests
with its own rANS reader and tables and compares the symbols with its own
float32 analysis of the same tiles, ``round(y - medians)``.  The number is
the share of symbols that differ; a frame that is not sound counts all of
its symbols.
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
    batches = [bank[i:i + b] for i in range(0, len(bank), b)]
    core = serving.program_core(config, device)
    loop = serving.ClosedLoop(params["clients"], len(batches))
    state = {"config": config, "params": params, "seed": seed,
             "device": device, "batches": batches, "core": core,
             "loop": loop}
    loop.warm(lambda i: request(state, i))
    state["frame_bytes"] = [sum(len(f) for f in request(state, i))
                            for i in range(len(batches))]
    return state


def request(state, i: int):
    with torch.autograd.profiler.record_function("portbench.encode_tiles"):
        return state["core"].encode_tiles(state["batches"][i])


def counters(state):
    core = state["core"]
    return {"capacity_retries": core.capacity_retries,
            "host_fallbacks": core.host_fallbacks}


def run(state, seconds: float):
    keep = serving.Reservoir(state["params"]["sample"], state["seed"])
    before = counters(state)
    out = state["loop"].run(lambda i: request(state, i), seconds,
                            lambda b, frames: keep.offer((b, frames)))
    after = counters(state)
    ok = serving.ok_records(out)
    p = state["params"]
    mp = len(ok) * p["batch"] * p["tile"] ** 2 / 1e6
    out.update(serving.counts(out))
    out["sample"] = keep.items
    out["e2e"] = {"encode_MPps": mp / out["window_s"]}
    out["work"] = {"batches": len(ok), "tiles": len(ok) * p["batch"],
                   "retries": sum(after.values()) - sum(before.values()),
                   "payload_bytes": sum(state["frame_bytes"][r[2]]
                                        for r in ok)
                   - rans.HEADER_BYTES * len(ok) * p["batch"]}
    return out


def _reference_symbols(p, config, tiles, chunk, device, product):
    parts = []
    with torch.no_grad():
        for i in range(0, len(tiles), chunk):
            t = torch.from_numpy(tiles[i:i + chunk]).to(device)
            parts.append(cae.symbols(p, t, config, product).cpu().numpy())
    return np.concatenate(parts)


def check(state, out, product: str = "float32"):
    """{"symbol_flip_share": share} of the sampled requests.  With
    ``product`` "tf32" the reference in that precision takes the program's
    place (the control)."""
    serving.release(state)
    p_cell, dev = state["params"], state["device"]
    tree, p, tables = serving.reference(state["config"], dev)
    used = sorted({b for b, _ in out["sample"]})
    ref = {b: _reference_symbols(p, tree, state["batches"][b],
                                 p_cell["chunk"], dev, "float32")
           for b in used}
    differ = total = 0
    for b, frames in out["sample"]:
        if product == "float32":
            sym, sound = rans.decode(frames, tables, tree["channels_bn"],
                                     tree["compression_level"])
        else:
            sym = _reference_symbols(p, tree, state["batches"][b],
                                     p_cell["chunk"], dev, product)
            sound = np.ones(len(sym), bool)
        diff = sym != ref[b]
        diff[~sound] = True
        differ += int(diff.sum())
        total += diff.size
    return {"symbol_flip_share": differ / total}
