"""Training traffic: the program's RateMSE train step
(``training/loop.py:make_train_step``) with per-module Adam, on weights and
patches drawn from the seed, dispatched back to back.

Parameters: ``patch`` (side), ``batch`` (patches a step), ``bank_batches``
(batches held on the device and taken in turn; the ``slide_h`` x
``slide_w`` synthetic slide is cut into exactly that many), ``lam`` (the
distortion weight), ``lr`` (every slot's learning rate), ``steps_checked``
and ``limits``.  Every step's bottleneck noise is drawn on the device from
the seed and handed to the step (``noise=``).

Set-up builds one train step with its model and optimizer state and drives
it through its first ``steps_checked`` steps by the window's own call and
feed; the window goes on from there with the same object, and keeps what
its own first ``steps_checked`` steps give: their noise and losses, the
optimizer's first moments after the first of them and the parameters after
the last (device copies, in the window's time).  After the window the
reference follows all of these steps from the same weights, batches and
noise.  The numbers, for the set-up's steps and for the window's: each
step's loss; the first step's gradient as the optimizer got it (from the
change of Adam's first moment over that step, over 1 - b1); the
parameters' change over the steps, each leaf's norm against the
reference's.  A change leaves out leaves whose reference gradient is under
a thousandth of the median leaf's: they move under Adam by round-off
alone.
"""

import time

import numpy as np
import torch

from .. import seeded
from ..reference import cae

TRAINABLE = ("encoder", "decoder", "fact_ent")
SMALL_GRADIENT = 1e-3


def ref_name(module: str, name: str) -> str:
    """The reference's (checkpoint's) name of a program leaf."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join([module] + parts)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def setup(config, params, seed: int, device):
    from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.training.loop import make_train_step
    from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
    model_cfg = config["model"]
    tree = seeded.init_tree(model_cfg, seeded.generator(seed, 1, device),
                            device)
    checkpoint = dict(_numpy_tree(tree), **model_cfg)
    model = autoencoder_from_state_dict(checkpoint, device=device).train()
    opts = setup_optimizers(model, list(TRAINABLE))
    step = make_train_step(model, setup_loss(
        "RateMSE", distortion_lambda=params["lam"]), opts,
        trainable_modules=list(TRAINABLE), compute_dtype=torch.float32)
    lrs = {k: params["lr"] for k in opts}

    img = seeded.slide(params["slide_h"], params["slide_w"],
                       seeded.generator(seed, 0, device), device)
    patches = seeded.tiles(img, params["patch"])
    b, nb = params["batch"], params["bank_batches"]
    if len(patches) != b * nb:
        raise ValueError(f"{len(patches)} patches for {nb} batches of {b}")
    bank = (patches.float() / 255.0).reshape(nb, b, *patches.shape[1:])
    del img, patches
    side = params["patch"] >> model_cfg["compression_level"]
    noise_shape = (b, side, side, model_cfg["channels_bn"])
    gen = seeded.generator(seed, 2, device)

    def noise():
        return torch.rand(noise_shape, generator=gen, device=device) - 0.5

    leaves = {ref_name(m, n): p for m in TRAINABLE
              for n, p in getattr(model, m).named_parameters()}
    state = {"config": config, "params": params, "seed": seed,
             "device": device, "model": model, "opts": opts, "step": step,
             "lrs": lrs, "bank": bank, "noise": noise, "tree": tree,
             "leaves": leaves, "noises": [], "losses": [],
             "moments": {0: _moments(opts)}, "marks": {0: _copy(leaves)}}
    s = params["steps_checked"]
    for i in range(1, s + 1):
        z = noise()
        stats, _ = step(bank[(i - 1) % nb], lrs, i, noise=z)
        _keep(state, i, z, stats)
    state["next_step"] = s + 1
    return state


def _moments(opts):
    return {ref_name(o.module, n): m.detach().clone()
            for o in opts.values() for n, m in o.mu.items()}


def _copy(leaves):
    return {k: p.detach().clone() for k, p in leaves.items()}


def _keep(state, i: int, z, stats) -> None:
    """What the comparison needs of checked step ``i``: its noise and loss;
    the first moments after the first and the last step of each stretch
    (the set-up's, the window's), the parameters after its last."""
    s = state["params"]["steps_checked"]
    state["noises"].append(z)
    state["losses"].append(stats["loss"].detach())
    if (i - 1) % s == 0 or i % s == 0:
        state["moments"][i] = _moments(state["opts"])
    if i % s == 0:
        state["marks"][i] = _copy(state["leaves"])


def run(state, seconds: float):
    step, bank, lrs = state["step"], state["bank"], state["lrs"]
    noise, nb = state["noise"], len(bank)
    first = i = state["next_step"]
    checked = first + state["params"]["steps_checked"]
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while i < checked or time.perf_counter() < t_end:
        z = noise()
        with torch.autograd.profiler.record_function("portbench.train_step"):
            stats, _ = step(bank[(i - 1) % nb], lrs, i, noise=z)
        if i < checked:
            _keep(state, i, z, stats)
        i += 1
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    state["next_step"] = i
    steps = i - first
    b = state["params"]["batch"]
    return {"attempted": steps, "failed": 0, "window_s": window,
            "e2e": {"train_img_per_s": steps * b / window},
            "work": {"steps": steps, "images": steps * b}}


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in d.items()}


def program_readings(state):
    """The program's readings in the reference's form (``cae.train``)."""
    from cnn_autoencoder_tpu_torch.training.optim import ADAM_B1
    s = state["params"]["steps_checked"]
    mom = state["moments"]
    marks = state["marks"]
    grads = {}
    for i in (1, s + 1):
        before = mom[i - 1]
        grads[i] = _norms({k: (m.double() - ADAM_B1 * before[k].double())
                           / (1 - ADAM_B1) for k, m in mom[i].items()})
    return {"losses": [float(v) for v in state["losses"]],
            "grads": grads,
            "changes": [_norms({k: marks[b][k] - marks[a][k]
                                for k in marks[0]})
                        for a, b in ((0, s), (s, 2 * s))]}


def _gap(got, want, leaves):
    med = float(np.median([want[k] for k in leaves]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in leaves)


def check(state, out, product: str = "float32"):
    """The set-up's steps and the window's first ones against the
    reference's (module docstring): ``loss_gap``, ``grad1_gap``,
    ``change_gap`` and their ``window_`` twins; with ``product`` "tf32"
    the reference in that precision takes the program's place."""
    params, dev = state["params"], state["device"]
    s = params["steps_checked"]
    got = program_readings(state)
    for k in ("model", "opts", "step", "leaves", "moments", "marks"):
        state[k] = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    nb = len(state["bank"])
    batches = [state["bank"][i % nb] for i in range(2 * s)]
    p0 = cae.flat_params(state["tree"], dev)
    cfg = state["config"]["model"]
    args = (p0, batches, state["noises"], cfg, params["lam"], params["lr"])
    kw = {"grad_steps": (1, s + 1), "spans": ((0, s), (s, 2 * s))}
    ref = cae.train(*args, **kw)
    if product != "float32":
        got = cae.train(*args, product=product, **kw)
    out = {}
    for tag, first, g, c in (("", 0, 1, 0), ("window_", s, s + 1, 1)):
        want = ref["grads"][g]
        names = sorted(want)
        med = float(np.median([want[k] for k in names]))
        moved = [k for k in names if want[k] >= SMALL_GRADIENT * med]
        out[tag + "loss_gap"] = max(
            abs(a - b) / abs(b) for a, b in zip(
                got["losses"][first:first + s],
                ref["losses"][first:first + s]))
        out[tag + ("grad_gap" if tag else "grad1_gap")] = _gap(
            got["grads"][g], want, names)
        out[tag + "change_gap"] = _gap(got["changes"][c], ref["changes"][c],
                                       moved)
    return out
