"""Refit a checkpoint's entropy-model quantiles by exact bisection: the
port of the JAX package's ``scripts/refit_quantiles.py``.

    python -m cnn_autoencoder_tpu_torch.tools.refit_quantiles \
        ckpt.msgpack [ckpt2 ...]

Overwrites each checkpoint in place with bisection-solved quantiles
(``models/entropy.py:fit_quantiles_bisect``) and prints the aux loss before
and after.  Use after training runs whose gradient-based quantile fit may
not have converged (peaked low-rate models); serving CDF tables bake from
the quantiles, so an off-median fit widens every bitstream.  The bisection
runs on the host over ``[-256, 256]``, and a quantile outside that bracket
comes back clamped to its end without a word, as in the JAX package.  The
aux loss runs on ``device`` (None: the card).
"""

import sys

import torch

from ..models.entropy import aux_loss_fn, fit_quantiles_bisect
from ..training.checkpoint import load_checkpoint, save_checkpoint
from ..utils.device import full_f32, resolve_device


def refit(path, device=None):
    """Refit ``path``'s quantiles in place; returns (aux before, after)."""
    dev = resolve_device(device)
    state = load_checkpoint(path)
    p = dict(state["fact_ent"]["params"])
    num_filters = sum(1 for key in p if key.startswith("matrix_")) - 1

    def aux(params):
        with torch.no_grad(), full_f32():
            return float(aux_loss_fn({k: torch.as_tensor(v, device=dev)
                                      for k, v in params.items()},
                                     num_filters))

    before = aux(p)
    p["quantiles"] = fit_quantiles_bisect(
        {k: torch.as_tensor(v) for k, v in p.items()}, num_filters).numpy()
    after = aux(p)
    state["fact_ent"] = {**state["fact_ent"], "params": p}
    save_checkpoint(path, state)
    return before, after


def main(argv=None, device=None):
    for path in (sys.argv[1:] if argv is None else argv):
        before, after = refit(path, device)
        print(f"{path}: aux {before:.2f} -> {after:.2f}")


if __name__ == "__main__":
    main()
