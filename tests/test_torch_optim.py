"""The port's optimizer slots against the JAX package's optax slots: the
same parameters and gradient sequence through both, to 1e-6 relative
(the patterns of tests/test_optim_exactness.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cnn_autoencoder_tpu.training.optim import \
    apply_module_updates as jax_apply
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup
from cnn_autoencoder_tpu_torch.training.optim import (apply_module_updates,
                                                      setup_optimizers)

SHAPES = {"m": {"w": (4, 3), "b": (3,)},
          "fe": {"kernel": (4, 4), "quantiles": (4, 1, 3)}}


class _Holder(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for name, params in arrays.items():
            sub = nn.Module()
            for k, v in params.items():
                sub.register_parameter(k, nn.Parameter(torch.from_numpy(
                    v.copy())))
            self.add_module(name, sub)


def _run(steps, scale, trainable, lrs, **opts):
    """(port params, JAX params) after ``steps`` updates."""
    rng = np.random.RandomState(0)
    arrays = {m: {k: rng.randn(*s).astype(np.float32) for k, s in p.items()}
              for m, p in SHAPES.items()}
    grads = [{m: {k: (rng.randn(*s) * scale).astype(np.float32)
                  for k, s in p.items()} for m, p in SHAPES.items()}
             for _ in range(steps)]

    model = _Holder(arrays)
    slots = setup_optimizers(model, trainable, **opts)
    variables = {m: {"params": {k: jnp.asarray(v) for k, v in p.items()}}
                 for m, p in arrays.items()}
    j_opts, j_states, j_acc = jax_setup(variables, trainable, **opts)
    assert set(slots) == set(j_opts)
    for i, g in enumerate(grads, start=1):
        apply_module_updates(slots, {m: {k: torch.from_numpy(v) for k, v in
                                         p.items()} for m, p in g.items()},
                             lrs, i)
        variables, j_states, j_acc = jax_apply(
            j_opts, {m: {k: jnp.asarray(v) for k, v in p.items()}
                     for m, p in g.items()},
            variables, j_states, j_acc,
            {k: jnp.float32(v) for k, v in lrs.items()}, jnp.int32(i))
    return model, variables


def _assert_same(model, variables):
    for m, p in SHAPES.items():
        for k in p:
            np.testing.assert_allclose(
                getattr(model, m).get_parameter(k).detach().numpy(),
                np.asarray(variables[m]["params"][k]), rtol=1e-6, atol=1e-7,
                err_msg=f"{m}.{k}")


@pytest.mark.parametrize("algo", ["Adam", "AdamW", "SGD"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("scale", [0.01, 5.0])
def test_slots_match_optax(algo, weight_decay, scale):
    """Three steps of each algorithm, with and without weight decay, with
    the global-norm clip idle (scale 0.01) and active (scale 5)."""
    lrs = {"m": 1e-2, "fe": 2e-2, "fe_aux": 3e-2}
    model, variables = _run(
        3, scale, ["m", "fe"], lrs,
        mod_optim_algo={"m": algo, "fe": algo},
        mod_weight_decay={"m": weight_decay, "fe": weight_decay},
        mod_aux_weight_decay={"fe": weight_decay / 2})
    _assert_same(model, variables)


def test_accumulation_and_aux_routing_match_optax():
    """Accumulation by sum every 2 steps on one module; the aux slot of the
    other takes only the quantiles, at its own learning rate."""
    lrs = {"m": 1e-2, "fe": 0.0, "fe_aux": 5e-2}
    model, variables = _run(4, 1.0, ["m", "fe"], lrs,
                            mod_grad_accumulate={"m": 2})
    _assert_same(model, variables)
    # main lr 0: the kernel kept its initial value; the quantiles moved
    rng = np.random.RandomState(0)
    init = {m: {k: rng.randn(*s).astype(np.float32) for k, s in p.items()}
            for m, p in SHAPES.items()}
    np.testing.assert_array_equal(model.fe.kernel.detach().numpy(),
                                  init["fe"]["kernel"])
    assert not np.allclose(model.fe.quantiles.detach().numpy(),
                           init["fe"]["quantiles"])


def test_untrainable_module_gets_no_slot():
    slots = setup_optimizers(_Holder({"m": {"w": np.zeros((2,), np.float32)},
                                      "fe": {}}), ["m", "missing"])
    assert set(slots) == {"m"}
    with pytest.raises(ValueError, match="Unknown optimizer"):
        setup_optimizers(_Holder({"m": {"w": np.zeros((2,), np.float32)}}),
                         ["m"], mod_optim_algo={"m": "Lion"})
