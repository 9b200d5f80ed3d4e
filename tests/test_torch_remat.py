"""``make_train_step(remat=True)`` (``torch.utils.checkpoint`` around the
encoder's and the decoder's forwards) against the same step without remat
in the port, and against the JAX package's ``remat`` step, on the CPU.

Remat changes memory, not numerics: the JAX package's own test
(``tests/test_optim_extras.py:78-101``) holds the loss to 1e-6 relative and
the new variables to 1e-5; the same bounds hold here, with the dropout
masks, the bottleneck's noise and the batch norms' statistics, which must
not be drawn or folded twice."""

import jax
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.factory import build_model as jax_build_model
from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models.factory import CAEModel
from cnn_autoencoder_tpu_torch.training.loop import make_train_step
from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
from cnn_autoencoder_tpu_torch.utils.weights import state_from_jax

from tests.test_torch_arch_options import (LR, TRAINABLE, _jax_steps,
                                           _port_steps, _step_config,
                                           _step_data, _step_masks)

MODES = {"float32": torch.float32, "bf16": torch.bfloat16}


def _model(cfg):
    j_model = jax_build_model(jax.random.PRNGKey(0), input_size=(16, 16),
                              **cfg)
    t_model = CAEModel(cfg)
    t_model.load_state_dict(state_from_jax(j_model.variables, cfg))
    return j_model, t_model


def _run(cfg, weights, remat, compute_dtype, seed=3):
    """Two steps from ``weights`` with masks and noise drawn from one
    seeded generator: (losses, state dict after, encoder forwards run)."""
    model = CAEModel(cfg)
    model.load_state_dict(weights)
    calls = []
    model.encoder.down_0.register_forward_hook(
        lambda *_: calls.append(1))
    optimizers = setup_optimizers(model, TRAINABLE)
    step = make_train_step(model, setup_loss("RateMSE",
                                             distortion_lambda=0.01),
                           optimizers, trainable_modules=TRAINABLE,
                           compute_dtype=compute_dtype, remat=remat)
    gen = torch.Generator().manual_seed(seed)
    xs, _ = _step_data()
    losses = [float(step(torch.from_numpy(x), {k: LR for k in optimizers},
                         i, generator=gen)[0]["loss"])
              for i, x in enumerate(xs, start=1)]
    return losses, model.state_dict(), len(calls)


@pytest.mark.parametrize("kind,mode", [("B", "float32"), ("B", "bf16"),
                                       ("R", "float32"), ("R", "bf16")])
def test_remat_matches_the_plain_step(kind, mode):
    """The same two steps (masks and noise from the same seeded generator)
    with and without remat: losses within 1e-6 relative, every parameter
    and running statistic within 1e-5; with remat the encoder's forward
    runs twice a step (the recompute), without it once."""
    cfg = _step_config(kind)
    _, t_model = _model(cfg)
    weights = {k: v.clone() for k, v in t_model.state_dict().items()}
    plain, plain_state, plain_calls = _run(cfg, weights, False, MODES[mode])
    remat, remat_state, remat_calls = _run(cfg, weights, True, MODES[mode])
    assert (plain_calls, remat_calls) == (2, 4)
    np.testing.assert_allclose(remat, plain, rtol=1e-6)
    assert set(remat_state) == set(plain_state)
    for k, v in remat_state.items():
        np.testing.assert_allclose(v.numpy(), plain_state[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    if kind == "B":
        assert not torch.equal(remat_state["encoder.down_0.norm_down.var"],
                               weights["encoder.down_0.norm_down.var"])


def test_remat_matches_jax_remat(monkeypatch):
    """The residual model's remat step against the JAX package's
    ``make_train_step(remat=True)`` with the same noise: losses of two
    float32 steps within 1e-5."""
    cfg = _step_config("R")
    j_model, t_model = _model(cfg)
    xs, noises = _step_data()
    masks = _step_masks("R", len(xs))
    j_losses, _ = _jax_steps(j_model, xs, noises, masks, monkeypatch,
                             remat=True)
    t_losses = _port_steps(t_model, xs, noises, masks, torch.float32,
                           remat=True)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
