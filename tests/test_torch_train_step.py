"""The port's whole training step (plain versions, on the CPU) against the
JAX package's ``make_train_step`` from the same initialisation, batches and
quantization noise, in float32 and bf16; the eval step; a frozen decoder;
and checkpoints saved by the port and read by both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu.models.factory import build_model as jax_build_model
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.models.tasks import \
    make_forward_fn as jax_make_forward_fn
from cnn_autoencoder_tpu.ops import convops as jax_convops
from cnn_autoencoder_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from cnn_autoencoder_tpu.training.loop import make_eval_step as jax_eval_step
from cnn_autoencoder_tpu.training.loop import \
    make_train_step as jax_train_step
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup_optimizers
from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models.factory import (
    CAEModel, autoencoder_from_state_dict, build_model)
from cnn_autoencoder_tpu_torch.training.checkpoint import save_checkpoint
from cnn_autoencoder_tpu_torch.training.loop import (make_eval_step,
                                                     make_train_step, valid)
from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
from cnn_autoencoder_tpu_torch.utils.weights import (state_from_jax,
                                                     state_to_jax)

CONFIG = dict(channels_org=3, channels_net=64, channels_bn=16,
              compression_level=3, K=4, r=3, act_layer_type="GDN")
PATCH, BATCH, STEPS, LR = 32, 2, 3, 1e-4
LATENT = (BATCH, PATCH // 8, PATCH // 8, CONFIG["channels_bn"])


def _data():
    rng = np.random.RandomState(0)
    xs = [np.clip(rng.rand(BATCH, PATCH, PATCH, 3) * 0.7 + 0.15
                  + rng.randn(BATCH, PATCH, PATCH, 3) * 0.03, 0, 1)
          .astype(np.float32) for _ in range(STEPS)]
    noises = [rng.uniform(-0.5, 0.5, LATENT).astype(np.float32)
              for _ in range(STEPS)]
    return xs, noises


def _models():
    j_model = jax_build_model(jax.random.PRNGKey(0),
                              input_size=(PATCH, PATCH), **CONFIG)
    t_model = CAEModel(CONFIG)
    t_model.load_state_dict(state_from_jax(j_model.variables, CONFIG),
                            strict=True)
    assert [getattr(t_model.encoder, n).fused
            for n in t_model.encoder.names] == [False, True, False]
    return j_model, t_model


_UNIFORM = jax.random.uniform


def _fake_uniform(noise):
    """jax.random.uniform giving ``noise`` where the bottleneck draws it (a
    draw of the latent's shape); other draws are left as they were."""
    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if tuple(shape) != noise.shape:
            return _UNIFORM(key, shape, dtype, minval, maxval)
        return jnp.asarray(noise).astype(dtype)
    return uniform


def _run_jax(j_model, trainable, xs, noises, monkeypatch):
    """Losses per step, step-1 gradients and final variables of the JAX
    step, run op by op so each step sees its own noise."""
    criterion = jax_setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers, opt_states, acc = jax_setup_optimizers(j_model.variables,
                                                       trainable)
    step = jax_train_step(j_model.modules, criterion, optimizers,
                          trainable_modules=trainable, donate=False)
    lrs = {k: jnp.float32(LR) for k in optimizers}
    variables, losses = j_model.variables, []
    # step-1 gradients from the same composition (loop.py:271-291 there)
    forward = jax_make_forward_fn(j_model.modules, None, trainable)
    cdt = jax_convops.get_default_compute_dtype()
    x0 = jnp.asarray(xs[0])

    def total(tp):
        full = {k: ({**variables[k], "params": tp[k]} if k in tp
                    else variables[k]) for k in variables}
        out, _ = forward(full, x0 if cdt is None else x0.astype(cdt),
                         train=True, rngs={"noise": jax.random.PRNGKey(0)})
        ld = criterion(x0, out, net={
            "fact_ent_params": full["fact_ent"]["params"], "num_filters": 4})
        return jnp.mean(ld["loss"]) + jnp.mean(ld["entropy_loss"])

    with jax.disable_jit():
        monkeypatch.setattr(jax.random, "uniform", _fake_uniform(noises[0]))
        grads = jax.grad(total)({k: variables[k]["params"]
                                 for k in trainable})
        for i, (x, noise) in enumerate(zip(xs, noises), start=1):
            monkeypatch.setattr(jax.random, "uniform", _fake_uniform(noise))
            variables, opt_states, acc, stats = step(
                variables, opt_states, acc, lrs, jnp.asarray(x), None,
                jax.random.PRNGKey(i), jnp.int32(i))
            losses.append(float(stats["loss"]))
    monkeypatch.undo()
    return losses, grads, variables


def _run_port(t_model, trainable, xs, noises, compute_dtype):
    criterion = setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers = setup_optimizers(t_model, trainable)
    step = make_train_step(t_model, criterion, optimizers,
                           trainable_modules=trainable,
                           compute_dtype=compute_dtype)
    losses, first = [], None
    for i, (x, noise) in enumerate(zip(xs, noises), start=1):
        stats, grads = step(torch.from_numpy(x), {k: LR for k in optimizers},
                            i, noise=torch.from_numpy(noise))
        losses.append(float(stats["loss"]))
        first = first or grads
    return losses, first


def _flat_port_grads(grads):
    return {f"{m}.{k}": v for m, g in grads.items() for k, v in g.items()}


@pytest.mark.parametrize("trainable", [("encoder", "decoder", "fact_ent"),
                                       ("encoder", "fact_ent")],
                         ids=["all", "frozen_decoder"])
def test_float32_step_matches_jax(trainable, monkeypatch):
    """float32: losses to 1e-5 relative at each step, step-1 gradients to
    1e-4 of each parameter's max, parameters after three Adam steps to
    3 lr * steps absolute (Adam's first steps are about lr * sign(g), so a
    gradient near 0 may move its parameter either way).  With the decoder
    frozen, its parameters stay as they were and get no gradient."""
    trainable = list(trainable)
    xs, noises = _data()
    j_model, t_model = _models()
    before = {k: v.clone() for k, v in t_model.state_dict().items()}
    j_losses, j_grads, j_vars = _run_jax(j_model, trainable, xs, noises,
                                         monkeypatch)
    t_losses, t_grads = _run_port(t_model, trainable, xs, noises,
                                  torch.float32)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert set(t_grads) == set(trainable)

    ref = state_from_jax({k: {"params": v} for k, v in j_grads.items()},
                         CONFIG)
    got = _flat_port_grads(t_grads)
    assert set(got) == set(ref)
    for k, g in got.items():
        scale = float(ref[k].abs().max()) + 1e-12
        err = float((g - ref[k]).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)

    after = t_model.state_dict()
    for k, v in state_from_jax(j_vars, CONFIG).items():
        assert float((after[k] - v).abs().max()) <= 3 * LR * STEPS, k
        if k.startswith("decoder") and "decoder" not in trainable:
            assert torch.equal(after[k], before[k]), k

    # the eval step from the same variables
    j_eval = jax_eval_step(j_model.modules, jax_setup_loss(
        "RateMSE", distortion_lambda=0.01))
    t_eval = make_eval_step(t_model, setup_loss("RateMSE",
                                                distortion_lambda=0.01))
    j_stats = j_eval(j_vars, jnp.asarray(xs[0]), None)
    t_model.load_state_dict(state_from_jax(j_vars, CONFIG))
    t_stats = t_eval(torch.from_numpy(xs[0]))
    for key in ("loss", "rate_loss", "dist_loss", "entropy_loss"):
        np.testing.assert_allclose(float(t_stats[key]), float(j_stats[key]),
                                   rtol=1e-5, err_msg=key)
    mean_loss, avg = valid(t_eval, [torch.from_numpy(x) for x in xs[:2]])
    assert np.isfinite(mean_loss) and "val_rate_loss" in avg


def test_bf16_step_matches_jax(monkeypatch):
    """bf16 compute (JAX: set_default_precision("bf16"), its default GDN
    path; the port: K2/K3 and K4's bf16 plain versions): losses to 2e-2
    relative at each step, and every step-1 gradient finite and of the
    JAX gradient's scale (2e-1 of its max: bf16 cotangents through three
    stages)."""
    trainable = ["encoder", "decoder", "fact_ent"]
    xs, noises = _data()
    j_model, t_model = _models()
    jax_convops.set_default_precision("bf16")
    try:
        j_losses, j_grads, _ = _run_jax(j_model, trainable, xs, noises,
                                        monkeypatch)
    finally:
        jax_convops.set_default_precision("highest")
    t_losses, t_grads = _run_port(t_model, trainable, xs, noises,
                                  torch.bfloat16)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2)
    ref = state_from_jax({k: {"params": v} for k, v in j_grads.items()},
                         CONFIG)
    for k, g in _flat_port_grads(t_grads).items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
        scale = float(ref[k].abs().max()) + 1e-12
        assert float((g - ref[k]).abs().max()) <= 2e-1 * scale, k


def test_unported_compute_dtype_raises():
    t_model = CAEModel(CONFIG)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(t_model, setup_loss("RateMSE"), {},
                        compute_dtype=torch.float16)


def test_build_model_initialisers():
    """build_model draws from the generator (same seed, same weights) with
    the JAX package's initialisers: bounds and constants as there, the
    deterministic parameters equal to JAX's."""
    m1 = build_model(CONFIG, torch.Generator().manual_seed(3), device="cpu")
    m2 = build_model(CONFIG, torch.Generator().manual_seed(3), device="cpu")
    assert m1.training
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    ref = state_from_jax(jax_build_model(
        jax.random.PRNGKey(0), input_size=(PATCH, PATCH), **CONFIG).variables,
        CONFIG)
    for k, v in m1.state_dict().items():
        assert v.shape == ref[k].shape, k
        if k.endswith(".weight"):
            fan = v.shape[0] * 9 + v.shape[1] * 9
            bound = np.sqrt(2 / 1.01) * np.sqrt(6.0 / fan)
            assert float(v.abs().max()) <= bound and float(v.std()) > 0, k
        elif k.startswith("fact_ent.bias"):
            assert float(v.abs().max()) <= 0.5, k
        else:
            assert torch.equal(v, ref[k]), k


def test_checkpoint_save_reads_in_both_packages(tmp_path):
    """save_checkpoint -> the JAX package's load_checkpoint gives the same
    arrays -> its model encodes like the port's; the port reloads it."""
    model = build_model(CONFIG, torch.Generator().manual_seed(1),
                        device="cpu")
    path = str(tmp_path / "port.msgpack")
    save_checkpoint(path, model)
    state = jax_load_checkpoint(path)
    expected = state_to_jax(model.state_dict(), model.config)
    for module, tree in expected.items():
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        got = dict(jax.tree_util.tree_flatten_with_path(state[module])[0])
        assert len(got) == len(flat)
        for p, v in flat:
            assert got[p].dtype == np.float32
            np.testing.assert_array_equal(got[p], v)
    for k, v in CONFIG.items():
        assert state[k] == v

    j_model = jax_from_state_dict(path)
    x = np.random.RandomState(2).rand(1, PATCH, PATCH, 3).astype(np.float32)
    with torch.no_grad():
        y_t = model.encoder(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, np.asarray(j_model.encode(
        jnp.asarray(x))), rtol=1e-4, atol=1e-5)

    again = autoencoder_from_state_dict(path, device="cpu")
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
