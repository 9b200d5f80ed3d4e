"""Head training in the port (plain versions, on the CPU) against the JAX
package's ``make_train_step`` (``tests/test_class_training.py``'s setup):
the same tiny CAE, a head trainable on the frozen codec, the same batches,
targets and quantization noise, for each class loss (CE on ViT, CE with
aux logits on Inception, BCE and weighted BCE on JNet, BCE with aux logits
on Inception); two SGD steps with losses to 1e-5 relative in float32
and 2e-2 in bf16, the step-1 head gradients to 1e-4 of each parameter's
largest (float32), the encoder bit-equal after the steps; and the class
losses themselves against the JAX functions, label smoothing and class
weights included.  The JAX step runs jitted with one noise draw for both
steps (``jax.random.uniform`` patched before its one trace).  The steps
are SGD's (clipped at norm 1, as every slot): Adam's first step is about
lr * sign(g), which turns the rounding noise of a gradient near 0 into
a whole step either way, so a second loss after Adam holds the two
packages to their noise; ``tests/test_torch_optim.py`` holds Adam itself.
The heads are cut small (ViT at 10, Inception at 6) so that a case's one
JAX compile stays cheap; ``tests/test_torch_heads.py`` holds every block
of them to flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.criteria import classification as jax_cls
from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu.ops import convops as jax_convops
from cnn_autoencoder_tpu.training.loop import \
    make_train_step as jax_train_step
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup_optimizers
from cnn_autoencoder_tpu_torch.criteria import classification as cls
from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models.factory import CAEModel, build_model
from cnn_autoencoder_tpu_torch.training.loop import make_train_step
from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
from cnn_autoencoder_tpu_torch.utils.weights import (state_from_jax,
                                                     state_to_jax)

from tests.test_torch_train_step import _fake_uniform

CAE = dict(channels_org=3, channels_net=8, channels_bn=16,
           compression_level=2, K=4, r=3, act_layer_type="GDN",
           patch_size=32)
PATCH, BATCH, STEPS, LR = 32, 2, 2, 0.05
HEADS = {
    "vit_ce": (dict(class_model_type="ViT", cut_position=10, num_classes=5),
               "RateMSECE", "class_model", "labels"),
    "inception_ce_aux": (dict(class_model_type="InceptionV3",
                              cut_position=6, num_classes=4),
                         "RateMSECEAux", "class_model", "labels"),
    "inception_bce_aux": (dict(class_model_type="InceptionV3",
                               cut_position=6, num_classes=1),
                          "RateMSEBCEAux", "class_model", "binary"),
    "jnet_bce": (dict(seg_model_type="JNet", seg_channels_net=8,
                      seg_channels_bn=32, seg_channels_expansion=2,
                      num_classes=1), "RateMSEBCE", "seg_model", "map"),
    "jnet_weighted_bce": (dict(seg_model_type="JNet", seg_channels_net=8,
                               seg_channels_bn=16, seg_channels_expansion=1,
                               num_classes=1), "RateMSEWeightedBCE",
                          "seg_model", "weighted_map"),
}


def _targets(kind, num_classes, rng):
    if kind == "labels":
        return rng.randint(0, num_classes, BATCH).astype(np.int64)
    if kind == "binary":
        return (rng.rand(BATCH, 1) > 0.5).astype(np.float32)
    labels = (rng.rand(BATCH, PATCH, PATCH, 1) > 0.5).astype(np.float32)
    if kind == "map":
        return labels
    weights = rng.rand(BATCH, PATCH, PATCH, 1).astype(np.float32) * 2
    return np.concatenate([weights, labels], -1)


def _data(kind, num_classes):
    rng = np.random.RandomState(0)
    latent = (BATCH, PATCH // 4, PATCH // 4, CAE["channels_bn"])
    noise = rng.uniform(-0.5, 0.5, latent).astype(np.float32)
    return [(rng.rand(BATCH, PATCH, PATCH, 3).astype(np.float32),
             _targets(kind, num_classes, rng), noise) for _ in range(STEPS)]


def _criterion(setup, name):
    return setup(name, distortion_lambda=0.1, class_error_mu=1.0,
                 class_error_aux_mu=0.5, patch_size=PATCH)


def _run_jax(config, criterion_name, trainable, data, grads, monkeypatch):
    """Losses, class errors and (``grads``) the step-1 head gradients of
    the JAX step, from the port's seeded model carried across (returned,
    as the JAX variables)."""
    from cnn_autoencoder_tpu.models.factory import CAEModel as JaxModel
    from cnn_autoencoder_tpu.models.factory import setup_modules
    from cnn_autoencoder_tpu.models.tasks import make_forward_fn
    from cnn_autoencoder_tpu.training.loop import _net_aux
    start = state_to_jax(build_model(config, torch.Generator().manual_seed(
        0), device="cpu").state_dict(), config)
    model = JaxModel(modules=setup_modules(**config),
                     variables=jax.tree_util.tree_map(jnp.asarray, start),
                     config=config)
    criterion = _criterion(jax_setup_loss, criterion_name)
    optimizers, opt_states, acc = jax_setup_optimizers(
        model.variables, [trainable], mod_optim_algo={trainable: "SGD"})
    step = jax_train_step(model.modules, criterion, optimizers,
                          trainable_modules=[trainable], donate=False)
    lrs = {k: jnp.float32(LR) for k in optimizers}
    variables, losses, class_errors = model.variables, [], []
    monkeypatch.setattr(jax.random, "uniform", _fake_uniform(data[0][2]))
    first = None
    if grads:
        forward = make_forward_fn(model.modules, None, [trainable])
        x0, t0 = jnp.asarray(data[0][0]), jnp.asarray(data[0][1])

        def total(tp):
            full = {**variables, trainable: {**variables[trainable],
                                             "params": tp}}
            out, _ = forward(full, x0, train=True,
                             rngs={"noise": jax.random.PRNGKey(0)})
            ld = criterion(x0, out, targets=t0,
                           net=_net_aux(model.modules, full))
            return jnp.mean(ld["loss"]) + jnp.mean(ld["entropy_loss"])
        first = jax.jit(jax.grad(total))(variables[trainable]["params"])
    for i, (x, t, _) in enumerate(data, start=1):
        variables, opt_states, acc, stats = step(
            variables, opt_states, acc, lrs, jnp.asarray(x),
            jnp.asarray(t), jax.random.PRNGKey(i), jnp.int32(i))
        losses.append(float(stats["loss"]))
        class_errors.append(float(stats["class_error"]))
    monkeypatch.undo()
    return start, losses, class_errors, first


def _run_port(config, criterion_name, trainable, data, variables,
              compute_dtype):
    model = CAEModel(config)
    model.load_state_dict(state_from_jax(variables, config), strict=True)
    encoder = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    head = {k: v.clone() for k, v in
            getattr(model, trainable).state_dict().items()}
    criterion = _criterion(setup_loss, criterion_name)
    optimizers = setup_optimizers(model, [trainable],
                                  mod_optim_algo={trainable: "SGD"})
    step = make_train_step(model, criterion, optimizers,
                           trainable_modules=[trainable],
                           compute_dtype=compute_dtype)
    losses, class_errors, first = [], [], None
    for i, (x, t, noise) in enumerate(data, start=1):
        stats, grads = step(torch.from_numpy(x), {k: LR for k in optimizers},
                            i, noise=torch.from_numpy(noise),
                            t=torch.from_numpy(t))
        losses.append(float(stats["loss"]))
        class_errors.append(float(stats["class_error"]))
        first = first or grads
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, encoder[k]), k
    moved = [k for k, v in getattr(model, trainable).state_dict().items()
             if not torch.equal(v, head[k])]
    return losses, class_errors, first, moved


# every class loss in float32; bf16 on one classifier and one segmenter
STEP_CASES = [(case, "float32") for case in sorted(HEADS)] + [
    ("inception_bce_aux", "bf16"), ("jnet_bce", "bf16")]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for the port's CPU work in this file: the suite
    runs six workers on the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("case,mode", STEP_CASES)
def test_head_step_matches_jax(case, mode, monkeypatch):
    """The frozen codec and a trainable head, two SGD steps: losses and
    class errors within 1e-5 (float32) / 2e-2 (bf16) relative of the JAX
    step's; the step-1 head gradients within 1e-4 of each parameter's
    largest (float32), finite and some non-zero; the encoder bit-equal;
    head parameters moved."""
    head, criterion_name, trainable, kind = HEADS[case]
    config = dict(CAE, **head)
    data = _data(kind, head["num_classes"])
    dtype, rtol = ((torch.float32, 1e-5) if mode == "float32"
                   else (torch.bfloat16, 2e-2))
    jax_convops.set_default_precision("highest" if mode == "float32"
                                      else "bf16")
    try:
        start, ref, ref_class, ref_grads = _run_jax(
            config, criterion_name, trainable, data, mode == "float32",
            monkeypatch)
    finally:
        jax_convops.set_default_precision("highest")
    losses, class_errors, grads, moved = _run_port(
        config, criterion_name, trainable, data, start, dtype)
    np.testing.assert_allclose(losses, ref, rtol=rtol)
    np.testing.assert_allclose(class_errors, ref_class, rtol=rtol)
    flat = [g for g in grads[trainable].values()]
    assert all(torch.isfinite(g).all() for g in flat)
    assert sum(int(torch.count_nonzero(g)) for g in flat) > 0
    assert moved
    if ref_grads is not None:
        from cnn_autoencoder_tpu_torch.utils.weights import head_from_jax
        want = head_from_jax({"params": ref_grads})
        assert set(want) == set(grads[trainable])
        # plus 1e-7 of the head's largest: an attention key bias's exact
        # gradient is 0, so both sides hold rounding noise there
        floor = 1e-7 * max(float(g.abs().max()) for g in want.values())
        for key, ref_g in want.items():
            got = grads[trainable][key]
            np.testing.assert_allclose(
                got.numpy(), ref_g.numpy(), rtol=0,
                atol=1e-4 * float(ref_g.abs().max()) + floor, err_msg=key)


@pytest.mark.parametrize("name,kwargs,target", [
    ("CELoss", {}, "labels"),
    ("CELoss", {"label_smoothing": 0.1}, "labels"),
    ("CELoss", {"weight": [0.5, 1.0, 2.0, 1.5]}, "labels"),
    ("CELoss", {}, "probabilities"),
    ("CELoss", {"label_smoothing": 0.2, "weight": [1, 2, 3, 4]},
     "probabilities"),
    ("CELossWithAux", {"label_smoothing": 0.1}, "labels"),
    ("BCELoss", {}, "binary"),
    ("BCELossWithAux", {}, "binary"),
    ("WeightedBCELoss", {}, "weighted"),
])
def test_class_losses_match_jax(name, kwargs, target):
    rng = np.random.RandomState(5)
    if target in ("labels", "probabilities"):
        pred = rng.randn(3, 6, 6, 4).astype(np.float32) * 3
        t = (rng.randint(0, 4, (3, 6, 6)) if target == "labels"
             else rng.dirichlet(np.ones(4), (3, 6, 6)).astype(np.float32))
    else:
        pred = rng.randn(3, 6, 6, 1).astype(np.float32) * 3
        t = (rng.rand(3, 6, 6, 1) > 0.5).astype(np.float32)
        if target == "weighted":
            t = np.concatenate([rng.rand(3, 6, 6, 1).astype(np.float32), t],
                               -1)
    aux = pred[::-1].copy()
    ref = jax_cls.CLASSLOSS_LIST[name](**kwargs)(
        pred=jnp.asarray(pred), t=jnp.asarray(t), aux_pred=jnp.asarray(aux))
    got = cls.CLASSLOSS_LIST[name](**kwargs)(
        pred=torch.from_numpy(pred), t=torch.from_numpy(t),
        aux_pred=torch.from_numpy(aux))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("criterion", [
    "RateMSECE", "RateMSEBCE", "RateMSEWeightedBCE", "RateMSECEAux",
    "RateMSEBCEAux", "MultiscaleRateMSSSIMCE", "RateMSE"])
def test_criterion_parsing_matches_jax(criterion):
    ref = jax_setup_loss(criterion, distortion_lambda=[0.1],
                         patch_size=PATCH)
    got = setup_loss(criterion, distortion_lambda=[0.1], patch_size=PATCH)
    ref_cls = getattr(ref, "class_loss", None)
    assert (type(got.class_loss).__name__ if got.class_loss else None) == \
        (type(ref_cls).__name__ if ref_cls else None)


def test_unknown_weighted_ce_raises_as_jax():
    with pytest.raises(AssertionError):
        jax_setup_loss("RateMSEWeightedCE")
    with pytest.raises(ValueError, match="class loss"):
        setup_loss("RateMSEWeightedCE")
