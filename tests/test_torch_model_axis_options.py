"""The model mesh axis for every architecture besides the flagship's, on
the CPU: residual units (R), batch norm with its running statistics and
dropout (B), grouped convolutions, the classifier heads (ViT, ResNet,
InceptionV3) and the segmenters (UNet, JNet), against one process and
against the JAX package on the 8 CPU devices ``tests/conftest.py``
spoofs.

* (a) ``shard_state`` against every JAX ``shard_variables`` device shard
  (``batch_stats`` and the heads' trees included), and ``gather_state``
  back to the state;
* (b) one launch of 4 gloo ranks (data 2 x model 2, a ``file://``
  rendezvous in its work directory, its own timeout), whose processes
  run 2 SGD steps of each of ``tests/torch_model_axis_ranks.py:ARCHS``
  one after another (R, B with dropout 0.1, grouped 4 / 4 / 4, JNet with
  batch norm trained with its codec, ViT on the frozen codec): losses,
  step-1 gradients, gathered parameters and B's running statistics held
  to one process's, and for R, B, 4 / 4 / 4 and JNet to JAX's step under
  ``create_mesh(data=2, model=2)`` with ``shard_variables`` (losses, and
  the variables after steps 1 and 2: SGD's step 1 is the clipped
  gradient); each rank's optimizers hold its shards alone;
* (c) in the same ranks, the eval forwards of ResNet and InceptionV3
  (whose batch norms' running statistics are held as shards) against one
  process's;
* (d) both serving cores over a ``(2, 2)`` mesh with R and B models:
  frames byte-equal to the data-only mesh's.

Every tolerance is 1e-5 of the reference tensor's largest magnitude; the
attention's key biases, whose exact gradient is 0, are held to 1e-5 of
their head's largest parameter.  The steps use SGD
(``tests/torch_parallel_ranks.py`` says why)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.models.factory import CAEModel as JaxModel
from cnn_autoencoder_tpu.models.factory import setup_modules
from cnn_autoencoder_tpu.parallel import mesh as jax_mesh
from cnn_autoencoder_tpu.training.loop import \
    make_train_step as jax_train_step
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup_optimizers
from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu_torch.models.factory import build_model
from cnn_autoencoder_tpu_torch.models.tasks import draw_masks
from cnn_autoencoder_tpu_torch.parallel.mesh import (create_mesh,
                                                     gather_state,
                                                     shard_axes, shard_state)
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.utils.weights import (state_from_jax,
                                                     state_to_jax)

from tests.test_torch_heads import CASES as HEAD_CASES
from tests.test_torch_heads import _port as head_port
from tests.test_torch_parallel import _tiles
from tests.test_torch_parallel_train import _close, _env, _run
from tests.test_torch_train_cli import _dropout_masks
from tests.torch_model_axis_ranks import (ALGO, ARCHS, EVAL_HEADS, LR,
                                          OPTION_BATCH, OPTION_SIDE,
                                          OPTION_STEPS, bare_steps,
                                          head_forward)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_model_axis_ranks.py")
# the architectures held to JAX's sharded step too
WITH_JAX = ("R", "B", "G444", "JNet")
# the attention's key biases: softmax ignores them, so their exact
# gradient is 0 and a computed one is rounding noise
ZERO_GRAD = ".self_attention.key.bias"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this process's work: the suite runs six
    workers, and the ranks run beside this process."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _model(config):
    return build_model(config, torch.Generator().manual_seed(0),
                       device="cpu")


def _device_shards(variables, model_size):
    """JAX's ``shard_variables`` of ``variables`` over a mesh of
    ``model_size`` model indices: each model index's device shard (the
    first data index's), as numpy trees."""
    mesh = jax_mesh.create_mesh(data=8 // model_size, model=model_size)
    placed = jax_mesh.shard_variables(mesh, variables)
    out = []
    for j in range(model_size):
        dev = mesh.devices[0, j]
        out.append(jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == dev)), placed))
    return out


def _assert_shards_as_jax(state, config, model_size):
    """``shard_state`` is JAX's shard on every model index, some leaf is
    cut, and ``gather_state`` gives the state back."""
    variables = state_to_jax(state, config)
    shards = []
    for j, on_dev in enumerate(_device_shards(variables, model_size)):
        want = state_from_jax(on_dev, config,
                              _cut_groups(config, model_size))
        got = shard_state(state, config, j, model_size)
        assert got.keys() == want.keys() == state.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)
        shards.append(got)
    axes = shard_axes(state, config, model_size)
    back = gather_state(shards, axes)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    return axes


def _cut_groups(config, model_size):
    """A grouped decoder's transposed convolutions at ``model_size``:
    {"up_i/<layer>": groups of a shard} where JAX cuts the kernel (its
    groups are the unit's input width, its outputs the unit's)."""
    if not config.get("groups"):
        return {}
    width = config["channels_net"]
    if width % model_size or width < 2 * model_size:
        return {}
    layers = ["deconv_up"] + (["res_deconv1"] if config.get("use_residual")
                              else [])
    return {f"up_{i}/{layer}": width // model_size
            for i in range(config["compression_level"]) for layer in layers}


# -- (a) the shards ------------------------------------------------------------


@pytest.mark.parametrize("arch,model_size", [
    ("R", 2), ("R", 4), ("B", 2), ("B", 4)])
def test_codec_shards_equal_jax(arch, model_size):
    """R and B (``batch_stats`` included) at m = 2 and 4."""
    config = ARCHS[arch][0]
    model = _model(config)
    state = model.state_dict()
    if arch == "B":
        gen = torch.Generator().manual_seed(1)
        for k, v in state.items():
            if k.endswith((".mean", ".var")):
                v.add_(torch.rand(v.shape, generator=gen))
    axes = _assert_shards_as_jax(state, config, model_size)
    assert axes["encoder.down_1.conv_down.weight"] == 0
    assert axes["decoder.up_0.deconv_up.weight"] == 1
    if arch == "R":
        assert axes["encoder.down_1.res_conv1.weight"] == 0
        assert axes["decoder.up_0.res_deconv1.weight"] == 1
        assert axes["decoder.up_0.gdn_res.gamma"] == 0
        assert axes["encoder.down_0.res_conv1.weight"] is None
    else:
        for stat in ("mean", "var", "scale", "bias"):
            assert axes[f"encoder.down_0.norm_down.{stat}"] == 0
        assert axes["decoder.up_1.norm_up.mean"] is None


@pytest.mark.parametrize("width,model_size", [(4, 2), (3, 3)])
def test_grouped_shards_equal_jax(width, model_size):
    """Grouped 4 / 4 / 4 at m=2 (every leaf cut; a transposed
    convolution's shard the input rows of its rank's whole groups) and
    3 / 3 / 3 at m=3 (the GDN gammas and the bottleneck cut)."""
    config = dict(ARCHS["G444"][0], channels_org=width, channels_net=width,
                  channels_bn=width)
    state = _model(config).state_dict()
    axes = _assert_shards_as_jax(state, config, model_size)
    cut = {k for k, a in axes.items() if a is not None}
    if width == 4:
        assert cut == set(state)
        assert axes["decoder.up_0.deconv_up.weight"] == 0
        assert axes["encoder.down_0.conv_down.weight"] == 0
    else:
        assert "encoder.down_0.gdn_down.gamma" in cut
        assert "fact_ent.quantiles" in cut
        assert not any(k.endswith(".weight") for k in cut)


@pytest.mark.parametrize("case", ["vit_cut10", "resnet_cut3",
                                  "inception_from_patch", "unet", "jnet"])
def test_head_shards_equal_jax(case):
    """The heads at the small widths ``tests/test_torch_heads.py`` builds
    them, under ``class_model`` / ``seg_model``; InceptionV3's batch
    norms' running statistics among its cut leaves."""
    kind, kwargs, shape = HEAD_CASES[case]
    module = "seg_model" if kind in ("UNet", "JNet") else "class_model"
    head = head_port(kind, kwargs, shape)
    state = {f"{module}.{k}": v for k, v in head.state_dict().items()}
    axes = _assert_shards_as_jax(state, {}, 2)
    cut = {k for k, a in axes.items() if a is not None}
    assert cut
    for k in cut:
        assert state[k].dim() in (1, 4), k
    if kind == "ViT":
        assert axes["class_model.conv_proj.weight"] == 0
        assert axes["class_model.class_token"] is None
        assert axes["class_model.encoder_layer_0.self_attention.key."
                    "kernel"] is None
    if kind == "InceptionV3":
        assert axes["class_model.Mixed_7b.branch1x1.bn.mean"] == 0


# -- (b) and (c): one launch of 4 ranks ------------------------------------------


def _inputs():
    """Each architecture's global batches and targets, each eval head's
    latent, from a seed."""
    rng = np.random.RandomState(0)
    out = {}
    for arch, (config, _, _, kind) in ARCHS.items():
        for i in range(OPTION_STEPS):
            out[f"{arch}/x{i}"] = np.clip(
                rng.rand(OPTION_BATCH, OPTION_SIDE, OPTION_SIDE,
                         config["channels_org"]) * 0.7 + 0.15, 0,
                1).astype(np.float32)
            if kind == "map":
                out[f"{arch}/t{i}"] = (rng.rand(
                    OPTION_BATCH, OPTION_SIDE, OPTION_SIDE, 1) > 0.5
                ).astype(np.float32)
            elif kind == "labels":
                out[f"{arch}/t{i}"] = rng.randint(
                    0, config["num_classes"], OPTION_BATCH).astype(np.int64)
    for kind, (_, shape) in EVAL_HEADS.items():
        out[f"{kind}/x"] = rng.randn(*shape).astype(np.float32)
    return out


def _draws(arch):
    """The noise and dropout masks one process draws from its generator
    (seed 5, ``bare_steps``' default), step by step: each step's masks,
    then its noise."""
    config = ARCHS[arch][0]
    model = _model(config)
    gen = torch.Generator().manual_seed(5)
    side = OPTION_SIDE // 2 ** config["compression_level"]
    latent = (OPTION_BATCH, side, side, config["channels_bn"])
    noises, masks = [], []
    for _ in range(OPTION_STEPS):
        masks.append(draw_masks(model, ["encoder", "decoder"], OPTION_BATCH,
                                gen, torch.device("cpu")))
        noises.append(torch.rand(latent, generator=gen) - 0.5)
    return noises, masks


def _jax_sharded_steps(arch, inputs, noises, masks, monkeypatch):
    """JAX ``make_train_step`` of the architecture's seed-0 port model
    carried across, under ``create_mesh(data=2, model=2)`` with its
    variables and optimizer state placed by ``shard_variables`` and its
    batches by ``shard_batch``, jitted again with the noise and the
    dropout masks as arguments.  Returns (losses, variables after each
    step)."""
    config, trainable, criterion, kind = ARCHS[arch]
    start = state_to_jax(_model(config).state_dict(), config)
    j_model = JaxModel(modules=setup_modules(**config),
                       variables=jax.tree_util.tree_map(jnp.asarray, start),
                       config=config)
    optimizers, opt_states, acc = jax_setup_optimizers(
        j_model.variables, trainable,
        mod_optim_algo={k: ALGO for k in trainable})
    step_fn = jax_train_step(
        j_model.modules, jax_setup_loss(criterion, distortion_lambda=0.01,
                                        class_error_mu=1.0,
                                        patch_size=OPTION_SIDE),
        optimizers, trainable_modules=trainable, donate=False).__wrapped__
    current = {}
    uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                     maxval=1.0):
        if tuple(shape) != current["noise"].shape:
            return uniform(key, shape, dtype, minval, maxval)
        return current["noise"].astype(dtype)

    def with_inputs(noise, step_masks, *args):
        current.update(noise=noise, masks=list(step_masks))
        with _dropout_masks(current):
            return step_fn(*args)

    step = jax.jit(with_inputs)
    lrs = {k: jnp.float32(LR) for k in optimizers}
    mesh = jax_mesh.create_mesh(data=2, model=2)
    losses, after = [], []
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    with mesh:
        variables = jax_mesh.shard_variables(mesh, j_model.variables)
        opt_states = jax_mesh.shard_variables(mesh, opt_states)
        acc = jax_mesh.shard_variables(mesh, acc)
        for i, (noise, m) in enumerate(zip(noises, masks)):
            jm = [jnp.asarray(m[mod][u].numpy())
                  for mod in ("encoder", "decoder") for u in m[mod]]
            t = inputs.get(f"{arch}/t{i}")
            variables, opt_states, acc, stats = step(
                jnp.asarray(noise.numpy()), jm, variables, opt_states, acc,
                lrs, jax_mesh.shard_batch(mesh, jnp.asarray(
                    inputs[f"{arch}/x{i}"])),
                None if t is None else jax_mesh.shard_batch(
                    mesh, jnp.asarray(t)),
                jax.random.PRNGKey(i + 1), jnp.int32(i + 1))
            losses.append(float(stats["loss"]))
            after.append(jax.tree_util.tree_map(np.asarray, variables))
    monkeypatch.undo()
    return losses, after


def _as_port(tree, config):
    return {k: v.numpy() for k, v in state_from_jax(tree, config).items()}


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The 4 ranks' results, and meanwhile one process's: {arch: (losses,
    step-1 gradients, state, numel, optimized)} and {head: (logits,
    aux)}."""
    work = tmp_path_factory.mktemp("options")
    inputs = _inputs()
    np.savez(work / "options.npz", **inputs)
    procs = [subprocess.Popen(
        [sys.executable, RANKS, "options", str(work), "2", "2"],
        env=_env(COORDINATOR_ADDRESS="file://" + str(work / "rdzv"),
                 NUM_PROCESSES="4", PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        one = {}
        for arch, (_, _, _, kind) in ARCHS.items():
            xs = [inputs[f"{arch}/x{i}"] for i in range(OPTION_STEPS)]
            ts = ([inputs[f"{arch}/t{i}"] for i in range(OPTION_STEPS)]
                  if kind else None)
            report = {}
            one[arch] = bare_steps(xs, arch=arch, ts=ts, report=report) \
                + (report["optimized"],)
        heads = {kind: head_forward(kind, inputs[f"{kind}/x"])
                 for kind in EVAL_HEADS}
        _run(procs, timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [dict(np.load(work / f"options{r}.npz")) for r in range(4)]
    return inputs, one, heads, ranks


@pytest.mark.parametrize("arch", list(ARCHS))
def test_four_ranks_equal_one_process(launch, arch, monkeypatch):
    """(b) Losses, step-1 gradients, gathered parameters and running
    statistics of every rank against one process's; each rank's shards
    half of a cut leaf and its optimizers' parameters one process's less
    the shards' other halves; for R, B, 4 / 4 / 4 and JNet, one process
    against JAX's sharded step."""
    inputs, one, _, ranks = launch
    losses, grads, state, numel, optimized = one[arch]
    config, trainable, _, _ = ARCHS[arch]
    for k, g in grads.items():
        assert np.isfinite(g).all(), k
        if not k.endswith(ZERO_GRAD):
            assert np.abs(g).max() > 0, k
    scale = max(float(np.abs(v).max()) for v in state.values())

    def held(have, want, key, what):
        if key.endswith(ZERO_GRAD):
            assert np.abs(have - want).max() <= 1e-5 * scale, what
        else:
            _close(have, want, what=what)

    for r, got in enumerate(ranks):
        tag = f"rank {r} {arch}"
        np.testing.assert_allclose(got[f"{arch}/losses"], losses, rtol=1e-5,
                                   err_msg=tag)
        for k, v in grads.items():
            held(got[f"{arch}/grad/{k}"], v, k, f"{tag} gradient {k}")
        for k, v in state.items():
            held(got[f"{arch}/state/{k}"], v, k, f"{tag} {k}")
        halves = [k for k, n in numel.items()
                  if int(got[f"{arch}/numel/{k}"]) != n]
        assert halves, tag
        for k in halves:
            assert int(got[f"{arch}/numel/{k}"]) * 2 == numel[k], k
        cut = sum(numel[k] // 2 for k in halves
                  if k.split(".")[0] in trainable)
        assert int(got[f"{arch}/optimized"]) == optimized - cut, tag
    if arch == "B":
        key = "encoder.down_0.norm_down.mean"
        assert np.abs(state[key]).max() > 0
        np.testing.assert_array_equal(ranks[0][f"B/state/{key}"],
                                      ranks[3][f"B/state/{key}"])
    if arch not in WITH_JAX:
        return
    noises, masks = _draws(arch)
    xs = [inputs[f"{arch}/x{i}"] for i in range(OPTION_STEPS)]
    ts = ([inputs[f"{arch}/t{i}"] for i in range(OPTION_STEPS)]
          if f"{arch}/t0" in inputs else None)
    given = bare_steps(xs, arch=arch, ts=ts, noises=noises, masks=masks)
    assert given[0] == losses
    first = bare_steps(xs[:1], arch=arch, ts=ts, noises=noises,
                       masks=masks)[2]
    j_losses, j_after = _jax_sharded_steps(arch, inputs, noises, masks,
                                           monkeypatch)
    np.testing.assert_allclose(j_losses, losses, rtol=1e-5)
    for mine, theirs, when in ((first, j_after[0], "step 1"),
                               (state, j_after[-1], "step 2")):
        want = _as_port(theirs, config)
        assert want.keys() == mine.keys()
        for k, v in want.items():
            _close(mine[k], v, what=f"JAX {arch} {k} after {when}")


@pytest.mark.parametrize("kind", list(EVAL_HEADS))
def test_eval_heads_equal_one_process(launch, kind):
    """(c) The eval forwards of ResNet and InceptionV3 in the ranks (each
    its data index's rows, its norms and InceptionV3's running statistics
    held as shards) against one process's."""
    inputs, _, heads, ranks = launch
    logits, aux = heads[kind]
    per = EVAL_HEADS[kind][1][0] // 2
    for r, got in enumerate(ranks):
        rows = slice(r // 2 * per, (r // 2 + 1) * per)
        _close(got[f"{kind}/logits"], logits[rows], what=f"rank {r} {kind}")
        if aux is not None:
            _close(got[f"{kind}/aux"], aux[rows], what=f"rank {r} {kind} aux")


# -- (d) serving R and B over a (2, 2) mesh -------------------------------------


@pytest.mark.parametrize("arch,core", [("R", "turbo"), ("R", "cae"),
                                       ("B", "turbo"), ("B", "cae")])
def test_cores_over_model_mesh(arch, core):
    """Frames over a (2, 2) mesh byte-equal to the (2, 1) mesh's, decodes
    equal: the cores replicate over ``model``."""
    model = _model(ARCHS[arch][0]).eval()
    tiles = _tiles(32, 4)
    cpu4 = ["cpu"] * 4

    def make(mesh):
        if core == "turbo":
            return CAETurboCore(model, num_streams=64, mesh=mesh)
        return CAECodecCore(model, mesh=mesh)
    two_two = make(create_mesh(data=2, model=2, devices=cpu4))
    two_one = make(create_mesh(data=2, model=1, devices=cpu4))
    assert len(two_two.shards) == 2
    frames = two_two.encode_tiles(tiles)
    assert frames == two_one.encode_tiles(tiles)
    np.testing.assert_array_equal(two_two.decode_tiles(frames),
                                  two_one.decode_tiles(frames))
