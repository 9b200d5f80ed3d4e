"""The port's model mesh axis (channel tensor parallelism), on the CPU,
against one process and against the JAX package on the 8 CPU devices
``tests/conftest.py`` spoofs.

* the mesh's layout and the sharding of a state dict
  (``parallel/mesh.py:create_mesh``, ``shard_state``, ``gather_state``,
  ``shard_model``) against JAX's ``create_mesh`` and ``shard_variables``;
* the bare train step over 4 gloo ranks (data 2 x model 2), each its own
  process through a ``file://`` rendezvous in its ``tmp_path`` with its
  own timeout: losses, step-1 gradients and gathered parameters within
  1e-5 of the one-process step's, and within 1e-5 of JAX's step under
  ``create_mesh(data=2, model=2)`` with ``shard_variables`` (losses and
  parameters; it returns no gradients);
* both serving cores over a ``(2, 2)`` mesh of one device: frames
  byte-equal to the data-only mesh's and to JAX's cores under ``(2, 2)``;
* the architectures the flagship's axis left out (residual units, batch
  norm, grouped convolutions, the heads): their shards and their eval
  forwards over 2 gloo ranks against one process's; grouped layers held
  as shards, whole groups a rank or not, against one process and JAX
  (``tests/test_torch_model_axis_options.py`` trains them).

Every tolerance is 1e-5 of the reference tensor's largest magnitude.  The
steps use SGD (``tests/torch_parallel_ranks.py`` says why)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.criteria.loss import setup_loss as jax_setup_loss
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.ops import convops as jax_convops
from cnn_autoencoder_tpu.parallel import mesh as jax_mesh
from cnn_autoencoder_tpu.storage.cae_codec import \
    CAECodecCore as JaxCodecCore
from cnn_autoencoder_tpu.storage.turbo_codec import \
    CAETurboCore as JaxTurboCore
from cnn_autoencoder_tpu.training.loop import \
    make_train_step as jax_train_step
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup_optimizers
from cnn_autoencoder_tpu_torch.models.factory import (
    autoencoder_from_state_dict, build_model)
from cnn_autoencoder_tpu_torch.parallel.mesh import (create_mesh,
                                                     data_devices,
                                                     gather_state,
                                                     shard_axes, shard_model,
                                                     shard_state)
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.training.checkpoint import save_checkpoint
from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
from cnn_autoencoder_tpu_torch.utils.weights import (_deconv,
                                                     state_from_jax,
                                                     state_to_jax)

from tests.test_torch_parallel import _tiles
from tests.test_torch_parallel_train import _close, _env, _run
from tests.torch_model_axis_ranks import (ALGO, CONFIG, CRITERION,
                                          FORWARD_OPTIONS, GROUPED_LAYERS,
                                          LR, TRAINABLE, bare_steps,
                                          grouped_layer, option_config,
                                          option_forward, option_input)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_model_axis_ranks.py")
GLOBAL_BATCH, STEPS, SIDE = 4, 3, 16


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """(port model of seed 0, its checkpoint's path, JAX's variables of
    it as numpy)."""
    model = build_model(CONFIG, torch.Generator().manual_seed(0),
                        device="cpu")
    path = str(tmp_path_factory.mktemp("axis") / "init.msgpack")
    save_checkpoint(path, model)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_from_state_dict(path).variables)
    return model, path, variables


# -- the mesh and the shards --------------------------------------------------


def test_create_mesh_model_axis_as_jax():
    """(a) data 4 x model 2 over 8 devices: JAX's shape and layout,
    ``devices[i * m + j]`` at (data i, model j)."""
    got = create_mesh(data=4, model=2, devices=[f"cpu:{k}" for k in range(8)])
    want = jax_mesh.create_mesh(data=4, model=2)
    assert got.shape == dict(want.shape) == {"data": 4, "model": 2}
    ids = [[d.id for d in row] for row in want.devices]
    assert [[got.devices[i * 2 + j].index for j in range(2)]
            for i in range(4)] == ids
    assert [d.index for d in data_devices(got)] == [r[0] for r in ids]
    assert create_mesh(model=2, devices=["cpu"] * 8).shape == {
        "data": 4, "model": 2}


@pytest.mark.parametrize("model_size", [2, 4])
def test_shard_state_equals_jax_shards(seeded, model_size):
    """(b) Each model index's ``shard_state`` of the carried-across model
    is JAX's ``shard_variables`` shard on that mesh device, carried
    across; the shards gather back to the state."""
    _, _, variables = seeded
    mesh = jax_mesh.create_mesh(data=8 // model_size, model=model_size)
    placed = jax_mesh.shard_variables(mesh, variables)
    state = state_from_jax(variables, CONFIG)
    shards = []
    for j in range(model_size):
        dev = mesh.devices[0, j]
        on_dev = jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == dev)), placed)
        want = state_from_jax(on_dev, CONFIG)
        got = shard_state(state, CONFIG, j, model_size)
        assert got.keys() == want.keys() == state.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)
        shards.append(got)
    axes = shard_axes(state, CONFIG, model_size)
    assert axes["encoder.down_0.conv_down.weight"] == 0
    assert axes["decoder.up_0.deconv_up.weight"] == 1
    assert axes["decoder.up_2.deconv_up.weight"] is None
    back = gather_state(shards, axes)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("model_size", [2, 4])
def test_shard_model_holds_slices(seeded, model_size):
    """(c) A sharded leaf's parameter on a rank holds 1/m of it, and the
    optimizer's state made after ``shard_model`` lives on the shard."""
    full = {k: p.numel() for k, p in seeded[0].named_parameters()}
    axes = shard_axes(seeded[0].state_dict(), CONFIG, model_size)
    model = build_model(CONFIG, torch.Generator().manual_seed(0),
                        device="cpu")
    shard_model(model, None, model_size - 1, model_size)
    slots = setup_optimizers(model, TRAINABLE, {k: "Adam"
                                                for k in TRAINABLE})
    sharded = 0
    for k, p in model.named_parameters():
        want = full[k] // model_size if axes[k] is not None else full[k]
        assert p.numel() == want, k
        sharded += axes[k] is not None
        module, name = k.split(".", 1)
        slot = slots[module + "_aux" if "quantiles" in name else module]
        assert slot.mu[name].shape == slot.nu[name].shape == p.shape, k
    # only the last deconv (3 outputs) is replicated
    assert sharded == len(full) - 1


# -- the bare step over 4 ranks -----------------------------------------------


def _global_batches():
    rng = np.random.RandomState(0)
    return [np.clip(rng.rand(GLOBAL_BATCH, SIDE, SIDE, 3) * 0.7 + 0.15, 0,
                    1).astype(np.float32) for _ in range(STEPS)]


def _noises():
    """The noise the one-process step draws from its generator (seed 5,
    ``bare_steps``' default), step by step."""
    gen = torch.Generator().manual_seed(5)
    latent = (GLOBAL_BATCH, SIDE // 8, SIDE // 8, CONFIG["channels_bn"])
    return [torch.rand(latent, generator=gen) - 0.5 for _ in range(STEPS)]


def _jax_sharded_steps(path, xs, noises, monkeypatch):
    """JAX ``make_train_step`` under ``create_mesh(data=2, model=2)`` with
    its variables, optimizer state and batches placed by
    ``shard_variables`` / ``shard_batch``, jitted again with the noise as
    an argument.  Returns (losses, parameters after step 1, after the
    last step)."""
    j_model = jax_from_state_dict(path)
    criterion = jax_setup_loss(CRITERION, distortion_lambda=0.01)
    optimizers, opt_states, acc = jax_setup_optimizers(
        j_model.variables, TRAINABLE, mod_optim_algo={k: ALGO
                                                      for k in TRAINABLE})
    step_fn = jax_train_step(j_model.modules, criterion, optimizers,
                             trainable_modules=TRAINABLE,
                             donate=False).__wrapped__
    current = {}
    uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                     maxval=1.0):
        if tuple(shape) != current["noise"].shape:
            return uniform(key, shape, dtype, minval, maxval)
        return current["noise"].astype(dtype)

    def with_noise(noise, *args):
        current["noise"] = noise
        return step_fn(*args)

    step = jax.jit(with_noise)
    lrs = {k: jnp.float32(LR) for k in optimizers}
    mesh = jax_mesh.create_mesh(data=2, model=2)
    losses, params = [], []
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    with mesh:
        variables = jax_mesh.shard_variables(mesh, j_model.variables)
        opt_states = jax_mesh.shard_variables(mesh, opt_states)
        acc = jax_mesh.shard_variables(mesh, acc)
        q = variables["fact_ent"]["params"]["quantiles"]
        assert "model" in str(q.sharding.spec)
        for i, (x, noise) in enumerate(zip(xs, noises), start=1):
            variables, opt_states, acc, stats = step(
                jnp.asarray(noise.numpy()), variables, opt_states, acc, lrs,
                jax_mesh.shard_batch(mesh, jnp.asarray(x)), None,
                jax.random.PRNGKey(i), jnp.int32(i))
            losses.append(float(stats["loss"]))
            params.append(jax.tree_util.tree_map(np.asarray, variables))
    monkeypatch.undo()
    return losses, params[0], params[-1]


def test_four_rank_step_equals_one_process_and_jax(seeded, tmp_path,
                                                   monkeypatch):
    """(d) 4 gloo ranks, data 2 x model 2, 3 SGD steps."""
    _, path, _ = seeded
    xs = _global_batches()
    np.savez(tmp_path / "inputs.npz",
             **{f"x{i}": x for i, x in enumerate(xs)})
    procs = [subprocess.Popen(
        [sys.executable, RANKS, "steps", str(tmp_path), "2", "2"],
        env=_env(COORDINATOR_ADDRESS="file://" + str(tmp_path / "rdzv"),
                 NUM_PROCESSES="4", PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]

    # meanwhile: one process drawing from its generator, the same noise
    # handed to it, and to JAX's sharded step
    losses, grads, state, _ = bare_steps(xs)
    noises = _noises()
    given = bare_steps(xs, noises=noises)
    assert given[0] == losses
    first = bare_steps(xs[:1], noises=noises)[2]
    j_losses, j_first, j_last = _jax_sharded_steps(path, xs, noises,
                                                   monkeypatch)
    np.testing.assert_allclose(j_losses, losses, rtol=1e-5)

    def as_jax(tree, module):
        tree = {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
        return dict(_leaves(state_to_jax(tree, CONFIG)[module]["params"]))

    for module in TRAINABLE:
        for ref, jt in ((first, j_first), (state, j_last)):
            want = dict(_leaves(jt[module]["params"]))
            for p, leaf in as_jax(ref, module).items():
                _close(leaf, want[p], what=f"JAX {module}{p}")

    _run(procs, timeout=240)
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, v in grads.items():
            _close(got["grad/" + k], v, what=f"rank {r} gradient {k}")
        assert np.abs(grads["encoder.down_1.conv_down.weight"]).max() > 0
        for k, v in state.items():
            _close(got["param/" + k], v, what=f"rank {r} {k}")
        for k, v in state.items():
            n = int(got["numel/" + k])
            assert n in (v.size, v.size // 2), k
        assert int(got["numel/fact_ent.quantiles"]) == \
            state["fact_ent.quantiles"].size // 2
        # every rank's parameters, against its model group's after
        # gathering, the same
        np.testing.assert_array_equal(
            got["param/decoder.up_1.gdn_up.gamma"],
            np.load(tmp_path / "rank0.npz")["param/decoder.up_1.gdn_up."
                                            "gamma"])
        # the JAX state, against each rank's gathered parameters
        for module in TRAINABLE:
            want = dict(_leaves(j_last[module]["params"]))
            mine = as_jax({k[6:]: got[k] for k in got.files
                           if k.startswith("param/")}, module)
            for p, leaf in mine.items():
                _close(leaf, want[p], what=f"rank {r} vs JAX {module}{p}")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


# -- serving over a (2, 2) mesh -----------------------------------------------


@pytest.mark.parametrize("core", ["turbo", "cae"])
def test_cores_over_model_mesh(seeded, core):
    """(e) Frames over a (2, 2) mesh byte-equal to the (2, 1) mesh's and
    to JAX's core under ``create_mesh(data=2, model=2)``; decodes
    equal."""
    _, path, _ = seeded
    j_model = jax_from_state_dict(path)
    t_model = autoencoder_from_state_dict(path, device="cpu")
    tiles = _tiles(32, 4)
    cpu4 = ["cpu"] * 4
    if core == "turbo":
        def make(mesh):
            return CAETurboCore(t_model, num_streams=64, mesh=mesh)
        jcore = JaxTurboCore(j_model, num_streams=64,
                             mesh=jax_mesh.create_mesh(data=2, model=2))
    else:
        def make(mesh):
            return CAECodecCore(t_model, mesh=mesh)
        jcore = JaxCodecCore(j_model,
                             mesh=jax_mesh.create_mesh(data=2, model=2))
    two_two = make(create_mesh(data=2, model=2, devices=cpu4))
    two_one = make(create_mesh(data=2, model=1, devices=cpu4))
    assert len(two_two.shards) == 2
    frames = two_two.encode_tiles(tiles)
    assert frames == two_one.encode_tiles(tiles) == jcore.encode_tiles(tiles)
    rec = two_two.decode_tiles(frames)
    np.testing.assert_array_equal(rec, two_one.decode_tiles(frames))
    np.testing.assert_array_equal(rec, np.asarray(jcore.decode_tiles(frames)))


# -- the architectures the flagship's axis left out ----------------------------


def _jax_grouped_layer(kind, case):
    """The JAX package's grouped layer of ``GROUPED_LAYERS[case]`` on a
    seeded input: ({weight, bias (the port's layout), x, g}, y, dx)."""
    cin, cout, groups, stride = GROUPED_LAYERS[case]
    rng = np.random.RandomState(10 * case + len(kind))
    x = rng.randn(2, 9, 7, cin).astype(np.float32)
    if kind == "deconv":
        layer = jax_convops.ConvTranspose2dTorch(cout, 3, stride, 1,
                                                 stride - 1, True, groups)
        side = (9 * stride, 7 * stride)
    else:
        layer = jax_convops.Conv2dReflect(cout, 3, stride, True, groups)
        side = (-(-9 // stride), -(-7 // stride))
    g = rng.randn(2, *side, cout).astype(np.float32)
    v = layer.init(jax.random.PRNGKey(case), jnp.asarray(x))
    kernel = np.asarray(v["params"]["kernel"])
    weight = (_deconv(kernel, groups) if kind == "deconv"
              else np.transpose(kernel, (3, 2, 0, 1)))
    y, vjp = jax.vjp(lambda a: layer.apply(v, a), jnp.asarray(x))
    arrays = {"weight": np.ascontiguousarray(weight),
              "bias": np.asarray(v["params"]["bias"]), "x": x, "g": g}
    return arrays, np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    """One launch of 2 gloo ranks (data 1 x model 2) for the options'
    forwards and the grouped layers; meanwhile one process's and JAX's.
    Returns (one process's {option: (outputs, numel)}, JAX's and one
    process's {(kind, case): ...}, each rank's results)."""
    work = tmp_path_factory.mktemp("forwards")
    layers, jax_out = {}, {}
    for kind in ("conv", "deconv"):
        for case in range(len(GROUPED_LAYERS)):
            arrays, y, dx = _jax_grouped_layer(kind, case)
            layers.update({f"{kind}{case}/{k}": v for k, v in arrays.items()})
            jax_out[kind, case] = (y, dx)
    np.savez(work / "layers.npz", **layers)
    procs = [subprocess.Popen(
        [sys.executable, RANKS, "forwards", str(work), "2"],
        env=_env(COORDINATOR_ADDRESS="file://" + str(work / "rdzv"),
                 NUM_PROCESSES="2", PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        one = {o: option_forward(o, option_input(o))
               for o in FORWARD_OPTIONS}
        one_layers = {key: grouped_layer(*key, layers) for key in jax_out}
        _run(procs, timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [dict(np.load(work / f"forwards{r}.npz")) for r in range(2)]
    return one, jax_out, one_layers, ranks


@pytest.mark.parametrize("option", list(FORWARD_OPTIONS))
def test_left_out_architectures_shard(forwards, option):
    """(f) Residual units, batch norm, grouped convolutions (4 / 4 / 4)
    and the heads (JNet, ViT) on the 64-wide CAE: under model=2 each
    leaf is held as the shard ``infer_param_spec`` gives (half of a cut
    leaf, running statistics included), and the eval forward over 2
    ranks equals one process's."""
    one, _, _, ranks = forwards
    outputs, numel = one[option]
    config = option_config(option)
    model = build_model(config, torch.Generator().manual_seed(0),
                        device="cpu")
    axes = shard_axes(model.state_dict(), config, 2)
    assert any(a is not None for a in axes.values())
    for r, got in enumerate(ranks):
        for k, n in numel.items():
            want = n if axes[k] is None else n // 2
            assert int(got[f"{option}/numel/{k}"]) == want, (r, k)
        for k, v in outputs.items():
            _close(got[f"{option}/{k}"], v, what=f"rank {r} {option} {k}")
    assert shard_model(model, None, 0, 1) is model


@pytest.mark.parametrize("kind", ["conv", "deconv"])
@pytest.mark.parametrize("case", range(len(GROUPED_LAYERS)))
def test_grouped_layer_shards_equal_jax(forwards, kind, case):
    """A grouped ``Conv2dReflect`` and ``ConvTranspose2dTorch`` held as
    shards over 2 ranks: its whole groups on their input channels (4 and
    2 groups), or the gathered kernel's whole layer (3 groups); y, the
    input's and the weight's gradients against one process's, and y and
    the input's gradient against JAX's layer, within 1e-5."""
    _, jax_out, one_layers, ranks = forwards
    y, dx, dw = one_layers[kind, case]
    _close(y, jax_out[kind, case][0], what="one process y against JAX")
    _close(dx, jax_out[kind, case][1], what="one process dx against JAX")
    for r, got in enumerate(ranks):
        for name, want in (("y", y), ("dx", dx), ("dw", dw)):
            _close(got[f"{kind}{case}/{name}"], want,
                   what=f"rank {r} {kind} {name}")
