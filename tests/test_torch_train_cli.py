"""The port's training CLI (``cli/train_cae.py``, plain versions on the CPU)
against the JAX package's on synthetic MNIST and Zarr sets.

Both start from one JAX-written checkpoint (``-chk``: ``jax.random`` init
cannot be matched) and draw the same bottleneck noise: the JAX train step is
jitted again with the noise as an argument, which a patched
``jax.random.uniform`` hands to the bottleneck, and the port's
``FactorizedEntropyBottleneck.quantize`` is patched to take the same
arrays.  ``np.random`` is seeded the same way
before each package's run (``get_args`` seeds it from ``-rs``), as the
loaders' transforms draw from it.  Per-step losses, validation losses,
checkpoint steps and files are compared, and the checkpoints with their
optimizer and scheduler state load and resume in both packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cnn_autoencoder_tpu.cli import train_cae as jcli
from cnn_autoencoder_tpu.models.factory import build_model as jax_build
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.ops import convops as jconvops
from cnn_autoencoder_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from cnn_autoencoder_tpu.utils.args import get_args as jax_get_args
from cnn_autoencoder_tpu_torch.cli import train_cae as tcli
from cnn_autoencoder_tpu_torch.models.entropy import \
    FactorizedEntropyBottleneck
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.ops import convops as tconvops
from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
from cnn_autoencoder_tpu_torch.training.optim import optimizer_state_dict
from cnn_autoencoder_tpu_torch.utils.args import get_args
from cnn_autoencoder_tpu_torch.utils.weights import state_to_jax

from tests.test_cli import _make_synthetic_mnist
from tests.test_zarr_training import _make_wsi

NET = ["-nch", "8", "-bch", "8", "-cl", "2", "-act", "GDN", "-ps", "32"]
TRAINABLE = ["-trm", "encoder", "decoder", "fact_ent"]
# (dataset flags, channels_org, batch, steps); the warm-up and plateau
# schedulers run in the MNIST case, the weight decay moves Adam's moments
# under "2" of the optax chain
CASES = {
    "mnist": (["-ds", "MNIST", "-ich", "1", "-bs", "8", "-vbs", "8", "-s",
               "4", "-cs", "2", "-esw", "2", "-wd", "0.001", "-sch",
               "encoder=ReduceLROnPlateau,patience=int:0,factor=float:0.5"],
              1, 8),
    "zarr": (["-ds", "Zarr", "-bs", "4", "-vbs", "4", "-s", "3", "-cs", "2",
              "-dg", "0/0", "-da", "YXC"], 3, 4),
}


def _checkpoint(path, channels_org):
    m = jax_build(jax.random.PRNGKey(0), input_size=(32, 32),
                  channels_org=channels_org, channels_net=8, channels_bn=8,
                  compression_level=2, K=4, r=3, act_layer_type="GDN")
    jax_save_checkpoint(path, {**m.config, **m.variables})
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{case: (data dir, JAX-written starting checkpoint)}."""
    root = tmp_path_factory.mktemp("train_cli")
    mnist = root / "mnist"
    _make_synthetic_mnist(str(mnist))
    wsis = root / "wsis"
    wsis.mkdir()
    for i in range(2):
        _make_wsi(str(wsis / f"train_{i}.zarr"), seed=i)
    _make_wsi(str(wsis / "val_0.zarr"), seed=9)
    return {"mnist": (str(mnist), _checkpoint(str(root / "m1.msgpack"), 1)),
            "zarr": (str(wsis), _checkpoint(str(root / "m3.msgpack"), 3))}


def _noises(batch, steps):
    rng = np.random.RandomState(5)
    return [rng.uniform(-0.5, 0.5, (batch, 8, 8, 8)).astype(np.float32)
            for _ in range(steps)]


def _argv(case, data, log_dir, extra=()):
    flags, _, _ = CASES[case]
    data_dir, chk = data[case]
    return (flags + NET + TRAINABLE + ["-dd", data_dir, "-ld", str(log_dir),
                                       "-rs", "1", "-esp", "100", "-chk", chk]
            + list(extra))


def _run_jax(argv, noises, monkeypatch):
    """Per-step losses of the JAX CLI's ``main`` with the given noise: its
    train step is jitted again with the noise as one more argument, which
    the patched ``jax.random.uniform`` hands to the bottleneck."""
    losses, queue, current = [], list(noises), {}
    uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                     maxval=1.0):
        noise = current.get("noise")
        if noise is None or tuple(shape) != noise.shape:
            return uniform(key, shape, dtype, minval, maxval)
        return noise.astype(dtype)

    make_step = jcli.make_train_step

    def recording_step(*a, **k):
        step_fn = make_step(*a, **k).__wrapped__

        def with_noise(noise, *sa):
            current["noise"] = noise
            try:
                return step_fn(*sa)
            finally:
                current.pop("noise")
        step = jax.jit(with_noise)

        def run(*sa):
            out = step(jnp.asarray(queue.pop(0)), *sa)
            losses.append(float(out[3]["loss"]))
            return out
        return run

    monkeypatch.setenv("CAE_TPU_TRAIN_MESH", "0")
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jcli, "make_train_step", recording_step)
    args = jax_get_args("autoencoder", "training", args_list=argv)
    try:
        jcli.main(args)
    finally:
        monkeypatch.undo()
    return losses


def _run_port(argv, noises, monkeypatch):
    """Per-step losses of the port's ``main`` on the CPU with the given
    noise."""
    losses, queue = [], list(noises)
    quantize = FactorizedEntropyBottleneck.quantize

    def fake_quantize(self, y, mode, noise=None, generator=None):
        if mode == "noise" and noise is None:
            noise = torch.from_numpy(queue.pop(0))
        return quantize(self, y, mode, noise, generator)

    make_step = tcli.make_train_step

    def recording_step(*a, **k):
        step = make_step(*a, **k)

        def run(*sa, **sk):
            out = step(*sa, **sk)
            losses.append(float(out[0]["loss"]))
            return out
        return run

    monkeypatch.setattr(FactorizedEntropyBottleneck, "quantize",
                        fake_quantize)
    monkeypatch.setattr(tcli, "make_train_step", recording_step)
    args = get_args("autoencoder", "training", args_list=argv)
    try:
        tcli.main(args, device="cpu")
    finally:
        monkeypatch.undo()
    return losses


def _saved(log_dir):
    """{"last" | "best": flat state} of the checkpoints in ``log_dir``."""
    out = {}
    for fn in os.listdir(log_dir):
        if fn.endswith(".msgpack"):
            out[fn.split("_")[0]] = (fn, load_checkpoint(
                os.path.join(log_dir, fn)))
    return out


def _assert_trees(a, b, atol, rtol=0.0, path=""):
    """Same keys at every level, None where the other has None, arrays of
    one shape and dtype within ``atol`` and ``rtol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _assert_trees(a[k], b[k], atol, rtol, f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=path)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """{case: (JAX losses, port losses, JAX log dir, port log dir)} of the
    float32 runs."""
    mp = pytest.MonkeyPatch()
    out = {}
    for case, (_, _, batch) in CASES.items():
        noises = _noises(batch, 6)
        jdir = tmp_path_factory.mktemp(f"{case}_jax")
        tdir = tmp_path_factory.mktemp(f"{case}_port")
        jl = _run_jax(_argv(case, data, jdir), noises, mp)
        tl = _run_port(_argv(case, data, tdir), noises, mp)
        out[case] = (jl, tl, str(jdir), str(tdir))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_and_checkpoints_match_jax(runs, case):
    """float32: every step's loss within 1e-5 relative; the same
    checkpoint files at the same steps, validation and train loss
    histories within 1e-5, the same config keys and schedulers' states."""
    jl, tl, jdir, tdir = runs[case]
    assert len(jl) == len(tl) >= 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    js, ts = _saved(jdir), _saved(tdir)
    assert {k: v[0] for k, v in js.items()} == \
        {k: v[0] for k, v in ts.items()} and "last" in js
    for kind in js:
        j, t = js[kind][1], ts[kind][1]
        assert t["step"] == j["step"]
        assert set(t) == set(j)
        for key in ("valid_loss", "train_loss", "best_val"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5)
        for key in j:
            if key.startswith("scheduler_"):
                # a plateau scheduler's best is a validation loss
                _assert_trees(t[key], j[key], atol=0, rtol=1e-5)
            elif key.startswith("optimizer_"):
                _assert_trees(t[key], j[key], atol=1e-4)
        assert t["trainable_modules"] == j["trainable_modules"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoints_load_across(runs, case):
    """The port's ``last_`` loads in the JAX package (model and optimizer
    and scheduler state through its ``resume_optimizer``) and the JAX
    package's loads in the port's; either way the restored count, moments
    and schedules equal the saved ones key for key within 1e-6."""
    _, _, jdir, tdir = runs[case]
    (_, jstate), (_, tstate) = _saved(jdir)["last"], _saved(tdir)["last"]
    tpath = os.path.join(tdir, _saved(tdir)["last"][0])
    jpath = os.path.join(jdir, _saved(jdir)["last"][0])

    # port -> JAX
    args = jax_get_args("autoencoder", "training",
                        args_list=["-chk", tpath, "-reso", "true"] + NET
                        + TRAINABLE + CASES[case][0])
    jmodel = jax_from_state_dict(tpath)
    _assert_trees(serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jmodel.variables)),
        {k: tstate[k] for k in ("encoder", "decoder", "fact_ent")}, 0)
    _, opt_states, _, jscheds, _ = jcli.setup_optim(jmodel, args)
    opt_states = jcli.resume_optimizer(opt_states, jscheds, tpath)
    for name, st in opt_states.items():
        _assert_trees(serialization.to_state_dict(
            jax.tree_util.tree_map(np.asarray, st)),
            tstate["optimizer_" + name], 1e-6)
    for name, sched in jscheds.items():
        _assert_trees(jax.tree_util.tree_map(np.asarray, sched.state_dict()),
                      tstate["scheduler_" + name], 1e-12)

    # JAX -> port
    args = get_args("autoencoder", "training",
                    args_list=["-chk", jpath, "-reso", "true"] + NET
                    + TRAINABLE + CASES[case][0])
    model = autoencoder_from_state_dict(jpath, device="cpu")
    _assert_trees(state_to_jax(model.state_dict()),
                  {k: jstate[k] for k in ("encoder", "decoder", "fact_ent")},
                  0)
    optimizers, scheds, _ = tcli.setup_optim(model, args)
    tcli.resume_optimizer(optimizers, scheds, jpath, model)
    for name, slot in optimizers.items():
        _assert_trees(optimizer_state_dict(slot, model),
                      jstate["optimizer_" + name], 1e-6)
    for name, sched in scheds.items():
        _assert_trees(jax.tree_util.tree_map(np.asarray, sched.state_dict()),
                      jstate["scheduler_" + name], 1e-12)


def test_resume_across_packages(data, runs, tmp_path, monkeypatch):
    """Each package resumes (``--resume-optimizers``) from the other's
    ``last_`` and the two continue with the same losses."""
    _, _, jdir, tdir = runs["zarr"]
    tpath = os.path.join(tdir, _saved(tdir)["last"][0])
    jpath = os.path.join(jdir, _saved(jdir)["last"][0])
    noises = _noises(4, 3)
    flags = ["-s", "2", "-reso", "true"]
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    jl = _run_jax(_argv("zarr", data, tmp_path / "j", flags + ["-chk", tpath]),
                  noises, monkeypatch)
    tl = _run_port(_argv("zarr", data, tmp_path / "t",
                         flags + ["-chk", jpath]), noises, monkeypatch)
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def _widened_log_info(log_info):
    """The JAX package's ``log_info`` given float32 copies of bf16 stats:
    ``"{:.2f}".format`` of a 0-d bf16 numpy array raises, so the JAX CLI
    stops at its first log line in bf16."""
    def run(step, sub_step, len_data, stats, **kw):
        stats = {k: (np.asarray(v, np.float32)
                     if np.asarray(v).dtype.name == "bfloat16" else v)
                 for k, v in stats.items()}
        return log_info(step, sub_step, len_data, stats, **kw)
    return run


def test_bf16_run_matches_jax(data, tmp_path, monkeypatch):
    """One short bf16 run (``set_default_precision("bf16")`` in each
    package): losses within 2e-2 relative of the JAX CLI's."""
    noises = _noises(4, 3)
    argv = ["-s", "2", "-cs", "5"]
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli.loggers, "log_info",
                   _widened_log_info(jcli.loggers.log_info))
        for mod in (jconvops, tconvops):   # restored when the block ends
            for name in ("_DEFAULT_PRECISION", "_DEFAULT_COMPUTE_DTYPE"):
                if hasattr(mod, name):
                    mp.setattr(mod, name, getattr(mod, name))
            mod.set_default_precision("bf16")
        jl = _run_jax(_argv("zarr", data, tmp_path / "j", argv), noises,
                      monkeypatch)
        tl = _run_port(_argv("zarr", data, tmp_path / "t", argv), noises,
                       monkeypatch)
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_main_without_a_card_raises(data, tmp_path):
    """``device=None`` means the card: without one ``main`` raises before
    it reads any data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = get_args("autoencoder", "training",
                    args_list=_argv("zarr", data, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(args)
