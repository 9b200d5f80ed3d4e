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

import contextlib
import os

import flax.linen as nn
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


@contextlib.contextmanager
def _dropout_masks(current):
    """Train-mode ``nn.Dropout`` calls take their keep-masks, (N, C) each,
    in call order from ``current["masks"]`` and apply them as flax applies
    its own (flax's draw cannot be matched by torch's generators)."""
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (not isinstance(mod, nn.Dropout) or context.method_name
                != "__call__" or mod.deterministic or not current.get(
                    "masks")):
            return next_fun(*args, **kwargs)
        x, keep = args[0], 1.0 - mod.rate
        mask = current["masks"].pop(0)[:, None, None, :]
        return jax.lax.select(jnp.broadcast_to(mask, x.shape), x / keep,
                              jnp.zeros_like(x))

    with nn.intercept_methods(interceptor):
        yield


def _port_masks(model, masks):
    """``masks`` (N, C) arrays in the JAX call order (encoder units, then
    decoder units) in the port's ``{module: {unit: mask}}`` layout."""
    queue = [torch.from_numpy(np.array(m)) for m in masks]
    return {m: {n: queue.pop(0) for n in getattr(model, m).names
                if getattr(getattr(model, m), n).drop is not None}
            for m in ("encoder", "decoder")}


def _run_jax(argv, noises, monkeypatch, record=None, masks=None):
    """Per-step losses of the JAX CLI's ``main`` with the given noise (and
    dropout keep-masks, a list per step): its train step is jitted again
    with the noise and the masks as more arguments, which the patched
    ``jax.random.uniform`` hands to the bottleneck and ``_dropout_masks``
    to the dropout layers.  Each step's (step number, channel_e, energy) is
    appended to ``record``."""
    losses, queue, current = [], list(noises), {}
    mask_queue = list(masks or [])
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

        def with_noise(noise, step_masks, *sa):
            current["noise"] = noise
            current["masks"] = list(step_masks)
            try:
                with _dropout_masks(current):
                    return step_fn(*sa)
            finally:
                current.pop("noise")
                current.pop("masks")
        step = jax.jit(with_noise)

        def run(*sa):
            step_masks = [jnp.asarray(m) for m in mask_queue.pop(0)] \
                if mask_queue else []
            out = step(jnp.asarray(queue.pop(0)), step_masks, *sa)
            losses.append(float(out[3]["loss"]))
            if record is not None:
                record.append(_record(sa[7], out[3]))
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


def _record(step, stats):
    """(step number, channel_e, energy) of one train step's stats."""
    energy = stats.get("energy")
    return (int(step), float(np.asarray(stats["channel_e"], np.float32)),
            None if energy is None else float(np.asarray(energy, np.float32)))


def _run_port(argv, noises, monkeypatch, record=None, masks=None):
    """Per-step losses of the port's ``main`` on the CPU with the given
    noise and masks; ``record`` as in ``_run_jax``."""
    losses, queue = [], list(noises)
    mask_queue = list(masks or [])
    quantize = FactorizedEntropyBottleneck.quantize

    def fake_quantize(self, y, mode, noise=None, generator=None):
        if mode == "noise" and noise is None:
            noise = torch.from_numpy(queue.pop(0))
        return quantize(self, y, mode, noise, generator)

    make_step = tcli.make_train_step

    def recording_step(*a, **k):
        step = make_step(*a, **k)

        def run(*sa, **sk):
            if mask_queue:
                sk["masks"] = _port_masks(a[0], mask_queue.pop(0))
            out = step(*sa, **sk)
            losses.append(float(out[0]["loss"]))
            if record is not None:
                record.append(_record(sa[2], {
                    k: v.float().numpy() for k, v in out[0].items()}))
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
    _assert_trees(state_to_jax(model.state_dict(), model.config),
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


@pytest.fixture(scope="module")
def ms_checkpoint(tmp_path_factory):
    """A JAX-written multiscale model (color layers included) of the zarr
    case's widths."""
    m = jax_build(jax.random.PRNGKey(0), input_size=(32, 32),
                  channels_org=3, channels_net=8, channels_bn=8,
                  compression_level=2, K=4, r=3, act_layer_type="GDN",
                  multiscale_analysis=True)
    path = str(tmp_path_factory.mktemp("ms") / "ms.msgpack")
    jax_save_checkpoint(path, {**m.config, **m.variables})
    return path


# criterion: (flags, multiscale checkpoint, sub-steps per batch).  The
# energy limits sit 1e-3 (PA) and 1e-5 (PB, 2.5e-4 relative) or more from
# every energy of these runs, so one batch stops after a sub-step where
# another takes all three
SUB_STEP_CASES = {
    "MultiscaleRateMSSSIM": (["-dl", "0.01", "0.01"], True, [1, 1, 1, 1]),
    "RateMSEPA": (["-ss", "3", "-el", "0.4385"], False, [1, 1, 3, 3]),
    "RateMSEPB": (["-ss", "3", "-el", "0.040635"], False, [3, 3, 1, 1]),
}


def _sub_steps(record):
    steps = [r[0] for r in record]
    return [steps.count(s) for s in sorted(set(steps))]


def _assert_records(trec, jrec, rtol):
    """The same step numbers (so the same sub-steps per batch) and
    channel_e, energies within ``rtol``."""
    assert [r[:2] for r in trec] == [r[:2] for r in jrec]
    if jrec[0][2] is not None:
        np.testing.assert_allclose([r[2] for r in trec],
                                   [r[2] for r in jrec], rtol=rtol)


@pytest.mark.parametrize("crit", sorted(SUB_STEP_CASES))
def test_criteria_and_sub_steps_match_jax(data, ms_checkpoint, tmp_path,
                                          monkeypatch, crit):
    """float32 MS-SSIM over both scales and penalties A and B with their
    sub-iterations: every sub-step's loss within 1e-5 relative of the JAX
    CLI's, the same sub-steps per batch and channel_e, and the same
    validation losses and channel_e in the checkpoints."""
    flags, ms, counts = SUB_STEP_CASES[crit]
    extra = ["-cr", crit] + flags + (["-chk", ms_checkpoint] if ms else [])
    noises = _noises(4, 16)
    recs = {"j": [], "t": []}
    for d in recs:
        (tmp_path / d).mkdir()
    jl = _run_jax(_argv("zarr", data, tmp_path / "j", extra), noises,
                  monkeypatch, recs["j"])
    tl = _run_port(_argv("zarr", data, tmp_path / "t", extra), noises,
                   monkeypatch, recs["t"])
    assert _sub_steps(recs["j"]) == counts
    _assert_records(recs["t"], recs["j"], 1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    js, ts = _saved(tmp_path / "j"), _saved(tmp_path / "t")
    for kind in js:
        j, t = js[kind][1], ts[kind][1]
        assert t["step"] == j["step"] and t["channel_e"] == j["channel_e"]
        np.testing.assert_allclose(t["valid_loss"], j["valid_loss"],
                                   rtol=1e-5)
    if ms:
        assert "color_0" in ts["last"][1]["decoder"]["params"]


def test_penalty_a_bf16_matches_jax(data, tmp_path, monkeypatch):
    """RateMSEPA in bf16 (``set_default_precision("bf16")`` in each
    package): losses and energies within 2e-2 relative of the JAX CLI's,
    the same sub-steps and channel_e."""
    noises = _noises(4, 16)
    argv = ["-cr", "RateMSEPA", "-ss", "3", "-el", "0.7"]
    recs = {"j": [], "t": []}
    for d in recs:
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
                      monkeypatch, recs["j"])
        tl = _run_port(_argv("zarr", data, tmp_path / "t", argv), noises,
                       monkeypatch, recs["t"])
    assert _sub_steps(recs["j"]) == [3, 3, 3, 3]
    _assert_records(recs["t"], recs["j"], 2e-2)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
