"""Data-parallel training in the port, on the CPU: 2 gloo ranks against one
process, and that process against the JAX package.

Two multi-process tests, each starting its ranks through a ``file://``
rendezvous in its ``tmp_path`` (never a port chosen by binding and
releasing it) and bounding them with its own timeout:

1. the bare step (``training/loop.py:make_train_step(group=)``), a global
   batch of 4 split 2 + 2 over 3 steps, flagship-like GDN units with
   batch norm, dropout 0.1 and penalty A: losses, parameters and running
   statistics within 1e-5 of the one-process step on the batch of 4,
   which is within 1e-5 of the JAX ``make_train_step`` with the same
   noise and masks;
2. the train CLI's ``main`` over ``devices=["cpu", "cpu"]`` (two spawned
   ranks) against one process, as the JAX package's
   ``tests/test_multihost_cli.py`` holds its CLI: histories, parameters
   and running statistics within 1e-5, and only rank 0 wrote.

Both use SGD: Adam's step is the gradient's sign where a gradient sits at
float32 rounding (a GDN parameter at its bound), so two summation orders
of one gradient can move such an element a whole step apart."""

import json
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
from cnn_autoencoder_tpu.training.loop import \
    make_train_step as jax_train_step
from cnn_autoencoder_tpu.training.optim import \
    setup_optimizers as jax_setup_optimizers
from cnn_autoencoder_tpu_torch.cli import train_cae
from cnn_autoencoder_tpu_torch.models.factory import build_model
from cnn_autoencoder_tpu_torch.models.tasks import draw_masks
from cnn_autoencoder_tpu_torch.ops import convops
from cnn_autoencoder_tpu_torch.parallel import distributed
from cnn_autoencoder_tpu_torch.storage import zarr as zarrlib
from cnn_autoencoder_tpu_torch.training.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
from cnn_autoencoder_tpu_torch.utils import loggers
from cnn_autoencoder_tpu_torch.utils.args import get_args

from tests.test_torch_train_cli import _dropout_masks
from tests.torch_parallel_ranks import (ALGO, CONFIG, CRITERION, LR,
                                        TRAINABLE, bare_steps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_parallel_ranks.py")
GLOBAL_BATCH, STEPS = 4, 3


def _close(got, want, tol=1e-5, what=""):
    """Within ``tol`` of the reference tensor's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert got.shape == want.shape, what
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (what, float(np.abs(got - want).max()), scale)


def _env(**extra):
    """This environment without any multi-process start, at this process's
    serving precision (another test may have set ``CAE_TPU_PRECISION``
    after the port was imported here), plus ``extra``."""
    env = dict(os.environ, PYTHONPATH=REPO,
               CAE_TPU_PRECISION=convops.get_default_precision())
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    env.update(extra)
    return env


def _run(procs, timeout):
    """Wait for every process; fail with its output if one failed."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _global_batches():
    rng = np.random.RandomState(0)
    return [np.clip(rng.rand(GLOBAL_BATCH, 16, 16, 3) * 0.7 + 0.15, 0, 1)
            .astype(np.float32) for _ in range(STEPS)]


def _generator_draws(model):
    """The noise and dropout masks the one-process step draws from its
    generator (seed 5, ``bare_steps``' default), in its order: each
    step's masks, then its noise."""
    gen = torch.Generator().manual_seed(5)
    noises, masks = [], []
    latent = (GLOBAL_BATCH, 4, 4, CONFIG["channels_bn"])
    for _ in range(STEPS):
        masks.append(draw_masks(model, ["encoder", "decoder"], GLOBAL_BATCH,
                                gen, torch.device("cpu")))
        noises.append(torch.rand(latent, generator=gen) - 0.5)
    return noises, masks


def _jax_losses(path, xs, noises, masks, monkeypatch):
    """JAX ``make_train_step`` from the checkpoint at ``path``, jitted
    again with the noise and the dropout masks as arguments
    (``tests/test_torch_arch_options.py:_jax_steps``)."""
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

    def with_inputs(noise, step_masks, *args):
        current.update(noise=noise, masks=list(step_masks))
        with _dropout_masks(current):
            return step_fn(*args)

    step = jax.jit(with_inputs)
    lrs = {k: jnp.float32(LR) for k in optimizers}
    variables, losses = j_model.variables, []
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    for i, (x, noise, m) in enumerate(zip(xs, noises, masks), start=1):
        jm = [jnp.asarray(m[mod][u].numpy()) for mod in ("encoder", "decoder")
              for u in m[mod]]
        variables, opt_states, acc, stats = step(
            jnp.asarray(noise.numpy()), jm, variables, opt_states, acc, lrs,
            jnp.asarray(x), None, jax.random.PRNGKey(i), jnp.int32(i))
        losses.append(float(stats["loss"]))
    monkeypatch.undo()
    return losses


def test_two_rank_step_equals_one_process_and_jax(tmp_path, monkeypatch):
    xs = _global_batches()
    np.savez(tmp_path / "inputs.npz",
             **{f"x{i}": x for i, x in enumerate(xs)})
    procs = [subprocess.Popen(
        [sys.executable, RANKS, "steps", str(tmp_path)],
        env=_env(COORDINATOR_ADDRESS="file://" + str(tmp_path / "rdzv"),
                 NUM_PROCESSES="2", PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    # meanwhile: one process on the batch of 4, drawing from its
    # generator, and the same draws handed to it and to JAX
    model = build_model(CONFIG, torch.Generator().manual_seed(0),
                        device="cpu")
    path = str(tmp_path / "init.msgpack")
    save_checkpoint(path, model)
    noises, masks = _generator_draws(model)
    one_losses, one_state = bare_steps(xs)
    given_losses, given_state = bare_steps(xs, noises=noises, masks=masks)
    assert given_losses == one_losses
    for k, v in one_state.items():
        np.testing.assert_array_equal(given_state[k], v, err_msg=k)
    np.testing.assert_allclose(
        one_losses, _jax_losses(path, xs, noises, masks, monkeypatch),
        rtol=1e-5)

    _run(procs, timeout=240)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["losses"], one_losses, rtol=1e-5)
        for k, v in one_state.items():
            _close(got[k], v, what=f"rank {r} {k}")
    # the running statistics moved, the same on both ranks
    key = "encoder.down_0.norm_down.mean"
    assert np.abs(one_state[key]).max() > 0
    np.testing.assert_array_equal(np.load(tmp_path / "rank0.npz")[key],
                                  np.load(tmp_path / "rank1.npz")[key])


# -- the train CLI ------------------------------------------------------------

CLI_ARGS = ["-ds", "Zarr", "-rs", "2", "-bs", "4", "-vbs", "4", "-s", "3",
            "-cs", "2", "-esp", "100", "-cr", "RateMSE", "-nch", "8",
            "-bch", "8", "-cl", "2", "-act", "GDN", "-ps", "32", "-bn",
            "-do", "0.1", "-opt", ALGO, "-lr", str(LR), "-dg", "0/0",
            "-da", "YXC", "-trm", "encoder", "decoder", "fact_ent"]


def _make_slide(path, seed, side=128):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    img = np.clip((np.sin(yy / 11.0) + np.cos(xx / 7.0))[:, :, None]
                  * np.ones((1, 1, 3)) * 50 + 128
                  + rng.randn(side, side, 3) * 5, 0, 255).astype(np.uint8)
    arr = zarrlib.Group.create(path).create_dataset(
        "0/0", shape=img.shape, chunks=(64, 64, 3), dtype=np.uint8,
        compressor=None)
    arr[...] = img


def _last(log_dir):
    files = [f for f in os.listdir(log_dir) if f.startswith("last_")]
    assert len(files) == 1, os.listdir(log_dir)
    return load_checkpoint(os.path.join(log_dir, files[0]))


def _logs(log_dir):
    files = [f for f in os.listdir(log_dir) if f.endswith(".log")]
    assert len(files) == 1, os.listdir(log_dir)
    with open(os.path.join(log_dir, files[0])) as f:
        return f.read()


def test_two_rank_cli_equals_one_process(tmp_path, monkeypatch):
    data = tmp_path / "slides"
    data.mkdir()
    for i in range(2):
        _make_slide(str(data / f"train_{i}.zarr"), seed=i)
    _make_slide(str(data / "val_0.zarr"), seed=9)
    argv = ["-dd", str(data)] + CLI_ARGS
    two_dir, one_dir = tmp_path / "two", tmp_path / "one"
    proc = subprocess.Popen(
        [sys.executable, RANKS, "cli",
         json.dumps(argv + ["-ld", str(two_dir)]), json.dumps(["cpu"] * 2)],
        env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    args = get_args("autoencoder", "training",
                    args_list=argv + ["-ld", str(one_dir)])
    loggers.setup_logger(args)
    one = train_cae.main(args, device="cpu")
    assert [(r["rank"], r["ranks"]) for r in one] == [(0, 1)]

    out = _run([proc], timeout=300)[0]
    reports = json.loads(out.split("REPORTS ", 1)[1].splitlines()[0])
    assert [(r["rank"], r["ranks"]) for r in reports] == [(0, 2), (1, 2)]
    assert [r["completed"] for r in reports] == [one[0]["completed"]] * 2

    a, b = _last(two_dir), _last(one_dir)
    assert a["step"] == b["step"] and len(b["train_loss"]) >= 1
    for key in ("train_loss", "valid_loss", "best_val"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, tree

    for module in TRAINABLE:
        pairs = dict(leaves(b[module]))
        for path, leaf in leaves(a[module]):
            _close(leaf, pairs[path], what=module + path)
    assert any("batch_stats" in p for p, _ in leaves(a["encoder"]))

    # only rank 0 wrote: one log, in which rank 1 never speaks, and each
    # checkpoint saved once
    logs = _logs(two_dir)
    assert "Rank 0 of 2 on cpu over gloo" in logs and "Rank 1" not in logs
    assert logs.count("Saved model in") == _logs(one_dir).count(
        "Saved model in")
    assert not any(f.startswith(".rendezvous") for f in os.listdir(two_dir))


def test_secondary_process_writes_nothing(tmp_path, monkeypatch):
    """A rank other than 0 keeps no log file and saves no checkpoint, but
    returns the same paths (JAX ``utils/loggers.py:25-41,59-63``)."""
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    args = get_args("autoencoder", "training",
                    args_list=["-ld", str(tmp_path), "-dd", str(tmp_path)])
    loggers.setup_logger(args)
    path = loggers.save_state("last", {"step": 1, "x": np.zeros(2)}, args)
    save_checkpoint(str(tmp_path / "direct.msgpack"), {"step": 1})
    assert path.endswith(".msgpack") and os.listdir(tmp_path) == []


def test_batch_sizes_must_divide_over_ranks(tmp_path, monkeypatch):
    """The data axis's size (ranks over the model axis's) must divide both
    batch sizes, and the ranks the model axis's size; a train CLI under
    ``CAE_TPU_MODEL_PARALLEL=2`` over two ranks (data 1 x model 2)
    equals one process: histories and parameters within 1e-5, the same
    checkpoint keys and shapes, and only rank 0 wrote."""
    args = get_args("autoencoder", "training",
                    args_list=["-bs", "6", "-vbs", "4", "-dd", "x"])
    assert train_cae.data_parallel_size(args, 8) == 2
    assert train_cae.data_parallel_size(args, 1) == 1
    with pytest.raises(ValueError, match="divisible"):
        train_cae._check_rank_batches(args, 4)
    assert train_cae._check_rank_batches(args, 4, 2) == 2
    for ranks in (3, 8):  # 3 over model=2; data 4 over a batch of 6
        with pytest.raises(ValueError, match="divisible"):
            train_cae._check_rank_batches(args, ranks, 2)

    data = tmp_path / "slides"
    data.mkdir()
    _make_slide(str(data / "train_0.zarr"), seed=0)
    _make_slide(str(data / "val_0.zarr"), seed=9)
    argv = ["-dd", str(data)] + CLI_ARGS
    two_dir, one_dir = tmp_path / "two", tmp_path / "one"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_model_axis_ranks.py"), "cli",
         json.dumps(argv + ["-ld", str(two_dir)]), json.dumps(["cpu"] * 2),
         "2"], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "CAE_TPU_MODEL_PARALLEL"):
        monkeypatch.delenv(var, raising=False)
    one_args = get_args("autoencoder", "training",
                        args_list=argv + ["-ld", str(one_dir)])
    loggers.setup_logger(one_args)
    one = train_cae.main(one_args, device="cpu")

    out = _run([proc], timeout=300)[0]
    reports = json.loads(out.split("REPORTS ", 1)[1].splitlines()[0])
    assert [(r["rank"], r["ranks"]) for r in reports] == [(0, 2), (1, 2)]
    assert [r["completed"] for r in reports] == [one[0]["completed"]] * 2
    assert reports[0]["launches"] == reports[1]["launches"]

    a, b = _last(two_dir), _last(one_dir)
    assert set(a) == set(b) and a["step"] == b["step"]
    for key in ("train_loss", "valid_loss", "best_val"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, tree

    for module in TRAINABLE:
        pairs = dict(leaves(b[module]))
        got = dict(leaves(a[module]))
        assert got.keys() == pairs.keys()
        for path, leaf in got.items():
            _close(leaf, pairs[path], what=module + path)
    logs = _logs(two_dir)
    assert "Training mesh: data=1 x model=2" in logs
    assert "Rank 0 of 2 on cpu over gloo" in logs and "Rank 1" not in logs
    assert logs.count("Saved model in") == _logs(one_dir).count(
        "Saved model in")
