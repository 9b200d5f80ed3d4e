"""The port's classifier / segmenter harness (``cli/test_cae_classifier.py``)
against the JAX package's: the NHWC prediction tree of a dense binary
task with connected-component crops equal array for array and its image-
and object-level metrics equal, the ROC arrays within 1e-6
(``tests/test_harnesses.py:91``); then the whole ``test()`` entry point on
a checkpoint with a classifier head over a CIFAR-10-layout test batch
(``tests/test_harnesses.py:161``): scores within 1e-5, classes and top-k
equal where the scores are not tied, the metrics equal; and the entry
point refusing to run without a card."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for the port's CPU work in this file: the suite
    runs six workers on the machine's cores."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


class _Args:
    log_identifier = ""
    num_classes = 1
    seg_threshold = 0.5
    mode = "test"

    def __init__(self, log_dir):
        self.log_dir = log_dir


def _tree(path):
    """{array path: array} of a zarr tree (the JAX package's reader)."""
    from cnn_autoencoder_tpu.storage import zarr as jzarr
    out = {}

    def walk(node, prefix):
        for key in node.keys():
            child = node[key]
            name = f"{prefix}/{key}" if prefix else key
            if hasattr(child, "keys"):
                walk(child, name)
            else:
                out[name] = child[...]
    walk(jzarr.open(path, mode="r"), "")
    return out


def test_prediction_tree_and_metrics_equal_jax(tmp_path):
    from cnn_autoencoder_tpu.cli import test_cae_classifier as jax_harness
    from cnn_autoencoder_tpu_torch.cli import test_cae_classifier as harness

    rng = np.random.RandomState(3)
    h = w = 48
    target = np.zeros((2, h, w, 1), np.uint8)
    target[0, 5:15, 6:18, 0] = 1
    target[0, 30:42, 28:40, 0] = 1
    target[1, 20:30, 2:9, 0] = 1
    logits = (target[..., 0].astype(np.float32) * 3.0 - 1.5
              + rng.randn(2, h, w) * 0.8)[..., None]
    x = rng.rand(2, h, w, 3).astype(np.float32)

    metrics = {}
    for name, mod in (("jax", jax_harness), ("torch", harness)):
        log_dir = tmp_path / name
        log_dir.mkdir()
        for im_id in range(2):
            mod.save_pred2zarr(str(log_dir / "output.zarr"), im_id,
                               x[im_id:im_id + 1], target[im_id:im_id + 1],
                               logits[im_id:im_id + 1], seg_threshold=0.5,
                               batch_size=1, patch_size=48, num_classes=1,
                               compute_components_metrics=True,
                               save_input=True)
        args = _Args(str(log_dir))
        metrics[name] = (mod.compute_metrics(args, object_level=False),
                         mod.compute_metrics(args, object_level=True))
    want = _tree(str(tmp_path / "jax" / "output.zarr"))
    got = _tree(str(tmp_path / "torch" / "output.zarr"))
    assert set(got) == set(want)
    assert {k.split("/")[0] for k in got} == {
        "input", "target", "scores", "class", "image_level",
        "object_level"}
    assert "scores/0/2" in got and "scores/1/1" in got  # the crops
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype, key
        if key.endswith(("/fpr", "/tpr", "/thrsh")):
            np.testing.assert_allclose(got[key], ref, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[key], ref, err_msg=key)
    for level in (0, 1):
        np.testing.assert_equal(metrics["torch"][level],
                                metrics["jax"][level])
    assert 0.5 < metrics["torch"][0]["auc"] <= 1.0


@pytest.fixture(scope="module")
def classifier_runs(tmp_path_factory):
    """Both harnesses' ``test()`` on one checkpoint with a classifier head
    (InceptionV3 cut 6: a small head; ``tests/test_torch_heads.py`` holds
    every head to flax) and one CIFAR-10-layout test batch of 12 images."""
    import jax
    from cnn_autoencoder_tpu.cli.test_cae_classifier import test as jax_test
    from cnn_autoencoder_tpu.models.factory import build_model
    from cnn_autoencoder_tpu.training.checkpoint import save_checkpoint
    from cnn_autoencoder_tpu.utils.args import get_args as jax_get_args
    from cnn_autoencoder_tpu.utils.loggers import \
        setup_logger as jax_setup_logger
    from cnn_autoencoder_tpu_torch.cli.test_cae_classifier import test
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger

    tmp = tmp_path_factory.mktemp("classifier")
    model = build_model(
        jax.random.PRNGKey(0), input_size=(32, 32), channels_org=3,
        channels_net=8, channels_bn=16, compression_level=2, K=4, r=3,
        act_layer_type="GDN", class_model_type="InceptionV3", cut_position=6,
        num_classes=10, patch_size=32)
    chk = dict(model.config)
    chk.update(model.variables)
    chk_path = str(tmp / "model.msgpack")
    save_checkpoint(chk_path, chk)
    data_dir = tmp / "cifar"
    data_dir.mkdir()
    rng = np.random.RandomState(0)
    with open(data_dir / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (12, 3072), np.uint8),
                     b"labels": list(rng.randint(0, 10, 12))}, f)
    out = {}
    for name, parse, setup, run in (
            ("jax", jax_get_args, jax_setup_logger, jax_test),
            ("torch", get_args, setup_logger,
             lambda a: test(a, device="cpu"))):
        log_dir = tmp / name
        args = parse("autoencoder", "test", args_list=[
            "-ds", "CIFAR10", "-dd", str(data_dir), "-chk", chk_path,
            "-ld", str(log_dir), "-rs", "1", "-bs", "4", "-ps", "32"])
        setup(args)
        out[name] = (run(args), _tree(str(log_dir / "output.zarr")))
    return out


def test_classifier_entry_point_matches_jax(classifier_runs):
    jax_metrics, want = classifier_runs["jax"]
    metrics, got = classifier_runs["torch"]
    assert set(got) == set(want)
    assert {k.split("/")[0] for k in got} == {"target", "scores", "class",
                                              "topk"}
    for key, ref in want.items():
        assert got[key].shape == ref.shape and got[key].dtype == ref.dtype
        if key.startswith("scores/"):
            np.testing.assert_allclose(got[key], ref, rtol=1e-5, atol=1e-7)
        elif key.startswith("target/"):
            np.testing.assert_array_equal(got[key], ref)
        else:
            # classes agree where the two best scores are not tied
            scores = np.sort(want["scores/" + key.split("/", 1)[1]], -1)
            clear = (scores[:, -1] - scores[:, -2]) > 1e-5
            if key.startswith("class/"):
                np.testing.assert_array_equal(got[key][clear],
                                              ref[clear])
    assert metrics["p"] == jax_metrics["p"] == 12
    if all((np.sort(v, -1)[:, -1] - np.sort(v, -1)[:, -2] > 1e-5).all()
           for k, v in want.items() if k.startswith("scores/")):
        np.testing.assert_equal(metrics, jax_metrics)  # NaN equals NaN


def _cifar_dir(path, n_batch, seed=0):
    rng = np.random.RandomState(seed)
    path.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(path / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n_batch, 3072),
                                              np.uint8),
                         b"labels": list(rng.randint(0, 10, n_batch))}, f)
    return path


def test_train_cli_trains_a_head_the_jax_package_serves(tmp_path):
    """``cli/train_cae.py`` with ``-cmt InceptionV3 -ccp 6 -cr RateMSECE
    -trm class_model`` from a CAE checkpoint without a head, on CIFAR-10
    pickles:
    3 steps and a validation, ``C=`` in the log, the encoder untouched; the
    ``last_`` checkpoint loads in the JAX package, whose classifier gives
    the port's logits (1e-5), and the port's harness evaluates it."""
    import jax
    import jax.numpy as jnp
    import torch
    from cnn_autoencoder_tpu.models.factory import build_model
    from cnn_autoencoder_tpu.models.factory import \
        autoencoder_from_state_dict as jax_from_state_dict
    from cnn_autoencoder_tpu.models.tasks import \
        make_forward_fn as jax_forward_fn
    from cnn_autoencoder_tpu.training.checkpoint import save_checkpoint
    from cnn_autoencoder_tpu_torch.cli import train_cae
    from cnn_autoencoder_tpu_torch.cli.test_cae_classifier import test
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.models.tasks import make_forward_fn
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger

    model = build_model(jax.random.PRNGKey(0), input_size=(32, 32),
                        channels_org=3, channels_net=8, channels_bn=16,
                        compression_level=2, K=4, r=3, act_layer_type="GDN")
    chk = dict(model.config)
    chk.update(model.variables)
    chk_path = str(tmp_path / "cae.msgpack")
    save_checkpoint(chk_path, chk)
    data = _cifar_dir(tmp_path / "cifar", 16)
    log_dir = tmp_path / "train"
    args = get_args("autoencoder", "training", args_list=[
        "-ds", "CIFAR10", "-dd", str(data), "-chk", chk_path, "-cmt",
        "InceptionV3", "-ccp", "6", "-cr", "RateMSECE", "-trm", "class_model", "-nch",
        "8", "-bch", "16", "-cl", "2", "-act", "GDN", "-bs", "8",
        "-vbs", "8", "-ps", "32", "-s", "2", "-cs", "5", "-esp", "100",
        "-rs", "0", "-ld", str(log_dir)])
    setup_logger(args)
    train_cae.main(args, device="cpu")
    last = [f for f in os.listdir(log_dir) if f.startswith("last_")]
    assert len(last) == 1
    last = str(log_dir / last[0])
    log_text = "".join(open(log_dir / f).read() for f in os.listdir(log_dir)
                       if f.endswith(".log"))
    assert " C=" in log_text

    port = autoencoder_from_state_dict(last, device="cpu")
    start = autoencoder_from_state_dict(chk_path, device="cpu")
    for key, value in start.encoder.state_dict().items():
        assert torch.equal(port.encoder.state_dict()[key], value), key
    ref_model = jax_from_state_dict(last)
    assert "class_model" in ref_model.modules
    x = np.random.RandomState(2).rand(4, 32, 32, 3).astype(np.float32)
    ref, _ = jax_forward_fn(ref_model.modules)(ref_model.variables,
                                              jnp.asarray(x))
    with torch.no_grad():
        out, _ = make_forward_fn(port)(torch.from_numpy(x))
    np.testing.assert_allclose(out["t_pred"].numpy(), np.asarray(
        ref["t_pred"]), rtol=1e-5, atol=1e-5 * float(np.abs(
            ref["t_pred"]).max()))

    test_args = get_args("autoencoder", "test", args_list=[
        "-ds", "CIFAR10", "-dd", str(data), "-chk", last, "-ld",
        str(tmp_path / "eval"), "-bs", "8", "-ps", "32"])
    setup_logger(test_args)
    metrics = test(test_args, device="cpu")
    assert metrics["p"] == 16 and 0.0 <= metrics["acc"] <= 1.0


def test_cli_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m",
         "cnn_autoencoder_tpu_torch.cli.test_cae_classifier", "-ds",
         "CIFAR10", "-dd", str(tmp_path), "-ld", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
