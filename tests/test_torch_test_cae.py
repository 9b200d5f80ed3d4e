"""The port's RD harness (``cli/test_cae.py``) against the JAX package's on
``tests/test_harnesses.py:28``'s tiny model and its two 176x192 PNGs: the
stats file's keys and schema exactly equal, the rate exactly equal (the
stores are byte-equal), the reconstructions within the ``test_rd_parity``
u8 tolerance and every other metric within what that tolerance allows;
then the harness's metrics on one reconstruction against the JAX
functions' (1e-10 relative, ``tests/test_torch_metrics.py``); and the
entry point refusing to run without a card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_turbo import _assert_u8_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what < 0.5 % of u8 pixels off by one can move (test_rd_parity.py:80-85)
METRIC_ATOL = {"dist": 0.05, "ms-ssim": 1e-3, "ssim": 1e-3, "psnr": 0.05,
               "delta_cielab": 0.05}


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """Both harnesses over the same checkpoint and PNG directory."""
    import jax
    from PIL import Image

    from cnn_autoencoder_tpu.cli.test_cae import test_cae as jax_test_cae
    from cnn_autoencoder_tpu.models.factory import build_model
    from cnn_autoencoder_tpu.training.checkpoint import save_checkpoint
    from cnn_autoencoder_tpu.utils.args import get_args as jax_get_args
    from cnn_autoencoder_tpu.utils.loggers import \
        setup_logger as jax_setup_logger
    from cnn_autoencoder_tpu_torch.cli.test_cae import test_cae
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    from tests.test_harnesses import _fit_quantiles

    tmp = tmp_path_factory.mktemp("rd")
    model = _fit_quantiles(build_model(
        jax.random.PRNGKey(0), input_size=(32, 32), channels_org=3,
        channels_net=8, channels_bn=16, compression_level=2, K=4, r=3,
        act_layer_type="GDN"))
    chk = dict(model.config)
    chk.update(model.variables)
    chk_path = str(tmp / "model.msgpack")
    save_checkpoint(chk_path, chk)

    img_dir = tmp / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        yy, xx = np.mgrid[0:176, 0:192]
        img = np.clip((np.sin(yy / 7) + np.cos(xx / 5))[:, :, None] * 50
                      + 128 + rng.randn(176, 192, 3) * 5, 0,
                      255).astype(np.uint8)
        Image.fromarray(img).save(str(img_dir / f"im{i}.png"))

    out = {}
    for name, parse, setup, run in (
            ("jax", jax_get_args, jax_setup_logger, jax_test_cae),
            ("torch", get_args, setup_logger,
             lambda a: test_cae(a, device="cpu"))):
        log_dir = tmp / name
        args = parse("autoencoder", "test", args_list=[
            "-dd", str(img_dir), "-o", str(log_dir / "tmp.zarr"), "-chk",
            chk_path, "-ps", "32", "-ld", str(log_dir), "-rs", "1"])
        args.source_format = ".png"
        setup(args)
        stats = run(args)
        saved = torch.load(str(log_dir / "metrics_stats_1_CAE_.pth"),
                           weights_only=False)
        out[name] = (stats, saved, str(log_dir / "tmp.zarr"))
    return out


def test_stats_file_schema_and_rate_equal_jax(harness_runs):
    _, jax_saved, _ = harness_runs["jax"]
    _, saved, _ = harness_runs["torch"]
    assert set(saved) == set(jax_saved)
    assert saved["codec"] == jax_saved["codec"] == "CAE"
    assert saved["seed"] == jax_saved["seed"] == 1
    for key, value in jax_saved.items():
        assert type(saved[key]) is type(value), key
        if isinstance(value, dict):
            assert set(saved[key]) == set(value), key
        elif isinstance(value, list):
            assert len(saved[key]) == len(value) == 2, key
            assert all(isinstance(v, float) for v in saved[key]), key
    assert saved["rate"] == jax_saved["rate"]
    assert saved["rate_stats"] == jax_saved["rate_stats"]


def test_metrics_within_rd_parity(harness_runs):
    from cnn_autoencoder_tpu.storage import zarr as jzarr
    _, jax_saved, jax_store = harness_runs["jax"]
    _, saved, store = harness_runs["torch"]
    rec_j = jzarr.open(jax_store, mode="r")["decompressed/0/0"][...]
    rec_t = jzarr.open(store, mode="r")["decompressed/0/0"][...]
    _assert_u8_close(rec_t, rec_j)
    for key, atol in METRIC_ATOL.items():
        np.testing.assert_allclose(saved[key], jax_saved[key], rtol=0,
                                   atol=atol, err_msg=key)
        assert np.all(np.isfinite(saved[key])), key
    assert saved["psnr_stats"]["avg"] > 0 and saved["rate_stats"]["avg"] > 0


def test_per_image_metrics_and_stage_times(harness_runs):
    """``test_cae`` returns each input's metrics beside the stats: the
    values the stats list, and the round trip's time split into its
    compress and decompress stages."""
    (stats, per_image), saved, _ = harness_runs["torch"]
    assert len(per_image) == 2
    for key in ("rate", "psnr", "execution_time"):
        assert [one[key] for one in per_image] == saved[key] == stats[key]
    for one in per_image:
        assert one["compress_time"] > 0 and one["decompress_time"] > 0
        assert one["compress_time"] + one["decompress_time"] == \
            pytest.approx(one["execution_time"], rel=1e-9)


def test_metric_functions_on_a_reconstruction_equal_jax(harness_runs):
    """The harness's METRIC_FUN on the JAX harness's last input and its
    reconstruction, against the JAX harness's METRIC_FUN."""
    from cnn_autoencoder_tpu.cli.test_cae import METRIC_FUN as JAX_FUN
    from cnn_autoencoder_tpu.storage import zarr as jzarr
    from cnn_autoencoder_tpu_torch.cli.test_cae import METRIC_FUN
    from PIL import Image
    _, _, jax_store = harness_runs["jax"]
    img_dir = os.path.join(os.path.dirname(os.path.dirname(jax_store)),
                           "imgs")
    x = np.asarray(Image.open(os.path.join(img_dir, "im1.png")),
                   np.float64)
    z = jzarr.open(jax_store, mode="r")
    x_r = z["decompressed/0/0"][...].astype(np.float64)
    xt, xrt = torch.from_numpy(x), torch.from_numpy(x_r)
    assert list(METRIC_FUN) == list(JAX_FUN)
    for key in METRIC_FUN:
        if key == "rate":
            continue
        ref, _ = JAX_FUN[key](x=x, x_r=x_r)
        got, _ = METRIC_FUN[key](x=xt, x_r=xrt)
        rtol = 1e-5 if key == "ms-ssim" else 1e-10  # float32 MS-SSIM
        np.testing.assert_allclose(got, ref, rtol=rtol, err_msg=key)


def test_ms_ssim_too_small_is_nan():
    from cnn_autoencoder_tpu_torch.cli.test_cae import compute_ms_ssim
    x = torch.zeros(64, 64, 3, dtype=torch.float64)
    score, extra = compute_ms_ssim(x=x, x_r=x)
    assert np.isnan(score) and extra is None


def test_cli_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "cnn_autoencoder_tpu_torch.cli.test_cae",
         "-dd", str(tmp_path), "-ld", str(tmp_path), "-chk", "x.msgpack"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
