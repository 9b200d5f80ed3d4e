"""The port's RD sweep (``tools/rd_sweep.py``) against the JAX package's
``scripts/rd_sweep.py`` on the CPU: the holdout generator byte for byte,
the precision and file rules of the CAE half, and one run of each at a
128^2 holdout, patch 64, JPEG quality 50, their CSVs and stats files
compared (the JAX script in a subprocess with ``CAE_TPU_PRECISION`` unset,
started first and awaited last)."""

import contextlib
import csv
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu_torch.ops import convops as tc
from cnn_autoencoder_tpu_torch.tools import rd_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--images", "1", "--side", "128", "--patch-size", "64",
         "--qualities", "50"]
# compute_metrics' CPU tolerances against the JAX tool
# (tests/test_torch_tools.py): MS-SSIM in float32, the rest float64
JPEG_RTOL = {"ms-ssim": 1e-5}
METRICS = ("rate", "psnr", "ms-ssim", "ssim", "delta_cielab")


@pytest.mark.parametrize("h,w,seed", [(128, 128, 101), (200, 96, 0),
                                      (64, 320, 7)])
def test_synth_histology_matches_bench(h, w, seed, monkeypatch):
    """The port's copy of ``bench.synth_histology``, byte for byte
    (``CAE_TPU_PRECISION`` set first, so ``bench``'s ``setdefault`` leaves
    the environment as it was)."""
    monkeypatch.setenv("CAE_TPU_PRECISION", "highest")
    monkeypatch.syspath_prepend(REPO)
    import bench
    got = rd_sweep.synth_histology(h, w, seed=seed)
    want = bench.synth_histology(h, w, seed=seed)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("env", [None, "highest"])
def test_cae_half_precision_and_labels(env, tmp_path, monkeypatch):
    """``run_cae`` serves at ``CAE_TPU_PRECISION``, else at "bf16" (the
    JAX script's, through ``bench.py:39``), and restores the precision it
    found; with several checkpoints it keeps only the labelled stats files
    (the harness's ``metrics_stats_{990 + i}_CAE_.pth`` removed)."""
    if env is None:
        monkeypatch.delenv("CAE_TPU_PRECISION", raising=False)
    else:
        monkeypatch.setenv("CAE_TPU_PRECISION", env)
    seen = []

    def harness(args, device=None):
        seen.append((tc.get_default_precision(), args.seed, device))
        stats = {"codec": "CAE", "seed": args.seed,
                 "rate_stats": {"avg": 1.0}, "psnr_stats": {"avg": 30.0}}
        torch.save(stats, os.path.join(
            args.log_dir, "metrics_stats_%s_CAE_.pth" % args.seed))
        return stats, []

    monkeypatch.setattr(rd_sweep, "test_cae", harness)
    points = rd_sweep.cae_points("unused", "a=x.msgpack,b=y.msgpack")
    assert points == [("a", "x.msgpack"), ("b", "y.msgpack")]
    log_dir = str(tmp_path / "stats")
    os.makedirs(log_dir)
    stats = rd_sweep.run_cae(str(tmp_path), log_dir, str(tmp_path), points,
                             64, device="cpu")
    want = env or "bf16"
    assert seen == [(want, 990, "cpu"), (want, 991, "cpu")]
    assert [s["seed"] for s in stats] == ["a", "b"]
    assert sorted(n for n in os.listdir(log_dir) if n.endswith(".pth")) \
        == ["metrics_stats_a_CAE_.pth", "metrics_stats_b_CAE_.pth"]
    assert tc.get_default_precision() == "highest"
    assert rd_sweep.cae_points("c.msgpack") == [("1", "c.msgpack")]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """(JAX workdir, JAX stdout, port workdir, port stdout): the JAX script
    as a subprocess, and the port's ``main`` in-process on the CPU while it
    runs, both with ``CAE_TPU_PRECISION`` unset."""
    root = tmp_path_factory.mktemp("rd_sweep")
    jdir, tdir = str(root / "jax"), str(root / "port")
    env = {k: v for k, v in os.environ.items() if k != "CAE_TPU_PRECISION"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "rd_sweep.py")]
        + FLAGS + ["--workdir", jdir], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port_out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(port_out):
            mp.delenv("CAE_TPU_PRECISION", raising=False)
            rd_sweep.main(FLAGS + ["--workdir", tdir], device="cpu")
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return jdir, out, tdir, port_out.getvalue()


def _rows(workdir):
    with open(os.path.join(workdir, "rd_sweep.csv")) as f:
        return list(csv.reader(f.read().splitlines()))


def _stats(workdir, name):
    return torch.load(os.path.join(workdir, "stats", name),
                      weights_only=False)


def test_rd_sweep_matches_jax(sweeps):
    """The same files (the holdout PNG byte for byte, one stats file a
    point and a quality, ``rd_sweep.csv``); the CSV's header and row order
    equal; the JPEG row's stats within compute_metrics' tolerances and its
    CSV line equal; the CAE row (bf16 in both, the JAX script's through
    ``bench``) within the bf16 limits, |delta bpp| < 1 % and |delta PSNR|
    <= 0.05 dB; the printed table's header and codecs alike."""
    jdir, jout, tdir, tout = sweeps
    for sub in ("holdout", "stats"):
        names = {n for n in os.listdir(os.path.join(jdir, sub))
                 if not n.endswith(".log")}
        assert names == {n for n in os.listdir(os.path.join(tdir, sub))
                         if not n.endswith(".log")}, sub
    with open(os.path.join(jdir, "holdout", "holdout_00.png"), "rb") as f, \
            open(os.path.join(tdir, "holdout", "holdout_00.png"), "rb") as g:
        assert f.read() == g.read()
    jrows, trows = _rows(jdir), _rows(tdir)
    assert jrows[0] == trows[0] == rd_sweep.CSV_HEADER.strip().split(",")
    assert [r[:2] for r in jrows] == [r[:2] for r in trows]
    assert [r[:2] for r in jrows[1:]] == [["CAE", "1"], ["JPEG", "50"]]
    assert jrows[2] == trows[2]
    jj, tj = (_stats(d, "metrics_stats_JPEG_050.pth") for d in (jdir, tdir))
    for m in METRICS:
        a, b = tj[m + "_stats"]["avg"], jj[m + "_stats"]["avg"]
        if np.isnan(b):
            assert np.isnan(a), m
        else:
            np.testing.assert_allclose(a, b, rtol=JPEG_RTOL.get(m, 1e-10),
                                       err_msg=m)
    jc, tcae = (_stats(d, "metrics_stats_1_CAE_.pth") for d in (jdir, tdir))
    assert jc["seed"] == tcae["seed"] == "1"
    rate = (tcae["rate_stats"]["avg"], jc["rate_stats"]["avg"])
    assert abs(rate[0] - rate[1]) < 1e-2 * rate[1], rate
    psnr = (tcae["psnr_stats"]["avg"], jc["psnr_stats"]["avg"])
    assert abs(psnr[0] - psnr[1]) <= 0.05, psnr
    for out in (jout, tout):
        assert "| codec | quality | bpp | PSNR dB | MS-SSIM | SSIM | dE |" \
            in out
        assert "CAE[1]: " in out and "JPEG q=50 done" in out
        assert "| CAE | 1 |" in out and "| JPEG | 50 |" in out
