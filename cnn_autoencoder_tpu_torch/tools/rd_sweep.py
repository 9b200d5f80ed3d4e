"""CAE-against-JPEG RD sweep on synthetic holdout images: the port of the
JAX package's ``scripts/rd_sweep.py``.

    python -m cnn_autoencoder_tpu_torch.tools.rd_sweep [--images 4] \
        [--side 1024] [--workdir /tmp/cae_rd_sweep] [--checkpoint c.msgpack \
        | --checkpoints a=p1,b=p2] [--qualities 10,20,...] [--patch-size 512]

1. writes N holdout images (``synth_histology``, seeds ``101 + i``) to
   ``<workdir>/holdout``, each only if it is not there yet;
2. runs the RD harness (``cli/test_cae.py:test_cae``) on them once per
   checkpoint, saving each point's stats as
   ``metrics_stats_{label}_CAE_.pth`` (with several checkpoints the
   harness's own ``metrics_stats_{990 + i}_CAE_.pth`` is removed, so it
   never collides with a labelled copy);
3. sweeps JPEG over ``--qualities``, one ``python -m
   cnn_autoencoder_tpu_torch.tools.compute_metrics`` process a quality;
4. merges every ``metrics_stats_*.pth`` of ``<workdir>/stats`` into
   ``<workdir>/rd_sweep.csv`` (sorted by codec, then bpp) and prints the
   markdown table.

The JAX script imports ``bench`` before its harness, and ``bench.py:39``
sets ``CAE_TPU_PRECISION=bf16`` when it is unset, so its CAE rows are the
bf16 mode's unless the caller sets the variable: the CAE half here serves
at ``CAE_TPU_PRECISION`` if it is set, else at "bf16", and restores the
precision it found.  The harness and the metrics run on ``device`` (None:
the card).  ``main`` writes PNG holdouts, which need PIL; on a machine
without it, ``write_holdout(..., fmt="zarr")``, ``run_cae(...,
source_format="zarr")`` and ``merge`` run the CAE half on zarr stores.
"""

import argparse
import glob
import os
import subprocess
import sys

import numpy as np
import torch

from ..cli.test_cae import test_cae
from ..ops import convops
from ..utils.args import get_args
from ..utils.loggers import setup_logger

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKPOINT = os.path.join(PACKAGE_PARENT, "benchmarks",
                          "bench_flagship.msgpack")
CSV_HEADER = "codec,quality,bpp,psnr_db,ms_ssim,ssim,delta_e\n"


def synth_histology(h, w, seed=0):
    """Smooth low-frequency tissue-like structure + stain noise (the JAX
    package's ``bench.py:127``, byte for byte)."""
    rng = np.random.RandomState(seed)
    small = rng.rand(h // 64 + 2, w // 64 + 2, 3)
    idx_y = (np.arange(h) / 64.0)
    idx_x = (np.arange(w) / 64.0)
    y0 = idx_y.astype(np.int32)
    x0 = idx_x.astype(np.int32)
    fy = (idx_y - y0)[:, None, None]
    fx = (idx_x - x0)[None, :, None]
    a = small[y0][:, x0]
    b = small[y0][:, x0 + 1]
    c = small[y0 + 1][:, x0]
    d = small[y0 + 1][:, x0 + 1]
    img = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
           + c * fy * (1 - fx) + d * fy * fx)
    img = img * 120 + 110 + rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def write_holdout(img_dir, images, side, fmt="png"):
    """``holdout_{i:02d}.png`` (PIL) or ``.zarr`` (a raw YXC store, the
    image in group ``0/0``) for i < ``images``, each written only if it is
    missing."""
    if fmt == "png":
        from PIL import Image
    else:
        from ..storage import zarr as zarrlib
    os.makedirs(img_dir, exist_ok=True)
    for i in range(images):
        fn = os.path.join(img_dir, "holdout_%02d.%s" % (i, fmt))
        if os.path.exists(fn):
            continue
        img = synth_histology(side, side, seed=101 + i)
        if fmt == "png":
            Image.fromarray(img).save(fn)
        else:
            zarrlib.Group.create(fn).create_dataset(
                "0/0", shape=img.shape, chunks=img.shape, dtype=np.uint8,
                compressor=None)[...] = img
    print("holdout: %d x %d² images in %s" % (images, side, img_dir),
          flush=True)


def cae_points(checkpoint, checkpoints=None):
    """[(label, path)]: ``checkpoints``' label=path pairs, else
    ``("1", checkpoint)``."""
    if checkpoints:
        return [tuple(part.split("=", 1)) for part in checkpoints.split(",")]
    return [("1", checkpoint)]


def run_cae(img_dir, log_dir, workdir, points, patch_size, device=None,
            source_format="png"):
    """The RD harness once per (label, checkpoint) of ``points``; returns
    the stats of each, as saved under the label."""
    precision = os.environ.get("CAE_TPU_PRECISION", "bf16")
    found = convops.get_default_precision()
    zarr_flags = (["-dg", "0/0", "-da", "YXC"] if source_format == "zarr"
                  else [])
    out = []
    convops.set_default_precision(precision)
    try:
        for idx, (label, ckpt) in enumerate(points):
            # a seed of its own per run: the harness's file must never
            # collide with a labelled copy
            args = get_args("autoencoder", "test", args_list=[
                "-dd", img_dir, "-o", os.path.join(workdir, "tmp.zarr"),
                "-chk", ckpt, "-ps", str(patch_size), "-ld", log_dir, "-rs",
                str(990 + idx)] + zarr_flags)
            args.source_format = "." + source_format
            setup_logger(args)
            stats, _ = test_cae(args, device=device)
            stats["seed"] = label
            torch.save(stats, os.path.join(
                log_dir, "metrics_stats_%s_CAE_.pth" % label))
            harness_fn = os.path.join(log_dir, "metrics_stats_%s_CAE_.pth"
                                      % args.seed)
            if str(args.seed) != str(label) and os.path.exists(harness_fn):
                os.remove(harness_fn)
            print("CAE[%s]: %.3f bpp  %.2f dB" % (
                label, stats["rate_stats"]["avg"],
                stats["psnr_stats"]["avg"]), flush=True)
            out.append(stats)
    finally:
        convops.set_default_precision(found)
    return out


def run_jpeg(img_dir, log_dir, workdir, qualities, device=None):
    """One ``tools.compute_metrics`` process per JPEG quality over the PNG
    holdout, its metrics on ``device``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
    dev = [] if device is None else ["--device", str(device)]
    for q in qualities:
        subprocess.run([sys.executable, "-m",
                        "cnn_autoencoder_tpu_torch.tools.compute_metrics",
                        "-sd", img_dir, "-dd", os.path.join(workdir, "jpg"),
                        "-sf", "PNG", "-df", "JPEG", "-cq", str(q), "-ld",
                        log_dir] + dev, check=True, env=env)
        print("JPEG q=%d done" % q, flush=True)


def merge(workdir, log_dir):
    """Every stats file of ``log_dir`` as a row (codec, label or quality,
    bpp, PSNR, MS-SSIM, SSIM, delta-E), sorted by codec then bpp, written
    to ``<workdir>/rd_sweep.csv`` and printed as a markdown table; returns
    the rows."""
    rows = []
    for fn in sorted(glob.glob(os.path.join(log_dir,
                                            "metrics_stats_*.pth"))):
        s = torch.load(fn, weights_only=False)
        ident = s.get("seed", s.get("quality", ""))
        rows.append((s["codec"], ident, s["rate_stats"]["avg"],
                     s["psnr_stats"]["avg"], s["ms-ssim_stats"]["avg"],
                     s["ssim_stats"]["avg"], s["delta_cielab_stats"]["avg"]))
    rows.sort(key=lambda r: (r[0], r[2]))
    csv_fn = os.path.join(workdir, "rd_sweep.csv")
    with open(csv_fn, "w") as f:
        f.write(CSV_HEADER)
        for r in rows:
            f.write("%s,%s,%.4f,%.2f,%.4f,%.4f,%.3f\n" % r)
    print("\n| codec | quality | bpp | PSNR dB | MS-SSIM | SSIM | dE |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print("| %s | %s | %.3f | %.2f | %.4f | %.4f | %.2f |" % r)
    print("\nwrote", csv_fn, flush=True)
    return rows


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--workdir", default="/tmp/cae_rd_sweep")
    ap.add_argument("--checkpoint", default=CHECKPOINT)
    ap.add_argument("--checkpoints", default=None,
                    help="comma-separated label=path pairs for a multi-"
                         "point CAE curve; overrides --checkpoint")
    ap.add_argument("--qualities", default="10,20,30,40,50,60,70,80,90,95")
    ap.add_argument("--patch-size", type=int, default=512)
    args = ap.parse_args(argv)

    img_dir = os.path.join(args.workdir, "holdout")
    log_dir = os.path.join(args.workdir, "stats")
    write_holdout(img_dir, args.images, args.side)
    os.makedirs(log_dir, exist_ok=True)
    run_cae(img_dir, log_dir, args.workdir,
            cae_points(args.checkpoint, args.checkpoints), args.patch_size,
            device)
    run_jpeg(img_dir, log_dir, args.workdir,
             [int(s) for s in args.qualities.split(",")], device)
    return merge(args.workdir, log_dir)


if __name__ == "__main__":
    main()
