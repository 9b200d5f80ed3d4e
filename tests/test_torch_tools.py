"""The port's offline tools (``cnn_autoencoder_tpu_torch/tools``) against
the JAX package's ``scripts/`` on the same seeded inputs, on the CPU:

* refit: every leaf and config value equal but the quantiles, those within
  1e-5 (``tests/test_torch_entropy_train.py``'s bisection tolerance), the
  file read by the JAX ``load_checkpoint``; the bracket's silent clamp in
  both;
* transfer: each mode's output tree equal; ``torch2jax``'s file byte-equal
  and read alike by both packages;
* masks, labels, dataset files, PNGs and converted images: every file
  byte-equal; compressors: stored bytes equal;
* metrics: RMSE, SSIM, PSNR and delta-E within 1e-10 relative (float64 on
  both sides, ``tests/test_torch_metrics.py``), MS-SSIM within 1e-5
  (float32, ``tests/test_torch_msssim.py``; its stats also within 1e-6),
  the ``.pth`` keys equal, the
  dumps' CSVs equal;
* visualize_groups: the mosaic and the selection equal, PCA, Isomap and a
  5-iteration t-SNE within 1e-5 of their scales up to each column's sign
  (the port's PCA runs in float64, numpy's in float32, and t-SNE grows the
  start's difference; ``tests/test_torch_manifold.py`` says why no longer
  run is compared);
* imports: every tool module and ``utils/manifold.py`` import with jax,
  flax, msgpack, the JAX package, PIL and matplotlib blocked.
"""

import importlib
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.storage import zarr as jzarr
from cnn_autoencoder_tpu.training.checkpoint import \
    load_checkpoint as jax_load
from cnn_autoencoder_tpu_torch.tools import (compare_compressors,
                                             compute_labels, compute_mask,
                                             compute_metrics,
                                             convert_dataset,
                                             dump_metrics_jpeg,
                                             dump_training_stats,
                                             refit_quantiles,
                                             transfer_weights,
                                             visualize_groups, zarr2dataset,
                                             zarr2png)
from cnn_autoencoder_tpu_torch.training.checkpoint import (load_checkpoint,
                                                           save_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
FLAGSHIP = os.path.join(REPO, "benchmarks", "bench_flagship.msgpack")
TOOLS = ("refit_quantiles", "transfer_weights", "visualize_groups",
         "compute_metrics", "dump_metrics_jpeg", "dump_training_stats",
         "compare_compressors", "compute_mask", "compute_labels",
         "zarr2dataset", "zarr2png", "convert_dataset")


def _run_jax_main(monkeypatch, name, argv):
    """The JAX script's ``main`` with ``sys.argv`` set to ``argv``."""
    monkeypatch.setattr(sys, "argv", [name + ".py"] + list(argv))
    importlib.import_module(name).main()


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


# -- refit_quantiles ----------------------------------------------------------


def _shifted_flagship(path):
    """The flagship with its last bias raised by 2e4: every channel's median
    falls below the bisection's bracket [-256, 256]."""
    state = load_checkpoint(FLAGSHIP)
    p = dict(state["fact_ent"]["params"])
    p["bias_4"] = np.asarray(p["bias_4"]) + np.float32(2e4)
    state["fact_ent"] = {**state["fact_ent"], "params": p}
    save_checkpoint(path, state)


@pytest.mark.parametrize("case", ["flagship", "outside_bracket"])
def test_refit_quantiles_matches_jax(tmp_path, monkeypatch, capsys, case):
    src = str(tmp_path / "src.msgpack")
    if case == "flagship":
        shutil.copy(FLAGSHIP, src)
    else:
        _shifted_flagship(src)
    a, b = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    shutil.copy(src, a)
    shutil.copy(src, b)
    _run_jax_main(monkeypatch, "refit_quantiles", [a])
    refit_quantiles.main([b], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{a}: aux ") and out[1].startswith(
        f"{b}: aux ")
    aux = [[float(v) for v in line.split(": aux ")[1].split(" -> ")]
           for line in out]
    np.testing.assert_allclose(aux[1], aux[0], rtol=1e-4, atol=0.02)

    orig, got, want = jax_load(src), jax_load(b), jax_load(a)
    assert set(got) == set(want)
    leaves_got, leaves_want = dict(_leaves(got)), dict(_leaves(want))
    assert set(leaves_got) == set(leaves_want)
    for k, v in leaves_want.items():
        if k == "/fact_ent/params/quantiles":
            q = np.asarray(leaves_got[k])
            assert q.dtype == np.float32 and q.shape == v.shape
            np.testing.assert_allclose(q, v, rtol=0, atol=1e-5)
            assert not np.array_equal(q, np.asarray(
                dict(_leaves(orig))[k]))
        elif isinstance(v, np.ndarray):
            assert leaves_got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(leaves_got[k], v, err_msg=k)
        else:
            assert leaves_got[k] == v, k
    if case == "outside_bracket":
        # the silent clamp (the JAX package's too): every median at -256
        np.testing.assert_allclose(want["fact_ent"]["params"]["quantiles"]
                                   [:, 0, 1], -256.0, atol=1e-3)
    # the port reads its own file to the same arrays
    np.testing.assert_array_equal(
        load_checkpoint(b)["fact_ent"]["params"]["quantiles"],
        got["fact_ent"]["params"]["quantiles"])


# -- transfer_weights ---------------------------------------------------------


def _cai_checkpoint(gen):
    """A compressai-style flat state dict (``test_scripts.py``'s layout)."""
    def r(*shape):
        return torch.randn(*shape, generator=gen)
    chk = {"g_a.0.weight": r(8, 3, 3, 3), "g_a.1.gamma": r(8, 8, 1, 1),
           "g_a.1.beta": r(8), "g_a.2.weight": r(16, 8, 3, 3),
           "g_s.0.weight": r(16, 8, 3, 3), "g_s.0.bias": r(8),
           "g_s.1.weight": r(8, 3, 3, 3),
           "entropy_bottleneck.quantiles": r(16, 1, 3),
           "entropy_bottleneck._offset": r(16),
           "entropy_bottleneck.likelihood_lower_bound.bound": r(1),
           "g_a.unknown": r(2)}
    for i in range(5):
        chk[f"entropy_bottleneck._matrices.{i}"] = r(16, 3, 3)
        chk[f"entropy_bottleneck._biases.{i}"] = r(16, 3, 1)
        if i < 4:
            chk[f"entropy_bottleneck._factors.{i}"] = r(16, 3, 1)
    return chk


def _cae_checkpoint(seed):
    from tests.test_torch_pth_import import _reference
    chk = _reference("GDN", False, False, False, seed=seed)
    chk.update(args={"lr": 1e-4, "seed": seed}, epoch=3 + seed,
               best_val=0.5 + seed)
    return chk


def _assert_torch_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_torch_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


TRANSFER_CASES = {
    "cai2cae": ("cai", "cae"), "cae2cai": ("cae", None),
    "cae2cae": ("cae", "cae"), "last2best": ("cae", "cae")}


@pytest.mark.parametrize("mode", sorted(TRANSFER_CASES))
def test_transfer_weights_matches_jax(tmp_path, monkeypatch, mode):
    src_kind, dst_kind = TRANSFER_CASES[mode]
    src = str(tmp_path / "src.pth")
    torch.save(_cai_checkpoint(torch.Generator().manual_seed(0))
               if src_kind == "cai" else _cae_checkpoint(0), src)
    argv = ["-m", mode, "-s", src]
    if dst_kind:
        dst = str(tmp_path / "dst.pth")
        torch.save(_cae_checkpoint(1), dst)
        argv += ["-d", dst]
    out_j, out_p = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    _run_jax_main(monkeypatch, "transfer_weights", argv + ["-o", out_j])
    transfer_weights.main(argv + ["-o", out_p])
    want = torch.load(out_j, weights_only=False)
    _assert_torch_tree_equal(torch.load(out_p, weights_only=False), want)
    if mode == "cai2cae":
        assert "analysis_track.1.model.0.weight" in want["encoder"]
        assert "_matrix4" in want["fact_ent"]


def test_transfer_cae_round_trip_keys(tmp_path):
    """cae2cai then cai2cae (grafted into the source) gives back every
    encoder and decoder key and tensor; of the entropy model's keys only
    ``.quantiles`` comes back (the JAX script's ``fact_ent`` tag)."""
    chk = _cae_checkpoint(2)
    src, cai, back = (str(tmp_path / n) for n in ("src.pth", "cai.pth",
                                                    "back.pth"))
    torch.save(chk, src)
    transfer_weights.main(["-m", "cae2cai", "-s", src, "-o", cai])
    transfer_weights.main(["-m", "cai2cae", "-s", cai, "-d", src, "-o",
                           back])
    out = torch.load(back, weights_only=False)
    for module in ("encoder", "decoder"):
        _assert_torch_tree_equal(out[module], chk[module], module)
    assert set(out["fact_ent"]) == {".quantiles"}
    assert torch.equal(out["fact_ent"][".quantiles"],
                       chk["fact_ent"]["quantiles"])


def test_torch2jax_matches_jax(tmp_path, monkeypatch):
    src = str(tmp_path / "ref.pth")
    torch.save(_cae_checkpoint(3), src)
    out_j, out_p = (str(tmp_path / n) for n in ("jax.msgpack",
                                                  "port.msgpack"))
    _run_jax_main(monkeypatch, "transfer_weights",
                  ["-m", "torch2jax", "-s", src, "-o", out_j])
    transfer_weights.main(["-m", "torch2jax", "-s", src, "-o", out_p])
    with open(out_j, "rb") as f, open(out_p, "rb") as g:
        assert f.read() == g.read()
    want = dict(_leaves(jax_load(out_j)))
    for got in (jax_load(out_p), load_checkpoint(out_p)):
        got = dict(_leaves(got))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)


# -- masks, labels, dataset files, compressors --------------------------------


def _slide(path, h=256, w=256):
    rng = np.random.RandomState(h)
    img = np.full((h, w, 3), 235, np.uint8)
    y0, x0 = h // 6, w // 4
    img[y0:h - y0, x0:w - x0 // 2] = (rng.rand(h - 2 * y0, w - x0 - x0 // 2,
                                              3) * 100 + 60).astype(np.uint8)
    arr = jzarr.Group.create(path).create_dataset(
        "0/0", shape=img.shape, chunks=(128, 128, 3), dtype=np.uint8,
        compressor=None, overwrite=True)
    arr[...] = img


def test_masks_and_labels_match_jax(tmp_path, monkeypatch):
    """compute_mask over a directory of stores, then compute_labels with a
    ``::label`` suffix: every file of the outputs byte-equal."""
    slides = tmp_path / "slides"
    slides.mkdir()
    _slide(str(slides / "a.zarr"))
    _slide(str(slides / "b.zarr"), 192, 256)
    outs = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        out.mkdir()
        argv = ["-i", str(slides), "-o", str(out), "-da", "YXC", "-s", "40",
                "-dm", "40"]
        if side == "jax":
            _run_jax_main(monkeypatch, "compute_mask", argv)
        else:
            compute_mask.main(argv)
        argv = ["-i", str(out / "a.zarr") + "::3", "-o", str(out)]
        if side == "jax":
            _run_jax_main(monkeypatch, "compute_labels", argv)
        else:
            compute_labels.main(argv)
        outs[side] = _files(str(out))
    assert outs["port"] == outs["jax"]
    assert "a.zarr/masks/0/0/0.0" in outs["port"]
    assert "a.zarr/masks/1/0/0.0" in outs["port"]
    mask = jzarr.open(str(tmp_path / "port" / "a.zarr"))["masks/0/0"][...]
    assert mask.any() and not mask.all()


def test_zarr2dataset_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    inputs = (rng.rand(16, 16, 3, 3) * 255).astype(np.uint8)
    labels = (rng.rand(16, 16, 1, 3) > 0.5).astype(np.uint8)
    in_path, lbl_path = str(tmp_path / "in.zarr"), str(tmp_path / "lb.zarr")
    for path, data in ((in_path, inputs), (lbl_path, labels)):
        jzarr.Array.create(path, shape=data.shape, chunks=data.shape,
                           dtype=np.uint8, compressor=None)[...] = data
    importlib.import_module("zarr2dataset").main(in_path, lbl_path,
                                     str(tmp_path / "jax"))
    zarr2dataset.main(["-i", in_path, "-l", lbl_path, "-o",
                       str(tmp_path / "port")])
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert got == want and "0002.zarr/1/0/0.0.0" in got


def test_compressor_sizes_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    data = np.round(rng.randn(64, 48, 8) * 3).astype(np.float32)
    path = str(tmp_path / "bn.zarr")
    jzarr.Group.create(path).create_dataset(
        "0/0", shape=data.shape, chunks=data.shape, dtype=np.float32,
        compressor=None)[...] = data
    jax_cc = importlib.import_module("compare_compressors")
    src = jzarr.open(path)["0/0"]
    want = {name: jax_cc.test_compressor(src, name, 5, 32,
                                         tmp_dir=str(tmp_path))[0]
            for name in jax_cc.COMPRESSORS}
    got = compare_compressors.main([path, "32", "5"], tmp_dir=str(tmp_path))
    assert got == want and all(0 < v < data.nbytes for v in got.values())


# -- metrics and dumps --------------------------------------------------------


def _pair(seed, side):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    img = np.clip(np.stack([120 + 60 * np.sin(xx / 17.0),
                            110 + 60 * np.cos(yy / 13.0),
                            128 + 50 * np.sin((xx + yy) / 23.0)], -1)
                  + rng.randn(side, side, 3) * 4, 0, 255).astype(np.uint8)
    rec = np.clip(img + rng.randn(side, side, 3) * 6, 0, 255).astype(
        np.uint8)
    return img, rec


@pytest.mark.parametrize("side", [176, 64])
def test_metrics_arrays_match_jax(side):
    """176^2 takes MS-SSIM's five levels; 64^2 is too small (NaN in both)."""
    jcm = importlib.import_module("compute_metrics")
    img, rec = _pair(side, side)
    got = compute_metrics.metrics_arrays(img, rec, 1234, device="cpu")
    x, x_r = img.astype(np.float64), rec.astype(np.float64)
    want = {"rate": jcm.compute_rate(img, 1234)}
    want.update({k: fun(x, x_r) for k, fun in jcm.metric_fun.items()})
    assert list(got) == list(want)
    for k, v in want.items():
        if k == "ms-ssim" and side == 64:
            assert np.isnan(v) and np.isnan(got[k])
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5 if k ==
                                       "ms-ssim" else 1e-10, err_msg=k)


def test_compute_metrics_and_dump_match_jax(tmp_path, monkeypatch):
    """The PIL sweep into ``metrics_stats_JPEG_080*.pth`` through both
    tools (keys equal, values within the metrics' tolerances), then both
    dumps of the stats directory: CSVs equal."""
    from PIL import Image
    src = tmp_path / "src"
    src.mkdir()
    for i, seed in enumerate((3, 4)):
        Image.fromarray(_pair(seed, 176)[0]).save(str(src / f"im{i}.png"))
    logs = {}
    for side in ("jax", "port"):
        logs[side] = tmp_path / f"logs_{side}"
        logs[side].mkdir()
        argv = ["-sd", str(src), "-dd", str(tmp_path / f"dst_{side}"),
                "-sf", "png", "-df", "JPEG", "-cq", "80", "-ld",
                str(logs[side]), "-li", "_x"]
        if side == "jax":
            _run_jax_main(monkeypatch, "compute_metrics", argv)
        else:
            compute_metrics.main(argv, device="cpu")
    name = "metrics_stats_JPEG_080_x.pth"
    want = torch.load(str(logs["jax"] / name), weights_only=False)
    got = torch.load(str(logs["port"] / name), weights_only=False)
    assert list(got) == list(want)
    for k in want:
        if k.startswith("time") or k in ("codec", "quality"):
            assert k.startswith("time") or got[k] == want[k]
            continue
        tol = (dict(rtol=1e-5, atol=1e-6) if k.startswith("ms-ssim")
               else dict(rtol=1e-10, atol=0))
        if isinstance(want[k], dict):
            assert list(got[k]) == list(want[k])
            np.testing.assert_allclose(list(got[k].values()),
                                       list(want[k].values()), **tol)
        else:
            np.testing.assert_allclose(got[k], want[k], **tol)

    csvs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / f"{side}.csv")
        argv = ["-d", str(logs["jax"]), "-m", "JPEG", "-o", out]
        if side == "jax":
            _run_jax_main(monkeypatch, "dump_metrics_jpeg", argv)
        else:
            dump_metrics_jpeg.main(argv)
        csvs[side] = [open(p).read() for p in (out, out[:-4]
                                               + "_per_img.csv")]
    assert csvs["port"] == csvs["jax"]
    assert csvs["port"][1].count("\n") == 3


def test_dump_training_stats_matches_jax(tmp_path, monkeypatch):
    """A log of the port's own ``log_info`` lines and a checkpoint with
    loss histories: both CSVs equal."""
    from cnn_autoencoder_tpu_torch.utils.loggers import log_info
    lines = []
    for step in range(1, 4):
        stats = {"dist": np.float32(0.01 * step),
                 "rate_loss": np.float32(2.5 - 0.1 * step),
                 "x_r_min": np.float32(-0.1), "x_r_max": np.float32(1.1),
                 "x_r_std": np.float32(0.2),
                 "entropy_loss": np.float32(300.0 / step),
                 "energy": np.float32(0.5)}
        line, _ = log_info(step, step, 8, stats, avg_loss=1.0 / step,
                           quantiles=np.asarray([[[-10.0, 0.0, 10.0]]]),
                           channel_e=3, lr="encoder=1.00e-04",
                           step_type="Training" if step < 3
                           else "Validation")
        lines.append(line)
    log = tmp_path / "train.log"
    log.write_text("\n".join(lines) + "\nnot a metric line\n")
    chk = str(tmp_path / "last.msgpack")
    save_checkpoint(chk, {"step": 6, "train_loss": [0.9, 0.8],
                          "valid_loss": [1.0, 0.95, 0.9],
                          "extra_metrics": {"channel_e": [3, 3]}})
    outs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / f"{side}.csv")
        argv = ["-l", str(log), "-k", chk, "-o", out]
        if side == "jax":
            _run_jax_main(monkeypatch, "dump_training_stats", argv)
        else:
            dump_training_stats.main(argv)
        outs[side] = [open(p).read() for p in (out, out[:-4]
                                               + "_checkpoint.csv")]
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].count("\n") == 4
    assert outs["port"][1].count("\n") == 4


# -- PIL tools ----------------------------------------------------------------


def test_zarr2png_and_convert_dataset_match_jax(tmp_path, monkeypatch):
    from PIL import Image
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.RandomState(5)
    for name in ("a", "b"):
        seg = (rng.rand(1, 24, 20) > 0.5).astype(np.float32)
        jzarr.Group.create(str(src / f"{name}.zarr")).create_dataset(
            "labels/segmentation_7/0/0", shape=seg.shape, chunks=seg.shape,
            dtype=np.float32, compressor=None)[...] = seg
        Image.fromarray(_pair(ord(name), 32)[0]).save(str(src / f"{name}"
                                                         ".png"))
    for side in ("jax", "port"):
        argv = ["-d", str(src), "-o", str(tmp_path / f"png_{side}"), "-s",
                "7"]
        conv = ["-sd", str(src), "-dd", str(tmp_path / f"conv_{side}"),
                "-sf", "PNG", "-df", "JPEG"]
        if side == "jax":
            _run_jax_main(monkeypatch, "zarr2png", argv)
            _run_jax_main(monkeypatch, "convert_dataset", conv)
        else:
            zarr2png.main(argv)
            convert_dataset.main(conv)
    for kind, n in (("png", 2), ("conv", 22)):
        got = _files(str(tmp_path / f"{kind}_port"))
        assert got == _files(str(tmp_path / f"{kind}_jax")) and len(got) == n


# -- visualize_groups ---------------------------------------------------------


def test_visualize_groups_matches_jax(tmp_path, monkeypatch):
    jvg = importlib.import_module("visualize_groups")
    rng = np.random.RandomState(2)
    paths = []
    for i in range(2):
        lat = (rng.rand(12, 12, 8) * 4 - 2 + i).astype(np.float32)
        paths.append(str(tmp_path / f"lat{i}.zarr"))
        jzarr.Array.create(paths[-1], shape=lat.shape, chunks=lat.shape,
                           dtype=np.float32, compressor=None)[...] = lat
    np.testing.assert_array_equal(
        visualize_groups.feature_mosaic(lat, device="cpu").numpy(),
        jvg.feature_mosaic(lat))

    vecs = np.concatenate([visualize_groups.sample_vectors(
        jzarr.open(p)[...], 100)[0] for p in paths])
    want = jvg.compute_embeddings(vecs, ["pca", "tsne", "isomap"],
                                  tsne_iters=5)
    times = {}
    got = visualize_groups.compute_embeddings(
        vecs, ["pca", "tsne", "isomap"], tsne_iters=5, device="cpu",
        times=times)
    assert set(times) == {"pca", "tsne", "isomap"}
    for kind in want:
        g, w = got[kind].numpy(), want[kind]
        assert g.dtype == w.dtype == np.float32, kind
        s = np.sign(np.sum(g * w, axis=0))
        np.testing.assert_allclose(g * s, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=kind)
    rect = (-1e9, -1e9, 0.0, 1e9)
    np.testing.assert_array_equal(
        visualize_groups.select_in_rect(want["pca"], rect,
                                        device="cpu").numpy(),
        jvg.select_in_rect(want["pca"], rect))

    out = {}
    for side in ("jax", "port"):
        argv = ["-i"] + paths + ["-o", str(tmp_path / side), "-e", "all",
                                 "--tsne-iters", "20", "--max-points", "60",
                                 "--select", "-1e9", "-1e9", "1e9", "1e9"]
        if side == "jax":
            jvg.main(argv)
        else:
            visualize_groups.main(argv, device="cpu")
        out[side] = sorted(os.listdir(str(tmp_path / side)))
    assert out["port"] == out["jax"]
    assert "lat1_selected_positions.png" in out["port"]


# -- imports and devices ------------------------------------------------------


def test_tools_import_without_jax_pil_or_matplotlib():
    """A subprocess that refuses jax, flax, msgpack, the JAX package, PIL and
    matplotlib imports every tool module and ``utils/manifold.py``."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, sys

        BLOCKED = {"jax", "jaxlib", "flax", "msgpack", "cnn_autoencoder_tpu",
                   "PIL", "matplotlib"}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        for name in sys.argv[1:]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("imported", len(sys.argv) - 1)
    """)
    mods = ["cnn_autoencoder_tpu_torch.tools." + t for t in TOOLS] + [
        "cnn_autoencoder_tpu_torch.tools",
        "cnn_autoencoder_tpu_torch.utils.manifold"]
    run = subprocess.run([sys.executable, "-c", code] + mods, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == f"imported {len(mods)}"


def test_device_none_means_the_card(tmp_path):
    """The tools' dense arithmetic defaults to the card; without one it
    raises instead of running on the CPU."""
    path = str(tmp_path / "c.msgpack")
    shutil.copy(FLAGSHIP, path)
    img, rec = _pair(1, 32)
    calls = (lambda: refit_quantiles.refit(path),
             lambda: compute_metrics.metrics_arrays(img, rec, 10),
             lambda: visualize_groups.pca_2d(img.reshape(-1, 3)))
    for call in calls if not torch.cuda.is_available() else ():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with open(path, "rb") as f, open(FLAGSHIP, "rb") as g:
        assert f.read() == g.read()
