"""The port's compress / decompress CLIs against the JAX package's: the
same argparse actions flag by flag; ``compress(args, device="cpu")`` then
``decompress`` for CAETPU and CAE (with the halo, and the bottleneck
store) on PNG and zarr inputs, with chunks byte-identical to the JAX CLI's
stores and reconstructions within the u8 tolerance; the three error cases
of ``tests/test_cli.py``; and the CLI entry point refusing to run without
a card."""

import os
import subprocess
import sys

import numpy as np
import pytest

from cnn_autoencoder_tpu.cli.compress import compress as jax_compress
from cnn_autoencoder_tpu.cli.decompress import decompress as jax_decompress
from cnn_autoencoder_tpu.storage import zarr as jzarr
from cnn_autoencoder_tpu.utils.args import get_args as jax_get_args
from cnn_autoencoder_tpu_torch.cli.compress import compress
from cnn_autoencoder_tpu_torch.cli.decompress import decompress
from cnn_autoencoder_tpu_torch.storage import zarr as tzarr
from cnn_autoencoder_tpu_torch.utils.args import (get_args,
                                                  parse_typed_arguments)
from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger

from tests.test_torch_turbo import (  # noqa: F401 (a fixture)
    _assert_u8_close, _image, small_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(parser):
    """Every action's contract: flags, dest, default, type, nargs, choices,
    const and kind (the help of -g/--gpu says what the port does with it)."""
    out = {}
    for a in parser._actions:
        out[tuple(a.option_strings)] = (
            a.dest, a.default, a.type, a.nargs, a.choices, a.const,
            type(a).__name__, a.required,
            None if "--gpu" in a.option_strings else a.help)
    return out


@pytest.mark.parametrize("task,mode", [("encoder", "inference"),
                                       ("decoder", "inference"),
                                       ("autoencoder", "training"),
                                       ("autoencoder", "test")])
def test_parser_actions_equal_jax(task, mode):
    ours = _actions(get_args(task, mode, parser_only=True))
    theirs = _actions(jax_get_args(task, mode, parser_only=True))
    assert sorted(ours) == sorted(theirs)
    for flags in theirs:
        assert ours[flags] == theirs[flags], flags
    args = get_args(task, mode, args_list=["-rs", "7", "-g"])
    ref = jax_get_args(task, mode, args_list=["-rs", "7", "-g"])
    assert vars(args) == vars(ref)
    assert args.gpu is True and args.version == "0.5.7"


def test_config_file_and_typed_arguments(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"patch_size": 64, "codec": "CAETPU"}')
    args = get_args("encoder", "inference",
                    args_list=["-c", str(cfg), "-ps", "256", "-rs", "1"])
    assert args.patch_size == 256 and args.codec == "CAETPU"
    with pytest.raises(ValueError, match="json"):
        get_args("encoder", "inference", args_list=["-c", "cfg.yaml"])
    assert parse_typed_arguments(["encoder=float:1e-4", "fact_ent=int:2",
                                  "decoder=str:Adam", "cls=none:x"]) == {
        "encoder": 1e-4, "fact_ent": 2, "decoder": "Adam", "cls": None}


def _png_dir(path, img, name="sample.png"):
    from PIL import Image
    path.mkdir(exist_ok=True)
    Image.fromarray(img).save(str(path / name))
    return path


def _zarr_input(path, img):
    g = tzarr.Group.create(str(path))
    a = g.create_dataset("0/0", shape=img.shape, chunks=(32, 32, 3),
                         dtype=np.uint8, compressor=None)
    a[...] = img
    os.makedirs(str(path / "OME"))
    (path / "OME" / "METADATA.ome.xml").write_text("<OME/>")
    return path


def _chunks(path, group="0/0"):
    base = os.path.join(path, group)
    out = {}
    for fn in sorted(os.listdir(base)):
        with open(os.path.join(base, fn), "rb") as f:
            out[fn] = f.read()
    return out


def _both(tmp_path, monkeypatch, argv):
    """Run the port's and the JAX package's compress on the same flags, the
    output directory (or store) under ``port`` and ``jax``."""
    monkeypatch.setenv("CAE_TPU_SERVE_MESH", "0")
    outs = {}
    for pkg, run, parse in (("port", compress, get_args),
                            ("jax", jax_compress, jax_get_args)):
        out = tmp_path / pkg
        out.mkdir()
        args = parse("encoder", "inference", args_list=argv + [
            "-o", str(out), "-ld", str(tmp_path)])
        if pkg == "port":
            run(args, device="cpu")
        else:
            run(args)
        outs[pkg] = out
    return outs


@pytest.mark.parametrize("codec,extra,source", [
    ("CAETPU", [], "png"), ("CAE", [], "png"), ("CAE", ["-off"], "zarr"),
    ("CAETPU", [], "zarr")])
def test_cli_round_trip_matches_jax(tmp_path, monkeypatch, small_checkpoint,
                                    codec, extra, source):
    img = _image(96, 80, seed=11)
    if source == "png":
        src, name = _png_dir(tmp_path / "in", img), "sample"
    else:
        (tmp_path / "in").mkdir()
        src, name = tmp_path / "in", "slide"
        _zarr_input(src / "slide.zarr", img)
    outs = _both(tmp_path, monkeypatch, [
        "-dd", str(src), "-if", source, "-cod", codec, "-chk",
        small_checkpoint, "-ps", "32", "-da", "YXC", "-dg", "0/0"] + extra)
    stores = {pkg: str(out / f"{name}.zarr") for pkg, out in outs.items()}
    assert _chunks(stores["port"]) == _chunks(stores["jax"])
    meta = tzarr.open(stores["port"], device="cpu")["0/0"]._meta
    assert meta == jzarr.open(stores["jax"])["0/0"]._meta
    assert meta["compressor"]["id"] == {"CAE": "cae",
                                        "CAETPU": "cae_tpu"}[codec]
    if source == "zarr":
        assert os.path.exists(os.path.join(stores["port"], "OME",
                                           "METADATA.ome.xml"))

    # decompress the port's store with both packages, to zarr and to PNG
    recs = {}
    for pkg, run, parse in (("port", decompress, get_args),
                            ("jax", jax_decompress, jax_get_args)):
        for fmt in ("zarr", "png"):
            rec_dir = tmp_path / f"rec_{pkg}_{fmt}"
            rec_dir.mkdir()
            dargs = parse("decoder", "inference", args_list=[
                "-dd", str(outs["port"]), "-o", str(rec_dir), "-of", fmt,
                "-dg", "0/0", "-ld", str(tmp_path)])
            if pkg == "port":
                run(dargs, device="cpu")
            else:
                run(dargs)
            if fmt == "zarr":
                z = tzarr.open(str(rec_dir / f"{name}.zarr"))
                recs[pkg, fmt] = z["decompressed/0/0"][...]
            else:
                from PIL import Image
                recs[pkg, fmt] = np.asarray(
                    Image.open(str(rec_dir / f"{name}.png")))
    assert recs["port", "zarr"].shape == img.shape
    np.testing.assert_array_equal(recs["port", "zarr"], recs["port", "png"])
    _assert_u8_close(recs["port", "zarr"], recs["jax", "zarr"])
    _assert_u8_close(recs["port", "png"], recs["jax", "png"])


def test_cli_bottleneck_and_pyramid(tmp_path, monkeypatch, small_checkpoint):
    """-sbn stores the latents as the JAX CLI stores them; decompress with
    the checkpoint (and -off: the latent halo) decodes them, and
    --store-pyramids adds the halved levels."""
    img = _image(64, 64, seed=12)
    src = _png_dir(tmp_path / "in", img, "x.png")
    outs = _both(tmp_path, monkeypatch, [
        "-dd", str(src), "-if", "png", "-cod", "CAE", "-chk",
        small_checkpoint, "-ps", "32", "-sbn"])
    lat = {pkg: tzarr.open(str(out / "x.zarr"), device="cpu")["0/0"]
           for pkg, out in outs.items()}
    assert lat["port"].shape == (16, 16, 16)
    assert lat["port"]._meta == lat["jax"]._meta
    assert np.mean(lat["port"][...] != lat["jax"][...]) < 1e-3

    rec_dir = tmp_path / "rec"
    rec_dir.mkdir()
    dargs = get_args("decoder", "inference", args_list=[
        "-dd", str(outs["port"]), "-o", str(rec_dir), "-of", "zarr",
        "-dg", "0/0", "-chk", small_checkpoint, "-off", "-pyr",
        "-ld", str(tmp_path)])
    decompress(dargs, device="cpu")
    out = tzarr.open(str(rec_dir / "x.zarr"))
    rec = out["decompressed/0/0"][...]
    assert rec.shape == (64, 64, 3) and rec.dtype == np.uint8
    assert out["decompressed/0/1"].shape == (32, 32, 3)
    assert out["decompressed/0/4"].shape == (4, 4, 3)


def test_single_zarr_output_with_multiple_inputs_errors(tmp_path):
    img_dir = tmp_path / "in"
    rng = np.random.RandomState(0)
    for name in ("a.png", "b.png"):
        _png_dir(img_dir, (rng.rand(16, 16, 3) * 255).astype(np.uint8), name)
    args = get_args("encoder", "inference", args_list=[
        "-dd", str(img_dir), "-o", str(tmp_path / "only_one.zarr"),
        "-if", "png", "-cod", "Blosc", "-ps", "8", "-da", "YXC",
        "-ld", str(tmp_path)])
    with pytest.raises(ValueError, match="inputs but only"):
        compress(args, device="cpu")


def test_decompress_with_checkpoint_rejects_pixel_store(tmp_path,
                                                        small_checkpoint):
    rng = np.random.RandomState(2)
    img = np.clip(rng.rand(64, 48, 3) * 255, 0, 255).astype(np.uint8)
    img_dir = _png_dir(tmp_path / "in", img, "p.png")
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    compress(get_args("encoder", "inference", args_list=[
        "-dd", str(img_dir), "-o", str(out_dir), "-if", "png",
        "-cod", "CAE", "-chk", small_checkpoint, "-ps", "32",
        "-da", "YXC", "-ld", str(tmp_path)]), device="cpu")
    rec_dir = tmp_path / "rec"
    rec_dir.mkdir()
    dargs = get_args("decoder", "inference", args_list=[
        "-dd", str(out_dir), "-o", str(rec_dir), "-of", "zarr",
        "-dg", "0/0", "-chk", small_checkpoint, "-ld", str(tmp_path)])
    with pytest.raises(ValueError, match="self-decoding"):
        decompress(dargs, device="cpu")


def test_decompress_latent_store_without_checkpoint_errors(
        tmp_path, small_checkpoint):
    rng = np.random.RandomState(3)
    img = np.clip(rng.rand(64, 64, 3) * 255, 0, 255).astype(np.uint8)
    img_dir = _png_dir(tmp_path / "in", img, "q.png")
    out_dir = tmp_path / "bn_out"
    out_dir.mkdir()
    compress(get_args("encoder", "inference", args_list=[
        "-dd", str(img_dir), "-o", str(out_dir), "-if", "png",
        "-cod", "CAE", "-chk", small_checkpoint, "-ps", "32", "-sbn",
        "-ld", str(tmp_path)]), device="cpu")
    rec_dir = tmp_path / "rec"
    rec_dir.mkdir()
    for fmt in ("png", "zarr"):
        dargs = get_args("decoder", "inference", args_list=[
            "-dd", str(out_dir), "-o", str(rec_dir), "-of", fmt,
            "-dg", "0/0", "-ld", str(tmp_path)])
        with pytest.raises(ValueError, match="LATENTS"):
            decompress(dargs, device="cpu")


@pytest.mark.parametrize("codec", ["Blosc", "None"])
def test_general_codecs_match_jax(tmp_path, monkeypatch, codec):
    img = _image(40, 56, seed=13)
    src = _png_dir(tmp_path / "in", img)
    outs = _both(tmp_path, monkeypatch, [
        "-dd", str(src), "-if", "png", "-cod", codec, "-ps", "16",
        "-da", "YXC"])
    stores = {pkg: str(out / "sample.zarr") for pkg, out in outs.items()}
    assert _chunks(stores["port"]) == _chunks(stores["jax"])
    np.testing.assert_array_equal(tzarr.open(stores["jax"])["0/0"][...], img)


def test_logger_writes_the_jax_file(tmp_path):
    args = get_args("encoder", "inference",
                    args_list=["-rs", "5", "-li", "x", "-ld", str(tmp_path)])
    logger = setup_logger(args)
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    with open(str(tmp_path / "inference_ver0.5.7_5x.log")) as f:
        lines = f.read().splitlines()
    assert lines[-1] == "hello" and lines[0].startswith("Logging to ")


def test_cli_needs_the_card(tmp_path):
    """``python -m ...cli.compress`` runs on the card: without one it exits
    non-zero, naming the missing device, and writes no store."""
    img_dir = _png_dir(tmp_path / "in", _image(32, 32, seed=1))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "cnn_autoencoder_tpu_torch.cli.compress",
         "-dd", str(img_dir), "-o", str(tmp_path / "out"), "-if", "png",
         "-cod", "CAETPU", "-chk", os.path.join(ROOT, "benchmarks",
                                                "bench_flagship.msgpack"),
         "-ld", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(str(tmp_path / "out"))
