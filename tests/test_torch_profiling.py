"""``utils/profiling.py``'s stages on the profiler's clock, and the stages
the turbo codec core (the flagship checkpoint) and the train step record
(plain versions, on the CPU): under ``torch.profiler`` a stage is a host
range of its name that encloses the operations run in it; without one it
opens no range and still counts; one ``encode_tiles``, ``decode_tiles`` or
train step records each of its stages once a call (the upload once a shard
under a mesh)."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
from cnn_autoencoder_tpu_torch.models.factory import (
    autoencoder_from_state_dict, build_model)
from cnn_autoencoder_tpu_torch.parallel.mesh import create_mesh
from cnn_autoencoder_tpu_torch.storage import turbo_codec
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.training.loop import make_train_step
from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
from cnn_autoencoder_tpu_torch.utils import profiling
from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER

FLAGSHIP = "benchmarks/bench_flagship.msgpack"
ENCODE = ["compress/upload", "compress/analysis", "compress/rans_states",
          "compress/fetch_words", "compress/frame"]
DECODE = ["decompress/parse", "decompress/upload_words",
          "decompress/symbols", "decompress/synthesis",
          "decompress/d2h_pixels"]
TRAIN = ["train/forward", "train/loss", "train/backward", "train/optimizer"]


def _host_events(prof):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events()]


def test_stage_is_a_profiler_range_enclosing_its_ops():
    GLOBAL_TIMER.reset()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with GLOBAL_TIMER.stage("compress/frame"):
            torch.add(x, 1)
    events = _host_events(prof)
    (stage,) = [e for e in events if e[0] == "compress/frame"]
    adds = [e for e in events if e[0] == "aten::add"]
    assert adds and all(stage[1] <= a[1] and a[2] <= stage[2]
                        and a[3] == stage[3] for a in adds)
    assert GLOBAL_TIMER._count == {"compress/frame": 1}


def test_stage_opens_no_range_without_a_profiler(monkeypatch):
    opened = []

    def counting_range(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(profiling, "profiler_range", counting_range)
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("train/optimizer", 2.0):
            pass
    assert opened == []
    assert timer._count == {"train/optimizer": 3}
    assert timer.totals()["train/optimizer"] >= 0.0
    assert timer._units["train/optimizer"] == 6.0
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage("train/optimizer"):
            pass
    assert opened == ["train/optimizer"]
    assert timer._count == {"train/optimizer": 4}


@pytest.fixture(scope="module")
def model():
    return autoencoder_from_state_dict(FLAGSHIP, device="cpu")


@pytest.fixture(scope="module")
def core(model):
    return CAETurboCore(model, num_streams=64, device="cpu")


def _tiles(n=3, side=32):
    """``n`` smooth noisy uint8 tiles."""
    yy, xx = np.mgrid[0:side, 0:side]
    img = (np.sin(yy / 9.0) + np.cos(xx / 11.0))[None, :, :, None] * 55 + 128
    img = img + np.random.RandomState(3).randn(n, side, side, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def test_turbo_core_records_each_stage_once_a_call(core):
    tiles = _tiles()
    GLOBAL_TIMER.reset()
    frames = core.encode_tiles(tiles)
    assert {k: GLOBAL_TIMER._count[k] for k in ENCODE} == dict.fromkeys(
        ENCODE, 1)
    assert set(GLOBAL_TIMER._count) == set(ENCODE)
    GLOBAL_TIMER.reset()
    rec = core.decode_tiles(frames)
    assert rec.shape == tiles.shape
    assert GLOBAL_TIMER._count == dict.fromkeys(DECODE, 1)


def test_host_fallback_is_its_own_stage(core, monkeypatch):
    """No capacity tried: the host coder writes the batch."""
    monkeypatch.setattr(turbo_codec, "CAPACITY_TRIES", 0)
    tiles = _tiles()
    GLOBAL_TIMER.reset()
    frames = core.encode_tiles(tiles)
    assert not any(turbo_codec.is_turbo_frame(f) for f in frames)
    assert GLOBAL_TIMER._count == dict(
        dict.fromkeys(ENCODE[:-1], 1), **{"compress/host_fallback": 1})


def test_turbo_core_stages_under_the_profiler(core):
    """Each stage a host range of its name, the call's stages in order and
    inside the caller's range."""
    tiles = _tiles()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("call.encode"):
            frames = core.encode_tiles(tiles)
        with torch.profiler.record_function("call.decode"):
            core.decode_tiles(frames)
    events = _host_events(prof)
    for call, names in (("call.encode", ENCODE), ("call.decode", DECODE)):
        (outer,) = [e for e in events if e[0] == call]
        spans = [e for e in events if e[0] in names]
        assert [e[0] for e in sorted(spans, key=lambda e: e[1])] == names
        assert all(outer[1] <= e[1] and e[2] <= outer[2] for e in spans)


def test_upload_is_a_stage_a_shard_under_a_mesh(model, core):
    """Two shards: each uploads and analyses its own tiles, the frames as
    one device's."""
    mesh = CAETurboCore(model, num_streams=64,
                        mesh=create_mesh(data=2, devices=["cpu"] * 2))
    tiles = _tiles()
    frames = core.encode_tiles(tiles)
    GLOBAL_TIMER.reset()
    assert mesh.encode_tiles(tiles) == frames
    assert GLOBAL_TIMER._count == dict(
        dict.fromkeys(ENCODE, 1), **{"compress/upload": 2,
                                     "compress/analysis": 2})


def test_train_step_records_its_four_stages_once():
    config = dict(channels_org=3, channels_net=8, channels_bn=4,
                  compression_level=2, K=4, r=3, act_layer_type="GDN")
    model = build_model(config, torch.Generator().manual_seed(0),
                        device="cpu")
    trainable = ["encoder", "decoder", "fact_ent"]
    opts = setup_optimizers(model, trainable)
    step = make_train_step(model, setup_loss("RateMSE",
                                             distortion_lambda=0.01),
                           opts, trainable_modules=trainable)
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    GLOBAL_TIMER.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats, _ = step(x, dict.fromkeys(opts, 1e-4), 1,
                        generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(stats["loss"])
    assert GLOBAL_TIMER._count == dict.fromkeys(TRAIN, 1)
    spans = sorted((e for e in _host_events(prof) if e[0] in TRAIN),
                   key=lambda e: e[1])
    assert [e[0] for e in spans] == TRAIN
