"""The port's data mesh (``parallel/mesh.py``, ``parallel/distributed.py``)
and batch-sharded serving through both cores, on the CPU, against the JAX
package on the 8 CPU devices ``tests/conftest.py`` spoofs.

The port's mesh repeats one device (``["cpu"] * 8``), which drives every
sharding branch: padding a ragged batch with its last tile, one shard a
mesh device, per-shard K6 / K5 (their plain versions here) and one pooled
rANS fetch head a shard.  Frames are byte-equal to the one-device port
core's and to the JAX core's on its mesh, decodes bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.coding.pixel_rans import \
    PixelRansTransport as JaxTransport
from cnn_autoencoder_tpu.models.factory import \
    autoencoder_from_state_dict as jax_from_state_dict
from cnn_autoencoder_tpu.parallel import mesh as jax_mesh
from cnn_autoencoder_tpu.parallel.distributed import \
    local_batch_slice as jax_local_batch_slice
from cnn_autoencoder_tpu.pipeline.tiles import \
    default_batch_tiles as jax_default_batch_tiles
from cnn_autoencoder_tpu.storage import cae_codec as jax_cae_codec
from cnn_autoencoder_tpu.storage.cae_codec import \
    CAECodecCore as JaxCodecCore
from cnn_autoencoder_tpu.storage.turbo_codec import \
    CAETurboCore as JaxTurboCore
from cnn_autoencoder_tpu_torch.coding.pixel_rans import PixelRansTransport
from cnn_autoencoder_tpu_torch.models.factory import (
    CAEModel, autoencoder_from_state_dict)
from cnn_autoencoder_tpu_torch.parallel import distributed
from cnn_autoencoder_tpu_torch.parallel.mesh import (batch_spec,
                                                     create_mesh,
                                                     data_devices,
                                                     infer_param_spec,
                                                     serving_mesh,
                                                     shard_batch,
                                                     shard_model)
from cnn_autoencoder_tpu_torch.pipeline.tiles import default_batch_tiles
from cnn_autoencoder_tpu_torch.storage.cae_codec import CAECodecCore
from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
from cnn_autoencoder_tpu_torch.utils.weights import state_to_jax

from tests.test_torch_turbo import (  # noqa: F401 (a fixture)
    _image, small_checkpoint)

CPU8 = ["cpu"] * 8


# -- mesh rules ---------------------------------------------------------------


@pytest.fixture(scope="module")
def models(small_checkpoint):
    """(JAX model, port model) of the JAX turbo tests' small checkpoint."""
    return (jax_from_state_dict(small_checkpoint),
            autoencoder_from_state_dict(small_checkpoint, device="cpu"))


@pytest.mark.parametrize("data", [None, 1, 4, 8])
def test_create_mesh_shapes_as_jax(data):
    got = create_mesh(data=data, devices=CPU8)
    want = jax_mesh.create_mesh(data=data)
    assert got.shape == dict(want.shape)
    assert len(got.devices) == want.devices.size
    assert all(d == torch.device("cpu") for d in got.devices)
    for ndim in (1, 2, 4):
        assert batch_spec(ndim) == tuple(jax_mesh.batch_spec(ndim))


def test_model_axis_raises(models):
    """The model axis runs at every way in: meshes of data x model, both
    cores given one (each data shard on the first device of its model
    group, frames as one device's), and ``shard_model``, which takes
    every architecture: a residual model is held as its slices too."""
    _, t_model = models
    for mesh in (create_mesh(data=4, model=2, devices=CPU8),
                 create_mesh(model=2, devices=CPU8)):
        assert mesh.shape == {"data": 4, "model": 2}
        assert len(mesh.devices) == 8 and len(data_devices(mesh)) == 4
    tiles = _tiles(32, 3)
    for make in (lambda **kw: CAECodecCore(t_model, **kw),
                 lambda **kw: CAETurboCore(t_model, num_streams=64, **kw)):
        core = make(mesh=mesh)
        assert len(core.shards) == 4
        assert core.encode_tiles(tiles) == make(device="cpu").encode_tiles(
            tiles)
    sharded = CAEModel(dict(t_model.config))
    shard_model(sharded, None, 1, 2)
    assert sharded.fact_ent.quantiles.shape[0] == \
        t_model.fact_ent.quantiles.shape[0] // 2
    model = CAEModel(dict(channels_org=3, channels_net=8, channels_bn=8,
                          compression_level=2, K=4, r=3,
                          act_layer_type="GDN", use_residual=True))
    full = {k: v.shape for k, v in model.state_dict().items()}
    shard_model(model, None, 0, 2)
    res = model.encoder.down_1.res_conv1
    assert res.weight.shape[0] == full["encoder.down_1.res_conv1.weight"][0] \
        // 2 and "weight" in res.model_shards
    assert model.decoder.up_0.gdn_res.gamma.shape[0] == 4
    assert model.encoder.down_0.res_conv1.weight.shape == \
        full["encoder.down_0.res_conv1.weight"]


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_infer_param_spec_matches_jax(models, model_size):
    """Every leaf of the small model's tree, carried across by
    ``utils/weights.py``, gets JAX's spec."""
    j_model, t_model = models
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: want.setdefault(
            tuple(str(p.key) for p in path),
            tuple(jax_mesh.infer_param_spec(path, leaf, model_size))),
        j_model.variables)
    got = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            got[path] = infer_param_spec(path, tree, model_size)

    walk(state_to_jax(t_model.state_dict(), t_model.config), ())
    assert got == want
    if model_size > 1:
        assert any(s for s in got.values())


class _MeshCore:
    def __init__(self, mesh):
        self.mesh = mesh


@pytest.mark.parametrize("data", [1, 2, 3, 8])
@pytest.mark.parametrize("patch,n_tiles", [(512, None), (512, 9),
                                           (256, 64), (64, None)])
def test_default_batch_tiles_matches_jax(monkeypatch, data, patch, n_tiles):
    monkeypatch.delenv("CAE_TPU_BATCH_TILES", raising=False)
    jcore = _MeshCore(jax_mesh.create_mesh(data=data))
    tcore = _MeshCore(create_mesh(data=data, devices=CPU8))
    assert default_batch_tiles(patch, tcore, n_tiles) == \
        jax_default_batch_tiles(patch, jcore, n_tiles)
    assert default_batch_tiles(patch, None, n_tiles) == \
        jax_default_batch_tiles(patch, None, n_tiles)


def test_single_process_identity(monkeypatch):
    """No coordinator: ``initialize_multihost`` forms nothing and returns
    False, as the JAX one does; one process is primary and feeds the whole
    batch; ``serving_mesh`` is None without several cards."""
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_multihost() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    assert distributed.local_batch_slice(8) == jax_local_batch_slice(8) \
        == slice(0, 8)
    assert serving_mesh() is None
    mesh = create_mesh(data=4, devices=CPU8)
    parts = shard_batch(mesh, np.arange(8 * 3).reshape(8, 3))
    assert [p.tolist() for p in parts] == \
        [np.arange(i * 6, i * 6 + 6).reshape(2, 3).tolist()
         for i in range(4)]
    with pytest.raises(ValueError, match="divide"):
        shard_batch(mesh, np.zeros((6, 3)))


# -- serving ------------------------------------------------------------------


def _tiles(side, n):
    return np.stack([_image(side, side, seed) for seed in range(n)])


@pytest.mark.parametrize("side", [32, 64])
def test_turbo_mesh_frames_match(models, side):
    """A ragged batch of 5 over 8 shards: frames byte-equal to the
    one-device core's and to the JAX core's on its 8-device mesh; decodes
    bit-equal; the JAX mesh core's frames decode in the port's mesh
    core."""
    j_model, t_model = models
    tiles = _tiles(side, 5)
    one = CAETurboCore(t_model, num_streams=64, device="cpu")
    eight = CAETurboCore(t_model, num_streams=64,
                         mesh=create_mesh(data=8, devices=CPU8))
    jcore = JaxTurboCore(j_model, num_streams=64,
                         mesh=jax_mesh.create_mesh(data=8))
    frames = eight.encode_tiles(tiles)
    assert frames == one.encode_tiles(tiles) == jcore.encode_tiles(tiles)
    assert eight.host_fallbacks == 0
    rec = eight.decode_tiles(frames)
    assert rec.shape == tiles.shape
    np.testing.assert_array_equal(rec, one.decode_tiles(frames))
    assert eight.per_shard_batch(5) == jcore.per_shard_batch(5) == 1


@pytest.mark.parametrize("side", [32, 64])
def test_cae_mesh_frames_match(models, side):
    """``CAECodecCore`` over 8 shards: a ragged 5 byte-equal to one
    device's; a full 8 byte-equal to the JAX core's on its mesh (which
    takes only batches that divide); decodes bit-equal."""
    j_model, t_model = models
    one = CAECodecCore(t_model, device="cpu")
    eight = CAECodecCore(t_model, mesh=create_mesh(data=8, devices=CPU8))
    ragged = _tiles(side, 5)
    frames = eight.encode_tiles(ragged)
    assert frames == one.encode_tiles(ragged)
    np.testing.assert_array_equal(eight.decode_tiles(frames),
                                  one.decode_tiles(frames))
    full = _tiles(side, 8)
    jcore = JaxCodecCore(j_model, mesh=jax_mesh.create_mesh(data=8))
    frames = eight.encode_tiles(full)
    assert frames == jcore.encode_tiles(full)
    np.testing.assert_array_equal(eight.decode_tiles(frames),
                                  one.decode_tiles(frames))
    # latents (a 'cae_bn' store's) and their decode, sharded
    np.testing.assert_array_equal(eight.latents(ragged).numpy(),
                                  one.latents(ragged).numpy())


def test_rans_fetch_heads_per_shard(models, monkeypatch):
    """The rANS fetch through the turbo mesh (128^2 tiles, where one coded
    tile a shard beats raw): one pooled head a shard, ``(8, head_words)``
    as the JAX mesh core's, decoding to the raw fetch's pixels."""
    SIDE = 128
    j_model, t_model = models
    tiles = _tiles(SIDE, 5)
    mesh = create_mesh(data=8, devices=CPU8)
    eight = CAETurboCore(t_model, num_streams=64, mesh=mesh)
    frames = eight.encode_tiles(tiles)
    raw = eight.decode_tiles(frames)
    tr = PixelRansTransport("cpu")
    tr.calibrate_from_tiles(raw)
    jtr = JaxTransport()
    jtr.calibrate_from_tiles(raw)
    assert tr.bits_per_value == jtr.bits_per_value
    # a coded tile beats raw at this side, one tile a shard
    assert tr.worthwhile_fetch(SIDE * SIDE * 3, eight.per_shard_batch(5))

    heads = []
    fetch = jax_cae_codec.CAECodecCore.fetch_pixels.__func__

    def recording(cls, rec_dev, shape=None, transport=None):
        if hasattr(rec_dev, "head"):
            heads.append(tuple(rec_dev.head.shape))
        return fetch(cls, rec_dev, shape, transport)

    monkeypatch.setattr(jax_cae_codec.CAECodecCore, "fetch_pixels",
                        classmethod(recording))
    jcore = JaxTurboCore(j_model, num_streams=64,
                         mesh=jax_mesh.create_mesh(data=8))
    np.testing.assert_array_equal(
        np.asarray(jcore.decode_tiles(frames, transport=jtr)), raw)

    sym = eight.symbols_from_frames(frames, 64, SIDE, SIDE)
    res = eight.base.decode_tiles_device(sym, transport=tr)
    assert tuple(res.head.shape) == heads[0]
    assert heads[0][0] == 8 and res.totals.shape[0] == 8
    np.testing.assert_array_equal(
        CAECodecCore.fetch_pixels(res, (8, SIDE, SIDE, 3), tr)[:5],
        raw)
    np.testing.assert_array_equal(eight.decode_tiles(frames, transport=tr),
                                  raw)
    assert tr.fallbacks == 0
    # packed fetch is off under a mesh: the raw pixels come back
    monkeypatch.setenv("CAE_TPU_PACKED_FETCH", "1")
    np.testing.assert_array_equal(eight.decode_tiles(frames), raw)


def test_mesh_kernels_launch_per_shard(models, monkeypatch):
    """Each shard runs its device work on its own rows: the wrappers'
    dispatchers see one call a shard (the plain versions here)."""
    from cnn_autoencoder_tpu_torch.coding import device_rans
    from cnn_autoencoder_tpu_torch.storage import turbo_codec
    _, t_model = models
    calls = {"encode": [], "decode": []}
    enc, dec = turbo_codec.encode_states, device_rans.decode_interleaved

    def encode_states(packed, *a, **k):
        calls["encode"].append(packed.shape[0])
        return enc(packed, *a, **k)

    def decode_interleaved(queues, *a, **k):
        calls["decode"].append(queues.shape[0])
        return dec(queues, *a, **k)

    monkeypatch.setattr(turbo_codec, "encode_states", encode_states)
    monkeypatch.setattr(turbo_codec, "decode_interleaved",
                        decode_interleaved)
    core = CAETurboCore(t_model, num_streams=64,
                        mesh=create_mesh(data=4, devices=CPU8))
    core.decode_tiles(core.encode_tiles(_tiles(32, 6)))
    assert calls == {"encode": [2] * 4, "decode": [2] * 4}


@pytest.mark.parametrize("env,want", [
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
      "PROCESS_ID": "2"}, ("tcp://10.0.0.1:1234", 4, 2)),
    ({"COORDINATOR_ADDRESS": "file:///tmp/rdzv", "NUM_PROCESSES": "2",
      "PROCESS_ID": "1"}, ("file:///tmp/rdzv", 2, 1)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "5", "WORLD_SIZE": "8",
      "RANK": "3", "LOCAL_RANK": "3"}, ("env://", 8, 3)),
    ({"COORDINATOR_ADDRESS": "h:5", "NUM_PROCESSES": "2"}, ValueError)])
def test_initialize_multihost_reads_both_conventions(monkeypatch, env, want):
    """The JAX package's variables and torchrun's name the group; gloo on
    the CPU; an incomplete start raises instead of running alone."""
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    if want is ValueError:
        with pytest.raises(ValueError, match="process's id"):
            distributed.initialize_multihost(device="cpu")
        return
    assert distributed.initialize_multihost(device="cpu") is True
    method, n, rank = want
    assert calls == [("gloo", dict(init_method=method, world_size=n,
                                   rank=rank))]
    assert distributed.backend_for("cuda:0") == "nccl"
    assert distributed.backend_for("cuda:0", shared=True) == "gloo"


@pytest.mark.parametrize("transports", [False, True])
def test_pipeline_over_mesh(models, tmp_path, monkeypatch, transports):
    """The slide pipeline through both cores over a 4-shard mesh: stores
    byte-equal to the one-device cores' and pixels equal, untransported
    and with the coded upload and the rANS fetch forced (the packer stays
    off under the mesh)."""
    from cnn_autoencoder_tpu_torch.pipeline import tiles
    from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER
    _, t_model = models
    for var in ("CAE_TPU_CODED_UPLOAD", "CAE_TPU_PACKED_FETCH",
                "CAE_TPU_FETCH_CODEC", "CAE_TPU_BATCH_TILES"):
        monkeypatch.delenv(var, raising=False)
    if transports:
        monkeypatch.setenv("CAE_TPU_CODED_UPLOAD", "1")
        monkeypatch.setenv("CAE_TPU_PACKED_FETCH", "1")
    img = np.concatenate([_image(128, 384, 1), _image(128, 384, 2)])
    mesh = create_mesh(data=4, devices=CPU8[:4])
    runs = {}
    for name, turbo, cae in (
            ("one", CAETurboCore(t_model, num_streams=64, device="cpu"),
             CAECodecCore(t_model, device="cpu")),
            ("mesh", CAETurboCore(t_model, num_streams=64, mesh=mesh),
             CAECodecCore(t_model, mesh=mesh))):
        GLOBAL_TIMER.reset()
        arr = tiles.compress_pixels_to_cae_turbo(
            turbo, img, str(tmp_path / f"{name}_tpu.zarr"), patch_size=128)
        arr2 = tiles.compress_pixels_to_cae(
            cae, img, str(tmp_path / f"{name}_cae.zarr"), patch_size=128)
        runs[name] = ({ij: arr.read_chunk_raw(ij) for ij in arr.chunk_ids()},
                      {ij: arr2.read_chunk_raw(ij)
                       for ij in arr2.chunk_ids()},
                      tiles.decompress_cae_turbo_array(arr, core=turbo),
                      tiles.decompress_cae_array(arr2, core=cae))
        if transports:
            # both directions went coded: the host coder's stages ran
            stages = GLOBAL_TIMER.totals()
            assert {"compress/host_rans_px", "decompress/host_rans_px"} \
                <= set(stages), sorted(stages)
    one, mesh_run = runs["one"], runs["mesh"]
    assert mesh_run[0] == one[0] and mesh_run[1] == one[1]
    np.testing.assert_array_equal(mesh_run[2], one[2])
    np.testing.assert_array_equal(mesh_run[3], one[3])
