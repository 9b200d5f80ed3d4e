"""The port's data layer (``data/``) against the JAX package's, with the
global ``np.random`` seeded the same before each package's draws: the
loader's order and ``random_split``, every transform and transform factory,
the MNIST (idx.gz), EMNIST, CIFAR-10/100 (pickle) and ImageNet (folder)
readers, the zarr grid and blue-noise samplers, ``ZarrDataset`` and
``LabeledZarrDataset``, and ``get_data`` for each dataset name."""

import os
import pickle

import numpy as np
import pytest

from cnn_autoencoder_tpu.data import augs as jaugs
from cnn_autoencoder_tpu.data import datautils as jdu
from cnn_autoencoder_tpu.data import loader as jloader
from cnn_autoencoder_tpu.data import zarr_dataset as jzd
from cnn_autoencoder_tpu_torch.data import augs as taugs
from cnn_autoencoder_tpu_torch.data import datautils as tdu
from cnn_autoencoder_tpu_torch.data import loader as tloader
from cnn_autoencoder_tpu_torch.data import zarr_dataset as tzd
from cnn_autoencoder_tpu_torch.storage import zarr as tzarr

from tests.test_cli import _make_synthetic_mnist
from tests.test_data_layer import _make_labeled_zarr, _write_idx_gz


def _same(a, b):
    """Equal nested tuples/lists of arrays (None where the other is)."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _seeded(fn, seed=7):
    np.random.seed(seed)
    return fn()


def _both(make, seed=7):
    """``make(module set)`` for the JAX and the port's modules, each after
    the same ``np.random.seed``."""
    return (_seeded(lambda: make(jaugs, jloader, jzd, jdu), seed),
            _seeded(lambda: make(taugs, tloader, tzd, tdu), seed))


def _batches(loader):
    return [(x, t) for x, t in loader]


def test_loader_order_and_split():
    xs = (np.random.RandomState(0).rand(23, 6, 5, 3) * 255).astype(np.uint8)
    ts = np.arange(23)

    def make(a, lo, *_):
        ds = lo.ArrayDataset(xs, ts, transform=a.Compose(
            [a.ToFloat(), a.AddGaussianNoise(0, 0.01), a.RandomCrop(4)]))
        tr, va = lo.random_split(ds, [17, 6], seed=3)
        return (list(tr.indices), list(va.indices),
                _batches(lo.DataLoader(tr, 4, shuffle=True, seed=5)),
                _batches(lo.DataLoader(va, 4, drop_last=True, prefetch=0)),
                len(lo.DataLoader(tr, 4)), len(lo.DataLoader(va, 4,
                                                             drop_last=True)))
    j, t = _both(make)
    assert j[0] == t[0] and j[1] == t[1] and j[4:] == t[4:]
    _same(j[2], t[2])
    _same(j[3], t[3])


def _inputs():
    rng = np.random.RandomState(1)
    x = rng.rand(24, 20, 3).astype(np.float32)
    u8 = (rng.rand(24, 20, 3) * 255).astype(np.uint8)
    tgt = np.zeros((24, 20, 1), np.float32)
    tgt[3:9, 2:8] = 1
    tgt[14:20, 11:17] = 1
    onehot = (rng.rand(6, 5, 3) > 0.5).astype(np.float32)
    return x, u8, tgt, onehot


TRANSFORMS = {
    "to_float": lambda a, x, u8, tg, oh: a.ToFloat()(u8),
    "normalize": lambda a, x, u8, tg, oh: a.Normalize(0.4, 0.2)(x),
    "pad": lambda a, x, u8, tg, oh: a.Pad(3)(x),
    "noise": lambda a, x, u8, tg, oh: a.AddGaussianNoise(0.01, 0.1)(x),
    "random_crop": lambda a, x, u8, tg, oh: [a.RandomCrop(9)(x),
                                             a.RandomCrop(30)(x)],
    "center_crop": lambda a, x, u8, tg, oh: [a.CenterCrop(9)(x),
                                             a.CenterCrop(30)(x)],
    "elastic": lambda a, x, u8, tg, oh:
        a.RandomElasticDeformationInput(4)(x),
    "elastic_pair": lambda a, x, u8, tg, oh:
        a.RandomElasticDeformationInputTarget(4)((x, tg)),
    "rotation": lambda a, x, u8, tg, oh: a.RandomRotationInput(30.0)(x),
    "rotation_pair": lambda a, x, u8, tg, oh:
        a.RandomRotationInputTarget(90.0)((x, tg)),
    "weights": lambda a, x, u8, tg, oh: [
        a.WeightsDistances([1.0, 2.0], sigma=3, w_0=5)(tg),
        a.WeightsDistances([1.0, 3.0], sigma=2, w_0=4)(tg[..., 0] * 0)],
    "map_merge": lambda a, x, u8, tg, oh: [
        a.MapLabels()(oh), a.MergeLabels("max")(oh),
        a.MergeLabels("mean")(oh), a.MergeLabels("median")(oh)],
    "astype": lambda a, x, u8, tg, oh: a.AsType(np.int64)(x * 9),
    "mnist": lambda a, x, u8, tg, oh: [
        a.get_mnist_transform("training", n)(u8[..., :1])
        for n in (True, False)],
    "cifar": lambda a, x, u8, tg, oh: [
        a.get_cifar_transform("test", n)(u8) for n in (True, False)],
    "imagenet": lambda a, x, u8, tg, oh: [
        a.get_imagenet_transform(m, n, 16)(u8)
        for m in ("training", "test", "val") for n in (True, False)],
    "zarr": lambda a, x, u8, tg, oh: [
        [f(u8) if f is not None and i == 0 else
         (f((u8, tg)) if f is not None and i == 1 else
          (f(tg) if f is not None else None))
         for i, f in enumerate(a.get_zarr_transform(**kw))]
        for kw in (dict(data_mode="training", patch_size=16),
                   dict(data_mode="test", patch_size=16, normalize=True,
                        add_noise=True, rotation=True,
                        elastic_deformation=True),
                   dict(data_mode="training", patch_size=16, rotation=True,
                        elastic_deformation=True, label_density=2,
                        merge_labels="max", target_data_type=np.int64),
                   dict(data_mode="all", map_labels=True,
                        class_weights=[1.0, 2.0], weight_map_sigma=3,
                        weight_map_w_0=5))],
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    ins = _inputs()
    j, t = _both(lambda a, *_: TRANSFORMS[name](a, *ins))
    _same(j, t)


def _cifar(root, name, batches, labels_key):
    root.mkdir()
    rng = np.random.RandomState(0)
    for fn in batches:
        n = 20 if fn != "test_batch" and fn != "test" else 10
        with open(root / fn, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 255, (n, 3072), np.uint8),
                         labels_key: list(rng.randint(0, 10, n))}, f)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{dataset name: data dir} of small synthetic sets in each format."""
    from PIL import Image
    root = tmp_path_factory.mktemp("datasets")
    _make_synthetic_mnist(str(root / "mnist"), n=40)
    raw = root / "emnist" / "EMNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (24, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 62, (24,)).astype(np.uint8)
    for kind, i, lb in (("train", imgs, labels), ("t10k", imgs[:8],
                                                  labels[:8])):
        _write_idx_gz(str(raw / f"{kind}-images-idx3-ubyte.gz"), i)
        _write_idx_gz(str(raw / f"{kind}-labels-idx1-ubyte.gz"), lb)
    (root / "cifar10").mkdir()
    _cifar(root / "cifar10" / "cifar-10-batches-py", "cifar10",
           [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"],
           b"labels")
    (root / "cifar100").mkdir()
    _cifar(root / "cifar100" / "cifar-100-python", "cifar100",
           ["train", "test"], b"fine_labels")
    for c in range(2):
        d = root / "imagenet" / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(13):
            Image.fromarray(rng.randint(0, 256, (20 + i, 18, 3)).astype(
                np.uint8)).save(str(d / f"img_{i}.png"))
    wsis = root / "zarr"
    wsis.mkdir()
    for name in ("train_0", "train_1", "val_0"):
        _make_labeled_zarr(str(wsis / f"{name}.zarr"))
    return {"MNIST": str(root / "mnist"), "EMNIST": str(root / "emnist"),
            "CIFAR10": str(root / "cifar10"),
            "CIFAR100": str(root / "cifar100"),
            "ImageNet": str(root / "imagenet"), "Zarr": str(wsis)}


GET_DATA = {
    "MNIST": {}, "EMNIST": {}, "CIFAR10": {}, "CIFAR100": {},
    "ImageNet": dict(patch_size=16),
    "Zarr": dict(patch_size=32, data_group="0/0", data_axes="YXC"),
    "Zarr-blue-noise": dict(patch_size=32, data_group="0/0",
                            data_axes="YXC", patch_sample_mode="blue-noise",
                            sampling_radius=20),
    "Zarr-labeled": dict(patch_size=32, data_group="0/0", data_axes="YXC",
                         patch_sample_mode="grid", label_density=2,
                         labels_data_group="labels/0/0",
                         labels_data_axes="YXC", criterion="RateMSECE",
                         mask_group="masks/0/0", mask_data_axes="YX",
                         shuffle_val=False, rotation=True),
}


@pytest.mark.parametrize("name", sorted(GET_DATA))
@pytest.mark.parametrize("mode", ["training", "test"])
def test_get_data_matches_jax(datasets, name, mode):
    """Every batch of every queue ``get_data`` returns, in order."""
    dataset = name.split("-")[0]
    args = dict(dataset=dataset, data_dir=[datasets[dataset]], batch_size=4,
                val_batch_size=3, mode=mode, seed=2, **GET_DATA[name])
    if mode == "test" and dataset == "Zarr":
        args["data_mode"] = "val"

    def make(*mods):
        du = mods[3]
        kw = {} if du is jdu else {"device": "cpu"}
        out = du.get_data(dict(args), **kw)
        return [_batches(q) for q in out[:-1]] + [out[-1]]
    j, t = _both(make)
    assert t[-1] == j[-1]
    assert sum(len(q) for q in t[:-1]) > 0
    _same(j[:-1], t[:-1])


def test_get_data_refuses_an_unknown_dataset():
    with pytest.raises(ValueError, match="not available"):
        tdu.get_data({"dataset": "SVHN"})


def test_samplers_and_zarr_datasets_match_jax(tmp_path):
    """Grid and blue-noise positions, ``ZarrDataset`` with and without a
    mask and shuffled, ``LabeledZarrDataset``, worker shards and
    ``IterableLoader`` batches: equal patches in equal order."""
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"f{i}.zarr"))
        _make_labeled_zarr(paths[-1], 96 + 32 * i, 96)
    for h, w in ((128, 96), (300, 250), (20, 20)):
        assert jzd.GridPatchSampler(32).positions(h, w) == \
            tzd.GridPatchSampler(32).positions(h, w)
        for kw in (dict(sampling_radius=24), dict(max_points=5)):
            assert jzd.BlueNoisePatchSampler(32, **kw).positions(
                h, w, np.random.RandomState(4)) == \
                tzd.BlueNoisePatchSampler(32, **kw).positions(
                    h, w, np.random.RandomState(4))

    common = dict(patch_size=32, data_group="0/0", data_axes="YXC")
    cases = [
        ("ZarrDataset", dict(common)),
        ("ZarrDataset", dict(common, shuffle=True, seed=3)),
        ("ZarrDataset", dict(common, mask_group="masks/0/0",
                             mask_data_axes="YX", dataset_size=4)),
        ("LabeledZarrDataset", dict(common, labels_data_group="labels/0/0",
                                    labels_data_axes="YXC", shuffle=True)),
    ]
    for cls, kw in cases:
        def make(a, lo, zd, du):
            extra = {"device": "cpu"} if zd is tzd else {}
            sampler = zd.BlueNoisePatchSampler(32, sampling_radius=30)
            out = []
            for sampled in (None, sampler):
                ds = getattr(zd, cls)(paths, patch_sampler=sampled,
                                      transform=a.Compose([a.ToFloat()]),
                                      **kw, **extra)
                out += [list(ds), len(ds), list(ds.shard(1, 2)),
                        _batches(zd.IterableLoader(ds, 3))]
            return out
        j, t = _both(make)
        assert [j[1], j[5]] == [t[1], t[5]]
        _same([j[0], j[2], j[3], j[4], j[6], j[7]],
              [t[0], t[2], t[3], t[4], t[6], t[7]])


def test_zarr_image_reads_every_axes_order(tmp_path):
    """``ZarrImage`` on a TCZYX store: shape and patches (padded past the
    edge) equal to the JAX package's."""
    rng = np.random.RandomState(0)
    arr5 = (rng.rand(1, 3, 1, 40, 50) * 255).astype(np.uint8)
    path = str(tmp_path / "t.zarr")
    a = tzarr.Group.create(path).create_dataset(
        "0/0", shape=arr5.shape, chunks=(1, 3, 1, 16, 16), dtype=np.uint8,
        compressor=None)
    a[...] = arr5
    j = jzd.ZarrImage(path, "0/0", "TCZYX")
    t = tzd.ZarrImage(path, "0/0", "TCZYX", device="cpu")
    assert t.shape_yxc == j.shape_yxc == (40, 50, 3)
    for y, x in ((0, 0), (24, 40), (30, 10)):
        _same(j.read_patch(y, x, 16), t.read_patch(y, x, 16))
    assert os.path.isdir(path)
