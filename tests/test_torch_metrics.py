"""The port's metrics (``utils/metrics.py``) and color conversions
(``ops/color.py``) against the JAX package's on ``tests/test_metrics.py``'s
cases and on seeded arrays: color and image metrics within 1e-10 relative
(float64 on both sides; SSIM's window means by ``avg_pool2d`` against
``sliding_window_view``), class metrics exactly."""

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.ops import color as jcolor
from cnn_autoencoder_tpu.utils import metrics as J
from cnn_autoencoder_tpu_torch.ops import color as pcolor
from cnn_autoencoder_tpu_torch.utils import metrics as P


def _images(seed, h=40, w=37, dtype=np.float64):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (h, w, 3))
    y = np.clip(x + rng.randn(h, w, 3) * 9, 0, 255)
    return x.astype(dtype), y.astype(dtype)


@pytest.mark.parametrize("name,rgb", [
    ("white", [[[255, 255, 255]]]), ("black", [[[0, 0, 0]]]),
    ("gray", [[[128, 128, 128]]]), ("red", [[[255, 0, 0]]]),
    ("seeded_u8", None), ("seeded_unit_float", None),
    ("seeded_255_float", None)])
def test_color_matches_jax(name, rgb):
    rng = np.random.RandomState(1)
    if name == "seeded_u8":
        rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    elif name == "seeded_unit_float":
        rgb = rng.rand(9, 11, 3)
    elif name == "seeded_255_float":
        rgb = rng.rand(9, 11, 3) * 255
    else:
        rgb = np.asarray(rgb, np.uint8)
    for fn in ("rgb2xyz", "rgb2lab"):
        ref = getattr(jcolor, fn)(rgb)
        got = getattr(pcolor, fn)(rgb)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                                   atol=1e-10, err_msg=fn)
    lab2 = jcolor.rgb2lab(np.clip(np.asarray(rgb, np.float64) * 0.9, 0,
                                  None))
    np.testing.assert_allclose(
        pcolor.deltaE_cie76(pcolor.rgb2lab(rgb), lab2).numpy(),
        jcolor.deltaE_cie76(jcolor.rgb2lab(rgb), lab2), rtol=1e-10,
        atol=1e-10)


def test_reference_points_and_delta_e():
    """``tests/test_metrics.py``'s closed forms hold for the port."""
    lab = pcolor.rgb2lab(np.asarray([[[255, 0, 0]]], np.uint8))[0, 0]
    np.testing.assert_allclose(lab.numpy(), [53.24, 80.09, 67.20], atol=0.1)
    d = pcolor.deltaE_cie76(np.asarray([[[50.0, 10.0, -10.0]]]),
                            np.asarray([[[52.0, 13.0, -4.0]]]))
    np.testing.assert_allclose(float(d[0, 0]), np.sqrt(4 + 9 + 36))


IMAGE_CASES = [
    ("compute_rmse", {}), ("compute_psnr", {}),
    ("mean_squared_error", {}), ("compute_delta_cielab", {}),
    ("structural_similarity", {}),
    ("structural_similarity", {"data_range": 255}),
    ("structural_similarity", {"win_size": 5}),
]


@pytest.mark.parametrize("name,kwargs", IMAGE_CASES,
                         ids=[f"{n}{k}" for n, k in IMAGE_CASES])
@pytest.mark.parametrize("kind", ["seeded", "unit", "identity", "gray2d"])
def test_image_metrics_match_jax(name, kwargs, kind):
    x, y = _images(2)
    if kind == "unit":
        x, y = x / 255.0, y / 255.0
    elif kind == "identity":
        y = x.copy()
    elif kind == "gray2d":
        if name == "compute_delta_cielab":
            return _skip_free_gray_delta_e()
        x, y = x[..., 0], y[..., 0]
    ref = getattr(J, name)(x, y, **kwargs)
    got = getattr(P, name)(torch.from_numpy(x), torch.from_numpy(y),
                           **kwargs)
    if np.isinf(ref):
        assert np.isinf(got)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14)
    # numpy inputs give the same value
    assert getattr(P, name)(x, y, **kwargs) == got


def _skip_free_gray_delta_e():
    # delta-E needs three channels: the gray case holds it on a gray image
    x, y = _images(4)
    x[..., 1:] = x[..., :1]
    y[..., 1:] = y[..., :1]
    np.testing.assert_allclose(P.compute_delta_cielab(x, y),
                               J.compute_delta_cielab(x, y), rtol=1e-10)


def test_ssim_closed_forms():
    yy, xx = np.mgrid[0:32, 0:32]
    x = ((np.sin(yy / 5.0) + np.cos(xx / 7.0)) * 60 + 128)[:, :, None] \
        * np.ones((1, 1, 3))
    assert P.structural_similarity(x, x) == pytest.approx(1.0)
    noisy = x + np.random.RandomState(0).randn(32, 32, 3) * 30
    assert 0 < P.structural_similarity(x, noisy, data_range=255) < 0.9


def _class_cases():
    rng = np.random.RandomState(7)
    target = rng.randint(0, 5, 60)
    logits = rng.randn(60, 5) * 2
    seg_t = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float64)
    seg_p = seg_t * 3 - 1.5 + rng.randn(2, 8, 8, 1)
    two = np.concatenate([rng.rand(2, 8, 8, 1), seg_t], -1)
    return {
        "multiclass": (logits, target, dict(top_k=3, num_classes=5)),
        "jax_test_multiclass": (
            np.asarray([[5.0, 1, 1], [1, 5, 1], [1, 5, 1], [1, 5, 1]]),
            np.asarray([0, 1, 2, 1]), dict(top_k=2, num_classes=3)),
        "binary_seg": (seg_p, seg_t, dict(num_classes=1,
                                          seg_threshold=0.5)),
        "binary_seg_weighted_target": (seg_p, two, dict(num_classes=1,
                                                        seg_threshold=0.6)),
        "dense_multiclass": (rng.randn(2, 4, 4, 3),
                             rng.randint(0, 3, (2, 4, 4)),
                             dict(top_k=2, num_classes=3)),
    }


@pytest.mark.parametrize("case", sorted(_class_cases()))
def test_class_metrics_per_image_equal_jax(case):
    pred, target, kwargs = _class_cases()[case]
    assert P.compute_metrics_per_image(pred, target, **kwargs) == \
        J.compute_metrics_per_image(pred, target, **kwargs)


@pytest.mark.parametrize("drop", [True, False])
def test_roc_auc_ap_equal_jax(drop):
    rng = np.random.RandomState(11)
    target = rng.rand(300) > 0.6
    scores = np.round(target * 0.3 + rng.rand(300), 2)  # ties included
    for got, ref in zip(P.roc_curve(target, scores, drop),
                        J.roc_curve(target, scores, drop)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert P.roc_auc_score(target, scores) == J.roc_auc_score(target, scores)
    got, ref = (P.compute_roc_curve(scores, target),
                J.compute_roc_curve(scores, target))
    assert got[3] == ref[3]
    onehot = np.eye(4)[rng.randint(0, 4, 50)]
    s = rng.rand(50, 4)
    assert P.average_precision_score(onehot, s) == \
        J.average_precision_score(onehot, s)
    assert np.isnan(P.average_precision_score(np.zeros((3, 4)), s[:3]))
    assert P.compute_roc_curve(np.asarray([0.1, 0.4, 0.35, 0.8]),
                               np.asarray([0, 0, 1, 1]))[3] == \
        pytest.approx(0.75)


@pytest.mark.parametrize("num_classes", [5, 1])
def test_streaming_equal_jax(num_classes):
    rng = np.random.RandomState(1)
    if num_classes > 1:
        target = rng.randint(0, 5, 200)
        pred = target.copy()
        flip = rng.rand(200) < 0.3
        pred[flip] = (pred[flip] + 1) % 5
        top = [np.stack([pred, (pred + 1) % 5], -1)[:100],
               np.stack([pred, (pred + 1) % 5], -1)[100:]]
    else:
        target = (rng.rand(200) > 0.5).astype(np.float64)
        pred = (rng.rand(200) > 0.4).astype(np.int64)
        top = None
    chunks = [(pred[:100], target[:100]), (pred[100:], target[100:])]
    assert P.compute_class_metrics_streaming(chunks, num_classes, top) == \
        J.compute_class_metrics_streaming(chunks, num_classes, top)
    assert P.precision_recall_f1(target, pred, binary=num_classes == 1) == \
        J.precision_recall_f1(target, pred, binary=num_classes == 1)
    assert P.accuracy_score(target, pred) == J.accuracy_score(target, pred)
