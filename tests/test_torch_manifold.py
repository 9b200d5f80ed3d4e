"""The port's manifold embeddings (``utils/manifold.py``, torch in float64)
against the JAX package's numpy ones on the same seeded points, on the CPU:
pairwise distances and the perplexity search's P within 1e-10, one t-SNE
step's gradient within 1e-10 and its float32 embedding within 1e-6
relative, runs of 10 to 30 iterations within 1e-6 of the embedding's scale
(t-SNE's gains flip on the sign of each gradient element, so rounding in
the last bits grows about a billionfold over 50 iterations and longer runs
part, as two numpy builds would), the clusters
separated as ``tests/test_manifold.py`` requires, and Isomap equal up to
each column's sign, with distance ties too."""

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.utils import manifold as J
from cnn_autoencoder_tpu_torch.utils import manifold as P


def _clusters(seed, n_per=40, dim=10, sep=6.0, k=3):
    rng = np.random.RandomState(seed)
    centers = rng.normal(size=(k, dim)) * sep
    pts = np.concatenate([c + rng.normal(size=(n_per, dim))
                          for c in centers])
    return pts, np.repeat(np.arange(k), n_per)


def _cpu(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _up_to_sign(got, want):
    """``got`` with each column's sign turned to agree with ``want``'s."""
    s = np.sign(np.sum(got * want, axis=0))
    s[s == 0] = 1
    return got * s


@pytest.mark.parametrize("seed,perplexity", [(0, 30.0), (1, 12.0),
                                             (2, 5.0)])
def test_perplexity_probabilities_match_jax(seed, perplexity):
    x, _ = _clusters(seed)
    d_j = J._pairwise_sq_dists(x)
    d_p = P._pairwise_sq_dists(_cpu(x))
    np.testing.assert_allclose(d_p.numpy(), d_j, rtol=1e-10, atol=1e-10)
    p_j = J._perplexity_probabilities(d_j, perplexity)
    p_p = P._perplexity_probabilities(_cpu(d_j), perplexity).numpy()
    np.testing.assert_allclose(p_p, p_j, rtol=0, atol=1e-10)
    assert np.all(np.diag(p_p) == 0.0)
    np.testing.assert_allclose(p_p.sum(axis=1), 1.0, atol=1e-8)


def test_perplexity_rows_freeze_where_jax_breaks():
    """Rows that converge at different steps each keep the P of their own
    last step: a tight tolerance leaves some rows at ``max_iter``."""
    x, _ = _clusters(3, n_per=30)
    d = J._pairwise_sq_dists(x)
    for tol, max_iter in ((1e-5, 50), (1e-12, 8)):
        np.testing.assert_allclose(
            P._perplexity_probabilities(_cpu(d), 20.0, tol, max_iter).numpy(),
            J._perplexity_probabilities(d, 20.0, tol, max_iter),
            rtol=0, atol=1e-10)


def test_tsne_gradient_step_matches_jax():
    """The KL gradient of one step (the JAX loop's lines, written out) and
    the embedding after one step."""
    x, _ = _clusters(4)
    n = len(x)
    p = J._perplexity_probabilities(J._pairwise_sq_dists(x), 30.0)
    p = np.maximum((p + p.T) / (2.0 * n), 1e-12) * 12.0
    y = np.random.RandomState(5).randn(n, 2)
    num = 1.0 / (1.0 + J._pairwise_sq_dists(y))
    np.fill_diagonal(num, 0.0)
    q = np.maximum(num / num.sum(), 1e-12)
    pq = (p - q) * num
    grad_j = 4.0 * ((np.diag(pq.sum(axis=1)) - pq) @ y)
    grad_p = P._tsne_grad(_cpu(p), _cpu(y)).numpy()
    np.testing.assert_allclose(grad_p, grad_j, rtol=1e-10,
                               atol=1e-10 * np.abs(grad_j).max())
    one_j = J.tsne(x, n_iter=1, seed=2)
    one_p = P.tsne(x, n_iter=1, seed=2, device="cpu")
    assert one_p.dtype == torch.float32
    np.testing.assert_allclose(one_p.numpy(), one_j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tsne_short_run_matches_jax(seed):
    x, _ = _clusters(seed)
    y_j = J.tsne(x, n_iter=30, seed=seed)
    y_p = P.tsne(x, n_iter=30, seed=seed, device="cpu").numpy()
    np.testing.assert_allclose(y_p, y_j, rtol=0,
                               atol=1e-6 * np.abs(y_j).max())


def test_tsne_init_passthrough_matches_jax():
    x, _ = _clusters(6, n_per=15, k=2)
    init = np.random.RandomState(7).normal(size=(len(x), 2)) * 1e-4
    y_j = J.tsne(x, n_iter=10, init=init)
    y_p = P.tsne(x, n_iter=10, init=init, device="cpu").numpy()
    np.testing.assert_allclose(y_p, y_j, rtol=0,
                               atol=1e-6 * np.abs(y_j).max())
    assert not np.allclose(y_p, P.tsne(x, n_iter=10,
                                       device="cpu").numpy())


def test_tsne_separates_clusters_and_is_deterministic():
    """``tests/test_manifold.py``'s requirement, on the port."""
    x, labels = _clusters(1, n_per=20, sep=25.0)
    y1 = P.tsne(x, n_iter=300, seed=3, device="cpu").numpy()
    y2 = P.tsne(x, n_iter=300, seed=3, device="cpu").numpy()
    np.testing.assert_array_equal(y1, y2)
    assert y1.shape == (x.shape[0], 2) and y1.dtype == np.float32
    d = np.sqrt(J._pairwise_sq_dists(y1.astype(np.float64)))
    same = labels[:, None] == labels[None, :]
    off_diag = ~np.eye(len(labels), dtype=bool)
    assert d[~same].mean() > 3.0 * d[same & off_diag].mean()


ISOMAP_CASES = {
    "clusters_k5": (lambda: _clusters(8)[0], 2, 5),
    "plane_full_graph": (
        lambda: np.random.RandomState(3).normal(size=(30, 2)), 2, 29),
    "curve_1d": (lambda: np.linspace(0.0, 1.0, 40)[:, None]
                 @ np.random.RandomState(4).normal(size=(1, 6)), 1, 3),
    "islands": (lambda: np.concatenate([
        np.random.RandomState(5).normal(size=(12, 4)),
        np.random.RandomState(6).normal(size=(12, 4)) + 1000.0]), 2, 3),
}


@pytest.mark.parametrize("case", sorted(ISOMAP_CASES))
def test_isomap_matches_jax_up_to_sign(case):
    make, comps, k = ISOMAP_CASES[case]
    x = make()
    y_j = J.isomap(x, n_components=comps, n_neighbors=k)
    y_p = P.isomap(x, n_components=comps, n_neighbors=k, device="cpu")
    assert y_p.dtype == torch.float32 and tuple(y_p.shape) == y_j.shape
    y_p = _up_to_sign(y_p.numpy(), y_j)
    assert np.all(np.isfinite(y_p))
    np.testing.assert_allclose(y_p, y_j, rtol=0,
                               atol=1e-5 * np.abs(y_j).max())


def test_isomap_with_duplicate_points():
    """Distance ties: a point and its duplicate both sit at distance 0, and
    numpy's unstable sort and the port's stable one put either first, so
    the neighbour lists differ in some rows; the zero-length edge joins the
    two either way, and the embeddings still agree up to sign."""
    rng = np.random.RandomState(200)
    x = rng.randn(200, 6)
    x[150:] = x[:50]
    d = np.sqrt(J._pairwise_sq_dists(x))
    knn_j = np.sort(np.argsort(d, axis=1)[:, 1:6], axis=1)
    knn_p = np.sort(torch.argsort(_cpu(d), dim=1, stable=True)[:, 1:6]
                    .numpy(), axis=1)
    assert (knn_j != knn_p).any(axis=1).sum() > 0
    y_j = J.isomap(x, n_neighbors=5)
    y_p = _up_to_sign(P.isomap(x, n_neighbors=5, device="cpu").numpy(), y_j)
    np.testing.assert_allclose(y_p, y_j, rtol=0,
                               atol=1e-5 * np.abs(y_j).max())


def test_numpy_inputs_go_to_the_card_by_default():
    """``device=None`` is the card: without one a numpy input raises, and
    a CPU tensor stays on the CPU."""
    x, _ = _clusters(9, n_per=5, k=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.tsne(x, n_iter=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.isomap(x)
    assert P.isomap(_cpu(x), n_neighbors=3).device.type == "cpu"
