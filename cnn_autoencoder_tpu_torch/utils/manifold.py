"""Exact t-SNE and Isomap in float64 on the device: the port of the JAX
package's ``utils/manifold.py:1-117`` (numpy there).

The dense arithmetic (pairwise distances, the perplexity search, the t-SNE
iterations, Isomap's classical MDS) runs in torch on the tensors' device;
Isomap's geodesics stay scipy's Dijkstra on the host (``shortest_path``
over the sparse kNN graph), as in the JAX package.  Inputs may be numpy
arrays or tensors: numpy inputs go to ``device`` (``None``: the card, which
raises without one), tensors stay on their own device unless ``device``
names another.  The embeddings come back as float32 tensors on that
device.

Where the two packages can part:

* the perplexity search runs every row at once, and a row stops at the
  first step its entropy is within ``tol`` of ``log(perplexity)``, so each
  row takes the JAX loop's beta steps; sums run in another order, so a row
  whose entropy sits at ``tol`` after some step may stop one step apart;
* each row's conditional P leaves out the row's own point (its diagonal is
  dropped, not zeroed, before the exponentials), as ``np.delete`` does;
* Isomap's neighbours are ``argsort(d)[:, 1:k + 1]`` with a stable sort:
  numpy's sort is not stable, so with duplicate points (distance ties) the
  two packages may pick other neighbours and other embeddings;
* ``eigh``'s eigenvectors (and the SVD's in ``tools/visualize_groups.py``)
  have no fixed sign, so an embedding's columns agree up to sign.
"""

import numpy as np
import torch

from .device import resolve_device


def as_float64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor: numpy inputs on ``device`` (None: the
    card), tensors on their own device unless ``device`` names another."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None
                    else resolve_device(device), dtype=torch.float64)
    return torch.from_numpy(np.asarray(x, np.float64)).to(
        resolve_device(device))


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d.clamp_(min=0.0)
    d.fill_diagonal_(0.0)
    return d


def _perplexity_probabilities(dists: torch.Tensor, perplexity: float,
                              tol: float = 1e-5, max_iter: int = 50
                              ) -> torch.Tensor:
    """Per-row conditional P with binary-searched bandwidths, all rows at
    once; a row is frozen at the step where the JAX loop would break."""
    n = dists.shape[0]
    dev = dists.device
    target = float(np.log(perplexity))
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    di = dists[off].reshape(n, n - 1)
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    lo = torch.full_like(beta, -np.inf)
    hi = torch.full_like(beta, np.inf)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    pi_out = torch.zeros_like(di)
    for _ in range(max_iter):
        expd = torch.exp(-di * beta[:, None])
        s = expd.sum(dim=1)
        positive = s > 0
        pi = torch.where(positive[:, None], expd / s[:, None],
                         torch.zeros_like(expd))
        h = torch.where(positive, beta * (di * pi).sum(dim=1) + torch.log(s),
                        torch.zeros_like(s))
        pi_out = torch.where(active[:, None], pi, pi_out)
        diff = h - target
        active = active & ~(torch.abs(diff) < tol)
        up = active & (diff > 0)
        down = active & ~(diff > 0)
        new_lo = torch.where(up, beta, lo)
        new_hi = torch.where(down, beta, hi)
        beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(down, torch.where(torch.isinf(lo), beta / 2.0,
                                          (beta + lo) / 2.0), beta))
        lo, hi = new_lo, new_hi
        if not bool(active.any()):
            break
    p = torch.zeros((n, n), dtype=torch.float64, device=dev)
    p[off] = pi_out.reshape(-1)
    return p


def tsne(x, n_components: int = 2, perplexity: float = 30.0,
         learning_rate: float = 200.0, n_iter: int = 500,
         early_exaggeration: float = 12.0, seed: int = 0,
         init=None, device=None) -> torch.Tensor:
    """Exact t-SNE (Kullback-Leibler gradient descent with gains and
    momentum); the random start is numpy's ``RandomState(seed)``, so both
    packages start from the same points."""
    x = as_float64(x, device)
    dev = x.device
    n = x.shape[0]
    perplexity = min(perplexity, max(2.0, (n - 1) / 3.0))
    p = _perplexity_probabilities(_pairwise_sq_dists(x), perplexity)
    p = (p + p.T) / (2.0 * n)
    p.clamp_(min=1e-12)

    rng = np.random.RandomState(seed)
    y = (as_float64(init, dev) if init is not None else torch.from_numpy(
        rng.randn(n, n_components) * 1e-4).to(dev))
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    exag_until = min(250, n_iter // 2)
    p_run = p * early_exaggeration
    for it in range(n_iter):
        if it == exag_until:
            p_run = p
        grad = _tsne_grad(p_run, y)
        momentum = 0.5 if it < exag_until else 0.8
        sign_agree = torch.sign(grad) == torch.sign(update)
        gains = torch.where(sign_agree, gains * 0.8, gains + 0.2)
        gains.clamp_(min=0.01)
        update = momentum * update - learning_rate * gains * grad
        y = y + update
        y = y - y.mean(dim=0, keepdim=True)
    return y.float()


def _tsne_grad(p_run: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One step's KL gradient: ``4 (diag(rowsum(pq)) - pq) y``."""
    num = 1.0 / (1.0 + _pairwise_sq_dists(y))
    num.fill_diagonal_(0.0)
    q = torch.clamp(num / num.sum(), min=1e-12)
    pq = (p_run - q) * num
    lap = -pq
    lap.diagonal().add_(pq.sum(dim=1))
    return 4.0 * (lap @ y)


def isomap(x, n_components: int = 2, n_neighbors: int = 5,
           device=None) -> torch.Tensor:
    """Isomap: kNN graph -> geodesic distances (scipy's Dijkstra on the
    host) -> classical MDS on the device."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    x = as_float64(x, device)
    dev = x.device
    n = x.shape[0]
    d = torch.sqrt(_pairwise_sq_dists(x))
    knn_idx = torch.argsort(d, dim=1, stable=True)[:, 1:n_neighbors + 1]
    rows = torch.arange(n, device=dev).repeat_interleave(n_neighbors)
    cols = knn_idx.reshape(-1)
    weights = d[rows, cols]
    graph = csr_matrix((weights.cpu().numpy(), (rows.cpu().numpy(),
                                                 cols.cpu().numpy())),
                       shape=(n, n))
    geo = torch.from_numpy(shortest_path(graph, method="D",
                                         directed=False)).to(dev)

    # disconnected components: bridge with the max finite geodesic so MDS
    # stays defined (sklearn errors here; a visualization should not)
    finite = torch.isfinite(geo)
    finite_max = geo[finite].max()
    geo = torch.where(finite, geo, finite_max * 1.5)

    g2 = geo ** 2
    j = (torch.eye(n, dtype=torch.float64, device=dev)
         - torch.ones((n, n), dtype=torch.float64, device=dev) / n)
    b = (-0.5 * j) @ g2 @ j
    w, v = torch.linalg.eigh((b + b.T) / 2.0)
    order = torch.argsort(w, descending=True, stable=True)[:n_components]
    lam = torch.clamp(w[order], min=0.0)
    return (v[:, order] * torch.sqrt(lam)[None, :]).float()
