"""Latent-space visualization: feature mosaics, 2-D embeddings, selection;
the port of the JAX package's ``scripts/visualize_groups.py``.

    python -m cnn_autoencoder_tpu_torch.tools.visualize_groups \
        -i a.zarr b.zarr -o out_dir [-e all] [--select X0 Y0 X1 Y1]

Loads latent arrays from zarr files, shows a per-channel feature mosaic,
projects latent vectors to 2-D with PCA, t-SNE and Isomap
(``utils/manifold.py``), and maps selected embedding points back to their
spatial locations, either interactively (click-drag a rectangle) or
headlessly through ``--select``.  Non-interactive by default: writes PNGs
into the output directory.

``pca_2d``, ``feature_mosaic``, ``select_in_rect`` and
``compute_embeddings`` run in torch on ``device`` (None: the card) and
return tensors there; each file's sample of points is numpy's
``RandomState(0).choice``, as in the JAX script, so both packages embed the
same points.  PCA runs in float64 and returns the input's float type.
matplotlib is imported inside ``main`` (the plots), so the functions run
where it is not installed.
"""

import argparse
import os
import time

import numpy as np
import torch

from ..storage import zarr as zarrlib
from ..utils.device import resolve_device
from ..utils.manifold import as_float64, isomap, tsne


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: numpy inputs on ``device`` (None: the card),
    tensors where they are."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device))


def pca_2d(x, device=None) -> torch.Tensor:
    """Project rows of x to their top-2 principal components."""
    x = _tensor(x, device)
    dtype = x.dtype if x.is_floating_point() else torch.float64
    x = as_float64(x)
    x = x - x.mean(dim=0, keepdim=True)
    _, _, vt = torch.linalg.svd(x, full_matrices=False)
    return (x @ vt[:2].T).to(dtype)


def feature_mosaic(latent, cols: int = 8, device=None) -> torch.Tensor:
    """(h, w, C) latent -> tiled per-channel grayscale mosaic."""
    latent = _tensor(latent, device)
    h, w, c = latent.shape
    rows = -(-c // cols)
    flat = latent.reshape(h * w, c)
    lo, hi = flat.min(dim=0).values, flat.max(dim=0).values
    scaled = ((latent - lo) / (hi - lo + 1e-8)).float()
    mosaic = torch.zeros((rows * cols, h, w), dtype=torch.float32,
                         device=latent.device)
    mosaic[:c] = scaled.permute(2, 0, 1)
    return mosaic.reshape(rows, cols, h, w).permute(0, 2, 1, 3).reshape(
        rows * h, cols * w)


def select_in_rect(emb, rect, device=None) -> torch.Tensor:
    """Indices of embedding points inside (x0, y0, x1, y1)."""
    emb = _tensor(emb, device)
    x0, y0, x1, y1 = rect
    (x0, x1), (y0, y1) = sorted((x0, x1)), sorted((y0, y1))
    return torch.where((emb[:, 0] >= x0) & (emb[:, 0] <= x1)
                       & (emb[:, 1] >= y0) & (emb[:, 1] <= y1))[0]


def compute_embeddings(vectors, kinds, tsne_iters: int = 500, device=None,
                       times=None):
    """{kind: (n, 2) embedding}; t-SNE is PCA-initialized for stability.
    ``times``, a dict, receives each embedding's seconds (the device
    synchronized at its end)."""
    vectors = _tensor(vectors, device)

    def timed(kind, fn):
        t0 = time.perf_counter()
        out = fn()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        if times is not None:
            times[kind] = time.perf_counter() - t0
        return out

    out = {}
    pca = timed("pca", lambda: pca_2d(vectors))
    if "pca" in kinds:
        out["pca"] = pca
    if "tsne" in kinds:
        init = pca * 1e-4 / max(float(pca.std(correction=0)), 1e-12)
        out["tsne"] = timed("tsne", lambda: tsne(vectors, n_iter=tsne_iters,
                                                  init=init))
    if "isomap" in kinds:
        out["isomap"] = timed("isomap", lambda: isomap(vectors,
                                                       n_neighbors=5))
    return out


def sample_vectors(latent, max_points):
    """(sampled (n, C) vectors, their flat indices) of one (h, w, C)
    latent: numpy's ``RandomState(0).choice`` without replacement."""
    vecs = latent.reshape(-1, latent.shape[-1])
    sel = np.random.RandomState(0).choice(
        len(vecs), size=min(max_points, len(vecs)), replace=False)
    return vecs[sel], sel


def main(argv=None, device=None):
    parser = argparse.ArgumentParser("Visualize latent feature groups")
    parser.add_argument("-i", "--input", dest="inputs", type=str, nargs="+",
                        help="zarr files containing latent arrays")
    parser.add_argument("-dg", "--data-group", dest="data_group", type=str,
                        default="0/0")
    parser.add_argument("-o", "--out-dir", dest="out_dir", type=str,
                        default=".")
    parser.add_argument("-e", "--embedding", dest="embedding", type=str,
                        default="all", choices=["pca", "tsne", "isomap",
                                                "all"])
    parser.add_argument("--tsne-iters", type=int, default=500)
    parser.add_argument("--max-points", type=int, default=2000)
    parser.add_argument("--select", type=float, nargs=4, default=None,
                        metavar=("X0", "Y0", "X1", "Y1"),
                        help="embedding-space rectangle: map the selected "
                             "points back to their spatial positions")
    parser.add_argument("--interactive", action="store_true",
                        help="click-drag selection in a GUI window")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    import matplotlib
    if not args.interactive:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out_dir, exist_ok=True)
    all_vectors = []
    labels = []
    positions = []   # (file index, y, x) per sampled vector
    shapes = []
    for fi, fn in enumerate(args.inputs):
        node = zarrlib.open(fn, mode="r", device=dev)
        latent = (node[args.data_group] if isinstance(node, zarrlib.Group)
                  else node)[...]
        while latent.ndim > 3:
            latent = latent[0]

        base = os.path.basename(fn).split(".zarr")[0]
        plt.figure(figsize=(12, 8))
        plt.imshow(feature_mosaic(latent, device=dev).cpu().numpy(),
                   cmap="viridis")
        plt.axis("off")
        plt.title(f"{base} latent channels")
        plt.savefig(os.path.join(args.out_dir, f"{base}_mosaic.png"),
                    dpi=120, bbox_inches="tight")
        plt.close()

        h, w, _ = latent.shape
        vecs, sel = sample_vectors(latent, args.max_points)
        all_vectors.append(vecs)
        labels.extend([base] * len(sel))
        positions.append(np.stack([np.full(len(sel), fi),
                                   sel // w, sel % w], axis=1))
        shapes.append((h, w))
        print("Wrote mosaic for", fn)

    if not all_vectors:
        return

    vectors = np.concatenate(all_vectors)
    positions = np.concatenate(positions)
    labels = np.asarray(labels)
    kinds = (["pca", "tsne", "isomap"] if args.embedding == "all"
             else [args.embedding])
    on_device = compute_embeddings(vectors, kinds, args.tsne_iters,
                                   device=dev)
    embeddings = {k: v.cpu().numpy() for k, v in on_device.items()}

    uniq = sorted(set(labels.tolist()))
    for kind, emb in embeddings.items():
        plt.figure(figsize=(8, 8))
        for u in uniq:
            pts = emb[labels == u]
            plt.scatter(pts[:, 0], pts[:, 1], s=2, alpha=0.4, label=u)
        plt.legend(markerscale=4)
        plt.title(f"Embedded space ({kind.upper()})")
        out_png = os.path.join(args.out_dir, f"latent_{kind}.png")
        plt.savefig(out_png, dpi=120, bbox_inches="tight")
        plt.close()
        print("Wrote", out_png)

    sel_dev = on_device.get("tsne", next(iter(on_device.values())))
    sel_emb = sel_dev.cpu().numpy()

    def write_selection(idx, tag="selected"):
        """Selected embedding points -> spatial overlay per input file."""
        for fi, fn in enumerate(args.inputs):
            mine = idx[positions[idx, 0] == fi]
            if not len(mine):
                continue
            base = os.path.basename(fn).split(".zarr")[0]
            h, w = shapes[fi]
            plt.figure(figsize=(8, 8))
            plt.xlim(0, w)
            plt.ylim(h, 0)
            plt.scatter(positions[mine, 2], positions[mine, 1], s=2,
                        c="black", marker="x")
            plt.title(f"{base}: spatial positions of {len(mine)} "
                      f"{tag} points")
            out_png = os.path.join(args.out_dir,
                                   f"{base}_{tag}_positions.png")
            plt.savefig(out_png, dpi=120, bbox_inches="tight")
            plt.close()
            print("Wrote", out_png)

    if args.select is not None:
        write_selection(select_in_rect(sel_dev, args.select).cpu().numpy())

    if args.interactive:
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.scatter(sel_emb[:, 0], sel_emb[:, 1], s=2, c="tab:blue",
                   alpha=0.4)
        state = {"press": None}

        def on_press(event):
            state["press"] = (event.xdata, event.ydata)

        def on_release(event):
            if state["press"] is None or event.xdata is None:
                return
            x0, y0 = state["press"]
            idx = select_in_rect(sel_dev, (x0, y0, event.xdata,
                                           event.ydata)).cpu().numpy()
            if len(idx):
                write_selection(idx, tag="clicked")
            state["press"] = None

        fig.canvas.mpl_connect("button_press_event", on_press)
        fig.canvas.mpl_connect("button_release_event", on_release)
        plt.show()


if __name__ == "__main__":
    main()
