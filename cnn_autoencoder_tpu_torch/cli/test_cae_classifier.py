"""Classifier and segmenter evaluation harness: the port of the JAX
package's ``cli/test_cae_classifier.py``.

    python -m cnn_autoencoder_tpu_torch.cli.test_cae_classifier -ds Zarr \
        -dd test.zarr -dg 0/0 -da YXC -chk checkpoint.msgpack -ps 256 \
        -bs 16 -ncl 1 -ccm -ld logs

Runs the model (its ``class_model`` or ``seg_model``) over the test queue
on the card in the port's compute mode, stores inputs, targets, scores,
classes and top-k classes into a zarr tree ``output{id}.zarr`` (groups
``input/``, ``target/``, ``scores/``, ``class/``, ``topk/``; NHWC, as the
JAX harness writes it, not the reference's NCHW), optionally crops each
connected component of a dense target (``-ccm``, ``scipy.ndimage.label``),
then computes the out-of-core metrics at the image level (and the object
level) from the stored tree, with the ROC arrays of a binary task under
``image_level/`` (``object_level/``).  ``infer`` and ``test`` take
``device`` (None: the card).
"""

import logging
import os

import numpy as np
import torch

from ..data.datautils import get_data
from ..models.tasks import make_forward_fn
from ..ops.convops import get_default_precision
from ..storage import zarr as zarrlib
from ..storage.codecs import Blosc
from ..utils import loggers
from ..utils.args import get_args
from ..utils.device import resolve_device
from ..utils.metrics import (_softmax, compute_class_metrics_streaming,
                             compute_metrics_per_image, compute_roc_curve)
from .train_cae import COMPUTE_DTYPES, setup_network


def _save_array(z_grp, name, data, chunks=None):
    compressor = Blosc(cname="zlib", clevel=9, shuffle=2)
    data = np.asarray(data)
    z_grp.create_dataset(name, shape=data.shape,
                         chunks=chunks or data.shape, dtype=data.dtype,
                         compressor=compressor, overwrite=True)[...] = data


def save_pred2zarr(save_filename, im_id, x, target, pred, seg_threshold,
                   batch_size, patch_size, num_classes,
                   compute_components_metrics, top_k=5, save_input=False):
    """Store one batch of predictions, NHWC (JAX
    ``cli/test_cae_classifier.py:45``)."""
    top_k = min(top_k, num_classes)
    dense = pred.ndim == 4

    if dense:
        if target.ndim == 4 and target.shape[-1] > 1 and num_classes == 1:
            target = target[..., 1:]
    else:
        target = np.asarray(target).reshape(-1, 1)
        pred = np.asarray(pred).reshape(-1, num_classes)

    if num_classes > 1:
        pred_scores = _softmax(pred, axis=-1)
        pred_class = np.argmax(pred, axis=-1)[..., None]
        pred_class_top = np.argsort(pred, axis=-1)[..., -top_k:]
    else:
        pred_scores = 1.0 / (1.0 + np.exp(-pred))
        pred_class = (pred_scores > seg_threshold)
        pred_class_top = None

    z_grp = zarrlib.Group.create(save_filename)
    if save_input:
        _save_array(z_grp, "input/%i/0" % im_id,
                    np.clip(np.asarray(x) * 255, 0, 255).astype(np.uint8))
    _save_array(z_grp, "target/%i/0" % im_id, np.asarray(target))
    _save_array(z_grp, "scores/%i/0" % im_id,
                pred_scores.astype(np.float32))
    _save_array(z_grp, "class/%i/0" % im_id, pred_class.astype(np.uint8))
    if pred_class_top is not None:
        _save_array(z_grp, "topk/%i/0" % im_id,
                    pred_class_top.astype(np.int32))

    if compute_components_metrics and dense:
        from scipy import ndimage
        t2d = np.asarray(target)[..., 0] if target.ndim == 4 else target
        labels, n_objs = ndimage.label(t2d, structure=np.ones((3,) * t2d.ndim))
        h, w = target.shape[1:3]
        for k in range(1, n_objs + 1):
            coords = np.nonzero(labels == k)
            cc_y, cc_x = coords[-2], coords[-1]
            box = (slice(None),
                   slice(max(0, cc_y.min() - 1), min(h, cc_y.max() + 2)),
                   slice(max(0, cc_x.min() - 1), min(w, cc_x.max() + 2)),
                   slice(None))
            _save_array(z_grp, "target/%i/%i" % (im_id, k),
                        np.asarray(target)[box])
            _save_array(z_grp, "scores/%i/%i" % (im_id, k),
                        pred_scores[box].astype(np.float32))
            _save_array(z_grp, "class/%i/%i" % (im_id, k),
                        pred_class[box].astype(np.uint8))
            if save_input:
                _save_array(z_grp, "input/%i/%i" % (im_id, k),
                            np.clip(np.asarray(x)[box] * 255, 0,
                                    255).astype(np.uint8))


def infer(model, test_data, args, device=None):
    """Store the predictions of the whole test queue (JAX
    ``cli/test_cae_classifier.py:116``); ``model`` lives on ``device``."""
    logger = logging.getLogger(args.mode + "_log")
    dev = resolve_device(device)
    compute_dtype = COMPUTE_DTYPES[get_default_precision()]
    forward = make_forward_fn(model)

    @torch.no_grad()
    def forward_step(x):
        outputs, _ = forward(x.to(compute_dtype), train=False,
                             compute_dtype=compute_dtype)
        pred = (outputs["t_pred"] if outputs["t_pred"] is not None
                else outputs["s_pred"])
        return pred.float().cpu().numpy()

    save_filename = os.path.join(args.log_dir,
                                 f"output{args.log_identifier}.zarr")
    for i, (x, t) in enumerate(test_data):
        pred = forward_step(torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(dev))
        save_pred2zarr(save_filename, i, x, t, pred, args.seg_threshold,
                       args.batch_size, args.patch_size, args.num_classes,
                       args.compute_components_metrics, top_k=5,
                       save_input=args.save_input)

        if (i % max(1, int(len(test_data) * 0.1))) == 0:
            metrics = compute_metrics_per_image(
                pred, t, top_k=5, seg_threshold=args.seg_threshold,
                num_classes=args.num_classes)
            log_str = "Test metrics" + "".join(
                " {}:{:.3f}".format(k, np.nanmean(m))
                for k, m in metrics.items())
            logger.info(log_str)
    return True


def _roc_to_zarr(pred_scores, target, component, args):
    fpr, tpr, thrsh, roc_auc = compute_roc_curve(pred_scores, target)
    save_filename = os.path.join(args.log_dir,
                                 f"output{args.log_identifier}.zarr")
    z_grp = zarrlib.Group.create(save_filename)
    _save_array(z_grp, component + "/tpr", tpr)
    _save_array(z_grp, component + "/fpr", fpr)
    _save_array(z_grp, component + "/thrsh", thrsh)
    return roc_auc


def compute_metrics(args, object_level: bool = False):
    """Out-of-core metrics over the stored prediction tree (JAX
    ``cli/test_cae_classifier.py:155``)."""
    logger = logging.getLogger(args.mode + "_log")
    type_level = "object_level" if object_level else "image_level"

    path = os.path.join(args.log_dir, f"output{args.log_identifier}.zarr")
    z = zarrlib.open(path, mode="r")

    chunk_pairs = []
    top_chunks = [] if "topk" in z else None
    score_parts, target_parts = [], []

    for i in z["target"].keys():
        keys = (sorted(set(z["target"][i].keys()) - {"0"}) if object_level
                else ["0"])
        for k in keys:
            pred_class = z["class"][i][k][...].reshape(-1)
            target = z["target"][i][k][...]
            tgt_flat = target.reshape(-1)
            chunk_pairs.append((pred_class, tgt_flat))
            if top_chunks is not None and k in z["topk"][i]:
                topk = z["topk"][i][k][...]
                top_chunks.append(topk.reshape(-1, topk.shape[-1]))
            if args.num_classes == 1:
                score_parts.append(z["scores"][i][k][...].reshape(-1))
                target_parts.append(tgt_flat)

    metrics = compute_class_metrics_streaming(
        chunk_pairs, args.num_classes, pred_class_top_chunks=top_chunks)

    if args.num_classes == 1 and score_parts:
        metrics["auc"] = _roc_to_zarr(np.concatenate(score_parts),
                                      np.concatenate(target_parts) > 0.5,
                                      type_level, args)

    log_str = "Test metrics at " + type_level + "".join(
        " {}:{:.3f}".format(m, v) for m, v in metrics.items())
    logger.info(log_str)
    return metrics


def test(args, device=None):
    """Infer (unless ``-mo``) and compute the metrics (JAX
    ``cli/test_cae_classifier.py:200``); returns the image-level
    metrics, and with ``-ccm`` the object-level ones under
    ``"object_level"``."""
    logger = logging.getLogger(args.mode + "_log")
    dev = resolve_device(device)
    args.criterion = "CE"

    out = get_data(args, device=dev)
    test_data, num_classes = out if len(out) == 2 else (out[0], out[2])
    args.num_classes = num_classes

    model = setup_network(args, device=dev).eval()

    logger.info("Network modules: %s"
                % [n for n, _ in model.named_children()])

    if not args.metrics_only:
        infer(model, test_data, args, device=dev)

    metrics = compute_metrics(args, object_level=False)
    if args.compute_components_metrics:
        metrics["object_level"] = compute_metrics(args, object_level=True)
    return metrics


def cli():
    """Entry point of ``python -m
    cnn_autoencoder_tpu_torch.cli.test_cae_classifier``: parse argv and
    evaluate on the card."""
    args = get_args(task="autoencoder", mode="test")
    loggers.setup_logger(args)
    test(args)
    logging.shutdown()


if __name__ == "__main__":
    cli()
