"""The ranks of ``tests/test_torch_model_axis.py``: the port alone (no
JAX), run as its own process by that test.

``python tests/torch_model_axis_ranks.py steps WORK DATA MODEL`` is one
rank of the bare step over a ``(DATA, MODEL)`` mesh of gloo ranks: it
joins the group that ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID`` name, forms the mesh's groups, holds the model's sharded
parameters as its model index's slices, takes its data index's share of
the global batches in ``WORK/inputs.npz``, runs the steps and writes its
losses, its step-1 gradients and its parameters (both gathered over the
model group), and its shards' sizes to ``WORK/rank<r>.npz``.

``python tests/torch_model_axis_ranks.py cli ARGS_JSON DEVICES_JSON MODEL``
runs the train CLI's ``main`` over the devices under
``CAE_TPU_MODEL_PARALLEL=MODEL`` and prints its reports as one JSON line.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss  # noqa: E402
from cnn_autoencoder_tpu_torch.models.factory import build_model  # noqa
from cnn_autoencoder_tpu_torch.parallel.distributed import (  # noqa: E402
    all_gather_axis, named_shards)
from cnn_autoencoder_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_model_state, shard_model)
from cnn_autoencoder_tpu_torch.training.loop import make_train_step  # noqa
from cnn_autoencoder_tpu_torch.training.optim import \
    setup_optimizers  # noqa: E402

TRAINABLE = ["encoder", "decoder", "fact_ent"]
# SGD, as tests/torch_parallel_ranks.py explains
ALGO, LR = "SGD", 1e-2
# flagship-like GDN units (tests/test_parallel.py:65's), 64 channels wide
# so that the middle down stage is the fused conv+GDN one
CONFIG = dict(channels_org=3, channels_net=64, channels_bn=16,
              compression_level=3, K=4, r=3, act_layer_type="GDN")
CRITERION = "RateMSE"


def _gathered_grads(model, grads):
    """{module.param: step gradient, whole} (gathered over the model
    group where the parameter is a shard)."""
    shards = named_shards(model)
    out = {}
    for m, named in grads.items():
        for n, g in named.items():
            s = shards.get(f"{m}.{n}")
            out[f"{m}.{n}"] = (g if s is None else all_gather_axis(
                g, s.group, s.axis)).numpy().copy()
    return out


def bare_steps(xs, group=None, model_group=None, model_index=0,
               model_size=1, seed=5, noises=None):
    """The steps of ``make_train_step`` on ``xs`` (this process's share
    of each global batch) from the model of seed 0, its parameters
    sharded over ``model_group``; noise drawn from a generator of
    ``seed``, or the given one.  Returns (losses, step-1 gradients,
    parameters, {parameter: numel on this rank})."""
    model = build_model(CONFIG, torch.Generator().manual_seed(0),
                        device="cpu")
    shard_model(model, model_group, model_index, model_size)
    optimizers = setup_optimizers(model, TRAINABLE,
                                  {k: ALGO for k in TRAINABLE})
    step = make_train_step(
        model, setup_loss(CRITERION, distortion_lambda=0.01), optimizers,
        trainable_modules=TRAINABLE, group=group, model_group=model_group)
    gen = torch.Generator().manual_seed(seed)
    losses, first = [], None
    for i, x in enumerate(xs, start=1):
        extra = {} if noises is None else dict(noise=noises[i - 1])
        stats, grads = step(torch.from_numpy(x), {k: LR for k in optimizers},
                            i, generator=gen, **extra)
        losses.append(float(stats["loss"]))
        if first is None:
            first = _gathered_grads(model, grads)
    state = {k: v.detach().numpy().copy()
             for k, v in gather_model_state(model).items()}
    numel = {k: p.numel() for k, p in model.named_parameters()}
    return losses, first, state, numel


def _steps_rank(work, data, model):
    import torch.distributed as dist
    from cnn_autoencoder_tpu_torch.parallel.distributed import (
        initialize_multihost, local_batch_slice, mesh_groups, process_index)
    assert initialize_multihost(device="cpu")
    try:
        group, model_group = mesh_groups(data, model)
        inputs = np.load(os.path.join(work, "inputs.npz"))
        xs = [inputs[k][local_batch_slice(len(inputs[k]), model)]
              for k in sorted(inputs.files)]
        losses, grads, state, numel = bare_steps(
            xs, group, model_group, process_index() % model, model)
        np.savez(os.path.join(work, "rank%d.npz" % process_index()),
                 losses=np.asarray(losses),
                 **{"grad/" + k: v for k, v in grads.items()},
                 **{"param/" + k: v for k, v in state.items()},
                 **{"numel/" + k: np.asarray(v) for k, v in numel.items()})
    finally:
        dist.destroy_process_group()


def _cli(args_json, devices_json, model):
    from cnn_autoencoder_tpu_torch.cli.train_cae import main
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    os.environ["CAE_TPU_MODEL_PARALLEL"] = model
    args = get_args("autoencoder", "training",
                    args_list=json.loads(args_json))
    setup_logger(args)
    reports = main(args, devices=json.loads(devices_json))
    print("REPORTS " + json.dumps(reports), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "steps":
        _steps_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        _cli(sys.argv[2], sys.argv[3], sys.argv[4])
