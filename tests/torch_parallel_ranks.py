"""The ranks of ``tests/test_torch_parallel_train.py``: the port alone
(no JAX), run as its own process by that test.

``python tests/torch_parallel_ranks.py steps WORK`` is one rank of the bare
data-parallel step: it joins the group that ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID`` name (gloo on the CPU), takes its share
of the global batches in ``WORK/inputs.npz``, runs the steps and writes its
losses, parameters and running statistics to ``WORK/rank<r>.npz``.

``python tests/torch_parallel_ranks.py cli ARGS_JSON DEVICES_JSON`` runs
the train CLI's ``main`` over the devices (one spawned rank each) and
prints its reports as one JSON line.
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
from cnn_autoencoder_tpu_torch.training.loop import make_train_step  # noqa
from cnn_autoencoder_tpu_torch.training.optim import \
    setup_optimizers  # noqa: E402

TRAINABLE = ["encoder", "decoder", "fact_ent"]
# SGD: Adam's step is the gradient's sign where the gradient is at the
# level of float32 rounding (GDN's bounded parameters at their bound), so
# two summation orders of the same gradient can move such an element a
# whole step apart, in one process as across ranks
ALGO, LR = "SGD", 1e-2
# flagship-like GDN units at widths of 8, with batch norm and dropout
CONFIG = dict(channels_org=3, channels_net=8, channels_bn=8,
              compression_level=2, K=4, r=3, act_layer_type="GDN",
              batch_norm=True, dropout=0.1)
CRITERION = "RateMSEPA"


def bare_steps(xs, group=None, seed=5, noises=None, masks=None):
    """The steps of ``make_train_step`` on ``xs`` (this process's share
    of each global batch) from the model of seed 0; noise and dropout
    masks drawn from a generator of ``seed``, or the given ones.  Returns
    (losses, {parameter or buffer name: array})."""
    model = build_model(CONFIG, torch.Generator().manual_seed(0),
                        device="cpu")
    optimizers = setup_optimizers(model, TRAINABLE,
                                  {k: ALGO for k in TRAINABLE})
    step = make_train_step(
        model, setup_loss(CRITERION, distortion_lambda=0.01), optimizers,
        trainable_modules=TRAINABLE, group=group)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for i, x in enumerate(xs, start=1):
        extra = {} if noises is None else dict(noise=noises[i - 1],
                                                masks=masks[i - 1])
        stats, _ = step(torch.from_numpy(x), {k: LR for k in optimizers}, i,
                        generator=gen, **extra)
        losses.append(float(stats["loss"]))
    state = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    return losses, state


def _steps_rank(work):
    from cnn_autoencoder_tpu_torch.parallel.distributed import (
        initialize_multihost, local_batch_slice, process_index)
    import torch.distributed as dist
    assert initialize_multihost(device="cpu")
    try:
        inputs = np.load(os.path.join(work, "inputs.npz"))
        xs = [inputs[k][local_batch_slice(len(inputs[k]))]
              for k in sorted(inputs.files)]
        losses, state = bare_steps(xs, group=dist.group.WORLD)
        np.savez(os.path.join(work, "rank%d.npz" % process_index()),
                 losses=np.asarray(losses), **state)
    finally:
        dist.destroy_process_group()


def _cli(args_json, devices_json):
    from cnn_autoencoder_tpu_torch.cli.train_cae import main
    from cnn_autoencoder_tpu_torch.utils.args import get_args
    from cnn_autoencoder_tpu_torch.utils.loggers import setup_logger
    args = get_args("autoencoder", "training",
                    args_list=json.loads(args_json))
    setup_logger(args)
    reports = main(args, devices=json.loads(devices_json))
    print("REPORTS " + json.dumps(reports), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "steps":
        _steps_rank(sys.argv[2])
    else:
        _cli(sys.argv[2], sys.argv[3])
