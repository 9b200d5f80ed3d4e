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

``python tests/torch_model_axis_ranks.py options WORK DATA MODEL`` is one
rank of ``tests/test_torch_model_axis_options.py``'s launch: the same
process runs, one after another, 2 SGD steps of each architecture of
``ARCHS`` (``WORK/options.npz`` holds each one's global batches and
targets) and then the eval forwards of the heads of ``EVAL_HEADS`` on
their latents, its model's leaves held as its model index's slices;
it writes each one's losses, step-1 gradients, parameters and running
statistics (gathered over the model group), its parameters' sizes and
its optimizers' parameter count, and the heads' logits, to
``WORK/options<r>.npz``.

``python tests/torch_model_axis_ranks.py forwards WORK MODEL`` is one
rank of a ``(1, MODEL)`` mesh: the eval forward of each model of
``FORWARD_OPTIONS`` on its ``option_input``, and each grouped layer of
``GROUPED_LAYERS`` (``WORK/layers.npz``: its weights, input and output
cotangent) forward and backward, written to ``WORK/forwards<r>.npz``.

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

# the architectures the model axis takes besides the flagship's, each
# (config, trainable modules, criterion, target kind): residual units; batch
# norm with dropout; grouped convolutions at 4 / 4 / 4, whose kernels shard
# by whole groups at model=2; JNet with batch norm (the segmenter's
# GroupNorm), trained with the codec, whose batch norms a frozen codec
# could not update in a train step; ViT on the frozen codec
_CAE8 = dict(channels_org=3, channels_net=8, channels_bn=8,
             compression_level=2, K=4, r=3, act_layer_type="GDN")
ARCHS = {
    "R": (dict(_CAE8, use_residual=True), TRAINABLE, "RateMSE", None),
    "B": (dict(_CAE8, batch_norm=True, dropout=0.1), TRAINABLE, "RateMSE",
          None),
    "G444": (dict(_CAE8, channels_org=4, channels_net=4, channels_bn=4,
                  groups=True), TRAINABLE, "RateMSE", None),
    "JNet": (dict(_CAE8, batch_norm=True, seg_model_type="JNet",
                  seg_channels_net=8, seg_channels_bn=16,
                  seg_channels_expansion=2, num_classes=1),
             TRAINABLE + ["seg_model"], "RateMSEBCE", "map"),
    "ViT": (dict(_CAE8, class_model_type="ViT", cut_position=10,
                 patch_size=16, num_classes=4), ["class_model"], "RateMSECE",
            "labels"),
}
OPTION_STEPS, OPTION_BATCH, OPTION_SIDE = 2, 4, 16
# eval-only heads, as tests/test_torch_heads.py builds them: (kind, kwargs,
# latent shape); Inception's cut 5 (from its patch size) keeps BasicConv2d's
# batch norms
EVAL_HEADS = {
    "ResNet": (dict(channels_bn=16, cut_position=3, patch_size=32,
                    compression_level=2, num_classes=8,
                    layers=(1, 2, 1, 1)), (2, 8, 8, 16)),
    "InceptionV3": (dict(channels_bn=16, cut_position=None, patch_size=64,
                         compression_level=3, num_classes=6),
                    (2, 8, 8, 16)),
}
# the five options the model axis once left out, on the 64-wide CAE
FORWARD_OPTIONS = {
    "residual": dict(use_residual=True),
    "batch_norm": dict(batch_norm=True),
    "groups": dict(groups=True, channels_org=4, channels_net=4,
                   channels_bn=4),
    "seg_model": dict(seg_model_type="JNet", seg_channels_net=8,
                      seg_channels_bn=16, num_classes=1),
    "class_model": dict(class_model_type="ViT", patch_size=16,
                        cut_position=11, num_classes=4),
}


# grouped layers (cin, cout, groups, stride) at model=2: a rank's output
# channels covering whole groups (4 and 2 groups), and not (3 groups)
GROUPED_LAYERS = ((4, 8, 4, 2), (6, 6, 3, 1), (4, 6, 2, 2))


def option_config(option):
    return dict(dict(CONFIG, channels_net=8), **FORWARD_OPTIONS[option])


def loss_for(criterion):
    return setup_loss(criterion, distortion_lambda=0.01, class_error_mu=1.0,
                      patch_size=OPTION_SIDE)


class Heads(torch.nn.Module):
    """A head alone as the model ``shard_model`` shards: its leaves under
    ``class_model``."""

    def __init__(self, kind):
        super().__init__()
        from cnn_autoencoder_tpu_torch.models.classifiers import \
            CLASS_MODELS
        kwargs, shape = EVAL_HEADS[kind]
        self.config = {}
        self.class_model = CLASS_MODELS[kind](**kwargs,
                                              channels_in=shape[-1])
        gen = torch.Generator().manual_seed(0)
        for m in self.class_model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        with torch.no_grad():   # norms and statistics off 1 and 0
            for value in self.state_dict().values():
                if value.dim() == 1:
                    value.add_(torch.rand(value.shape, generator=gen) * 0.2)


def head_forward(kind, x, model_group=None, model_index=0, model_size=1):
    """``Heads(kind)``'s eval forward on ``x``, its leaves sharded over
    ``model_group``: (logits, aux logits or None) as numpy."""
    heads = shard_model(Heads(kind).eval(), model_group, model_index,
                        model_size)
    with torch.no_grad():
        out, aux = heads.class_model(torch.from_numpy(x))
    return out.numpy(), None if aux is None else aux.numpy()


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
               model_size=1, seed=5, noises=None, arch=None, ts=None,
               report=None, masks=None):
    """The steps of ``make_train_step`` on ``xs`` (this process's share
    of each global batch, ``ts`` its targets) from the model of seed 0 of
    ``CONFIG`` (or ``ARCHS[arch]``), its parameters sharded over
    ``model_group``; noise (and dropout masks) drawn from a generator of
    ``seed``, or the given ones.  Returns (losses, step-1 gradients,
    parameters and buffers, {parameter: numel on this rank}); ``report``
    (a dict) gets the optimizers' parameter count."""
    config, trainable, criterion, _ = (
        (CONFIG, TRAINABLE, CRITERION, None) if arch is None
        else ARCHS[arch])
    model = build_model(config, torch.Generator().manual_seed(0),
                        device="cpu")
    shard_model(model, model_group, model_index, model_size)
    optimizers = setup_optimizers(model, trainable,
                                  {k: ALGO for k in trainable})
    if report is not None:
        report["optimized"] = sum(p.numel() for s in optimizers.values()
                                  for p in s.params.values())
    step = make_train_step(
        model, loss_for(criterion), optimizers, trainable_modules=trainable,
        group=group, model_group=model_group)
    gen = torch.Generator().manual_seed(seed)
    losses, first = [], None
    for i, x in enumerate(xs, start=1):
        extra = {} if noises is None else dict(noise=noises[i - 1])
        if masks is not None:
            extra["masks"] = masks[i - 1]
        if ts is not None:
            extra["t"] = torch.from_numpy(ts[i - 1])
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


def _options_rank(work, data, model):
    import torch.distributed as dist
    from cnn_autoencoder_tpu_torch.parallel.distributed import (
        initialize_multihost, local_batch_slice, mesh_groups, process_index)
    assert initialize_multihost(device="cpu")
    torch.set_num_threads(2)
    try:
        group, model_group = mesh_groups(data, model)
        index = process_index() % model
        inputs = np.load(os.path.join(work, "options.npz"))
        out = {}
        for arch in ARCHS:
            rows = local_batch_slice(OPTION_BATCH, model)
            xs = [inputs[f"{arch}/x{i}"][rows] for i in range(OPTION_STEPS)]
            ts = ([inputs[f"{arch}/t{i}"][rows] for i in range(OPTION_STEPS)]
                  if f"{arch}/t0" in inputs.files else None)
            report = {}
            losses, grads, state, numel = bare_steps(
                xs, group, model_group, index, model, arch=arch, ts=ts,
                report=report)
            out[f"{arch}/losses"] = np.asarray(losses)
            out[f"{arch}/optimized"] = np.asarray(report["optimized"])
            out.update({f"{arch}/grad/{k}": v for k, v in grads.items()})
            out.update({f"{arch}/state/{k}": v for k, v in state.items()})
            out.update({f"{arch}/numel/{k}": np.asarray(v)
                        for k, v in numel.items()})
        for kind, (_, shape) in EVAL_HEADS.items():
            x = inputs[f"{kind}/x"][local_batch_slice(shape[0], model)]
            logits, aux = head_forward(kind, x, model_group, index, model)
            out[f"{kind}/logits"] = logits
            if aux is not None:
                out[f"{kind}/aux"] = aux
        np.savez(os.path.join(work, "options%d.npz" % process_index()),
                 **out)
    finally:
        dist.destroy_process_group()


def option_input(option):
    """Two 16^2 images of the option's channels, from a seed."""
    channels = option_config(option)["channels_org"]
    return np.random.RandomState(3).rand(2, 16, 16, channels).astype(
        np.float32)


def option_forward(option, x, model_group=None, model_index=0,
                   model_size=1):
    """The eval forward of ``FORWARD_OPTIONS[option]``'s model of seed 0
    on ``x``, its leaves sharded over ``model_group``: {output: array}
    and {state key: numel on this rank}."""
    from cnn_autoencoder_tpu_torch.models.tasks import make_forward_fn
    model = build_model(option_config(option),
                        torch.Generator().manual_seed(0), device="cpu")
    shard_model(model, model_group, model_index, model_size)
    with torch.no_grad():
        out, _ = make_forward_fn(model.eval())(torch.from_numpy(x))
    got = {"x_r": out["x_r"][0], "y_q": out["y_q"], "p_y": out["p_y"]}
    for key in ("t_pred", "s_pred"):
        if out[key] is not None:
            got[key] = out[key]
    return ({k: v.numpy() for k, v in got.items()},
            {k: v.numel() for k, v in model.state_dict().items()})


def grouped_layer(kind, case, arrays, model_group=None, model_index=0,
                  model_size=1):
    """``GROUPED_LAYERS[case]`` as a ``Conv2dReflect`` or a
    ``ConvTranspose2dTorch`` with ``arrays``' weight and bias, held as
    model-axis shards along their first axis over ``model_group``; (y,
    the input's gradient, the weight's gradient gathered) on ``arrays``'
    input and output cotangent."""
    from cnn_autoencoder_tpu_torch.ops.convops import (Conv2dReflect,
                                                       ConvTranspose2dTorch)
    from cnn_autoencoder_tpu_torch.parallel.distributed import ModelShard
    cin, cout, groups, stride = GROUPED_LAYERS[case]
    layer = (ConvTranspose2dTorch(cin, cout, 3, stride, 1, stride - 1, True,
                                  groups) if kind == "deconv"
             else Conv2dReflect(cin, cout, 3, stride, True, groups))
    weight, bias = (torch.from_numpy(np.array(arrays[f"{kind}{case}/{n}"]))
                    for n in ("weight", "bias"))
    if model_size > 1:
        shard = ModelShard(model_group, model_index, model_size, 0)
        weight, bias = shard.narrow(weight), shard.narrow(bias)
        layer.model_shards = {"weight": shard, "bias": shard}
    layer.weight = torch.nn.Parameter(weight.clone())
    layer.bias = torch.nn.Parameter(bias.clone())
    x = torch.from_numpy(arrays[f"{kind}{case}/x"]).requires_grad_(True)
    y = layer(x)
    dx, dw = torch.autograd.grad(y, (x, layer.weight), torch.from_numpy(
        arrays[f"{kind}{case}/g"]))
    if model_size > 1:
        dw = all_gather_axis(dw, model_group, 0)
    return y.detach().numpy(), dx.numpy(), dw.numpy()


def _forwards_rank(work, model):
    import torch.distributed as dist
    from cnn_autoencoder_tpu_torch.parallel.distributed import (
        initialize_multihost, mesh_groups, process_index)
    assert initialize_multihost(device="cpu")
    try:
        _, model_group = mesh_groups(1, model)
        out = {}
        for option in FORWARD_OPTIONS:
            got, numel = option_forward(option, option_input(option),
                                        model_group, process_index(), model)
            out.update({f"{option}/{k}": v for k, v in got.items()})
            out.update({f"{option}/numel/{k}": np.asarray(v)
                        for k, v in numel.items()})
        arrays = np.load(os.path.join(work, "layers.npz"))
        for kind in ("conv", "deconv"):
            for case in range(len(GROUPED_LAYERS)):
                got = grouped_layer(kind, case, arrays, model_group,
                                    process_index(), model)
                out.update({f"{kind}{case}/{n}": v
                            for n, v in zip(("y", "dx", "dw"), got)})
        np.savez(os.path.join(work, "forwards%d.npz" % process_index()),
                 **out)
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
    elif sys.argv[1] == "options":
        _options_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1] == "forwards":
        _forwards_rank(sys.argv[2], int(sys.argv[3]))
    else:
        _cli(sys.argv[2], sys.argv[3], sys.argv[4])
