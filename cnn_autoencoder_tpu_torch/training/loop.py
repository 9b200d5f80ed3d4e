"""The train and eval steps and the validation pass, counterparts of the
JAX package's ``training/loop.py:43-178``.

The train step is one forward, one backward of
``mean(loss) + mean(entropy_loss)`` (the rate/distortion objective and the
bottleneck's auxiliary quantile loss touch disjoint parameters, so one
backward serves both), and the per-slot optimizer update.  Its compute type
is explicit, the counterpart of ``convops.set_default_precision``:

* ``torch.float32``: the network runs in float32 at the default
  precision's float32 form (``convops.layer_precision``): in full float32
  at "highest" (TF32 off in the forward and in the backward convolutions
  and products), or with the convolutions' products at "default" or
  "high" in both directions, as XLA transposes the JAX package's.
* ``torch.bfloat16``: the batch is cast to bf16 and the network carries bf16
  activations (convs with bf16 operands and float32 sums, GDN through K2
  and K3); the distortion target stays the float32 batch.  Batch norms
  return float32, as flax's do; the layers after one take the mode from
  the step (``compute_dtype``), as the JAX package's take its global
  mode.

Batch norms and dropout run in train mode in the train step and in eval
mode in the eval step.  The train step draws its dropout masks from its
generator (or takes them from the caller) and folds the batch norms' new
running statistics into the model once, after the forward.  With ``remat``
the encoder's and decoder's forwards are recomputed in the backward.

On the card every GDN and fused conv+GDN layer goes through its kernel;
CPU tensors take the plain versions.

Data parallelism (``group``, a ``torch.distributed`` process group of
ranks with equal shares of a global batch, one process a card): the JAX
step under a data mesh, by hand.  ``torch.autograd.grad`` runs no
``AccumulateGrad``, so ``DistributedDataParallel``'s hooks would not fire;
the gradient list is averaged by an explicit all-reduce instead, one flat
bucket a dtype, before the update (the psum XLA inserts).  The batch norms'
statistics and the criteria's reductions that are not a mean of equal
shares are taken over the global batch; the dropout masks and the
bottleneck's noise are drawn for the global batch from the same generator
on every rank and sliced; the stats are reduced over the ranks (means,
minima, maxima, standard deviations of the global batch).  So a step of R
ranks is the one-process step of the global batch, and every rank holds
the same parameters after it.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.tasks import fold_batch_stats, make_forward_fn, module_runner
from ..ops.batchnorm import BatchNorm
from ..parallel.distributed import world_size
from ..utils.device import full_f32
from .optim import apply_module_updates

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype}")


def _net_aux(model, trainable_modules: Sequence[str] = (),
             group=None) -> Dict:
    """What the loss composer needs from the model (JAX
    ``training/loop.py:28-39``): the bottleneck's parameters, and
    ``decoder_fn``, the decoder's reconstructions of a latent (PenaltyB),
    through the frozen path when the decoder is not trainable; the
    process group of a data-parallel step."""
    net = {"group": group}
    if hasattr(model, "fact_ent"):
        net["fact_ent_params"] = model.fact_ent.params()
        net["num_filters"] = model.fact_ent.num_filters
    if hasattr(model, "decoder"):
        run = module_runner(model, trainable_modules)
        net["decoder_fn"] = lambda code: run("decoder", code)[0]
    return net


def _set_batch_norm_group(model, group) -> None:
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def _average_gradients(grads: List[torch.Tensor], group) -> None:
    """Average ``grads`` over the group's ranks in place: one flat bucket a
    dtype, one all-reduce each."""
    n = world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _global_std(t: torch.Tensor, group) -> torch.Tensor:
    """The population standard deviation of every rank's ``t`` (equal
    shares), as ``jnp.std`` of the global batch."""
    t = t.detach().double()
    sums = torch.stack([t.sum(), (t * t).sum()])
    dist.all_reduce(sums, group=group)
    n = t.numel() * world_size(group)
    mean = sums[0] / n
    return torch.sqrt(torch.clamp_min(sums[1] / n - mean * mean, 0.0)) \
        .float()


def _reduce_stats(stats: Dict[str, torch.Tensor], group
                  ) -> Dict[str, torch.Tensor]:
    """A step's stats over the ranks: ``*_min`` the least, ``*_max`` the
    largest, every other value the mean (equal shares; values every rank
    already holds, such as penalty A's medians, stay as they are).  One
    all-reduce a reduction."""
    out = dict(stats)
    for op, keys in (
            (dist.ReduceOp.MIN, [k for k in stats if k.endswith("_min")]),
            (dist.ReduceOp.MAX, [k for k in stats if k.endswith("_max")]),
            (dist.ReduceOp.SUM, [k for k in stats
                                 if not k.endswith(("_min", "_max"))])):
        if not keys:
            continue
        flat = torch.cat([stats[k].float().reshape(-1) for k in keys])
        dist.all_reduce(flat, op=op, group=group)
        if op == dist.ReduceOp.SUM:
            flat /= world_size(group)
        offset = 0
        for k in keys:
            v = stats[k]
            part = flat[offset:offset + v.numel()].view(v.shape)
            out[k] = (torch.round(part) if not v.is_floating_point()
                      else part).to(v.dtype)
            offset += v.numel()
    return out


def make_train_step(model, criterion, optimizers,
                    enabled_modules: Optional[Sequence[str]] = None,
                    trainable_modules: Optional[Sequence[str]] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    remat: bool = False, group=None):
    """Build ``train_step(x, lrs, step, noise=None, generator=None,
    masks=None, t=None) -> (stats, grads)``.

    ``x`` is a float32 NHWC batch on the model's device, ``t`` its targets
    (labels or label maps, for a criterion with a class loss), ``lrs`` a
    dict of learning rates per optimizer slot, ``step`` the 1-based step
    number.
    The dropout masks are ``masks`` when given (``models/tasks.py:
    draw_masks``' layout), else drawn from ``generator``, and then the
    bottleneck's noise is ``noise`` when given, else drawn from
    ``generator``.  ``stats`` is a dict of detached scalars (and the
    ``dist`` vector); ``grads`` is ``{module: {param name: gradient}}`` of
    this step, before accumulation and clipping.  The model's parameters,
    its batch norms' running statistics and the optimizers' state are
    updated in place.  ``remat`` recomputes the forward in the backward
    (the JAX package's ``remat``): the same step in less memory.
    ``group``: a process group to train over, data-parallel (the module's
    docstring; ``x``, ``t``, ``noise`` and ``masks`` are then this rank's
    share of the global batch); it is set on the model's batch norms."""
    _check_dtype(compute_dtype)
    _set_batch_norm_group(model, group)
    trainable = [m for m in (trainable_modules or []) if hasattr(model, m)]
    forward = make_forward_fn(model, enabled_modules, trainable, remat=remat)
    names = [(m, n) for m in trainable
             for n, _ in getattr(model, m).named_parameters()]
    leaves = [getattr(model, m).get_parameter(n) for m, n in names]

    def train_step(x: torch.Tensor, lrs: Dict[str, float], step: int,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   masks: Optional[Dict] = None,
                   t: Optional[torch.Tensor] = None):
        rows = None
        if group is not None:
            b = x.shape[0]
            rank = dist.get_rank(group)
            rows = (rank * b, (rank + 1) * b, b * world_size(group))
        # TF32 off for the forward and for autograd's backward kernels
        with full_f32():
            outputs, new_state = forward(
                x.to(compute_dtype), train=True, noise=noise,
                generator=generator, masks=masks,
                compute_dtype=compute_dtype, rows=rows)
            fold_batch_stats(model, new_state)
            loss_dict = criterion(x, outputs, targets=t,
                                  net=_net_aux(model, trainable, group))
            total = torch.mean(loss_dict["loss"])
            if "entropy_loss" in loss_dict:
                total = total + torch.mean(loss_dict["entropy_loss"])
            got = torch.autograd.grad(total, leaves, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for g, p in zip(got, leaves)]
        if group is not None:
            _average_gradients(got, group)
        grads: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in trainable}
        for (m, n), g in zip(names, got):
            grads[m][n] = g
        loss_dict["x_min"] = x.min()
        loss_dict["x_max"] = x.max()
        loss_dict["x_std"] = (torch.std(x, correction=0) if group is None
                              else _global_std(x, group))
        apply_module_updates(optimizers, grads, lrs, step)
        return _summary_stats(outputs, loss_dict, group), grads

    return train_step


def make_eval_step(model, criterion,
                   enabled_modules: Optional[Sequence[str]] = None,
                   compute_dtype: torch.dtype = torch.float32, group=None):
    """Build ``eval_step(x, t=None) -> stats``: round-to-median
    quantization, batch norms and dropout in eval mode, no gradient, in
    ``compute_dtype``; ``t`` the batch's targets.  ``group``: as the train
    step's, ``x`` this rank's share and the stats the global batch's."""
    _check_dtype(compute_dtype)
    forward = make_forward_fn(model, enabled_modules, trainable_modules=[])

    @torch.no_grad()
    def eval_step(x: torch.Tensor, t: Optional[torch.Tensor] = None):
        with full_f32():
            outputs, _ = forward(x.to(compute_dtype), train=False,
                                 compute_dtype=compute_dtype)
            loss_dict = criterion(x, outputs, targets=t,
                                  net=_net_aux(model, group=group))
        return _summary_stats(outputs, loss_dict, group)

    return eval_step


def _summary_stats(outputs, loss_dict, group=None
                   ) -> Dict[str, torch.Tensor]:
    """Detached scalar summary (``_summary_stats`` there; standard
    deviations are the population's, as ``jnp.std``), over the group's
    ranks when there is one."""
    stats = {k: v.detach() for k, v in loss_dict.items()
             if not isinstance(v, (list, tuple))}
    if isinstance(loss_dict.get("dist"), (list, tuple)):
        stats["dist"] = torch.stack([d.detach() for d in loss_dict["dist"]])
    x_r = outputs.get("x_r")
    if isinstance(x_r, (list, tuple)):
        x_r = x_r[0]
    if x_r is not None:
        x_r = x_r.detach()
        stats["x_r_min"] = x_r.min()
        stats["x_r_max"] = x_r.max()
        stats["x_r_std"] = (torch.std(x_r.float(), correction=0)
                            if group is None else _global_std(x_r, group))
    if outputs.get("y") is not None:
        stats["y_min"] = outputs["y"].detach().min()
        stats["y_max"] = outputs["y"].detach().max()
    if outputs.get("p_y") is not None:
        stats["p_y_min"] = outputs["p_y"].detach().min()
        stats["p_y_max"] = outputs["p_y"].detach().max()
    return stats if group is None else _reduce_stats(stats, group)


def valid(eval_step, data):
    """A validation pass over ``data`` (an iterable of ``x`` or ``(x, t)``);
    returns ``(mean loss, {"val_<stat>": mean})`` over the scalar stats."""
    sum_loss, count = 0.0, 0
    rec: Dict[str, list] = {}
    for batch in data:
        x, t = (batch if isinstance(batch, (tuple, list)) else (batch, None))
        stats = eval_step(x, t)
        sum_loss += float(stats["loss"])
        count += 1
        for k, v in stats.items():
            if v.dim() == 0:
                rec.setdefault(k, []).append(float(v))
    if count == 0:
        return float("nan"), {}
    avg = {"val_" + k: float(np.nanmean(v)) for k, v in rec.items()}
    return sum_loss / count, avg
