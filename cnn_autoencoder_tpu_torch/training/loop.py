"""The train and eval steps and the validation pass, counterparts of the
JAX package's ``training/loop.py:43-178``.

The train step is one forward, one backward of
``mean(loss) + mean(entropy_loss)`` (the rate/distortion objective and the
bottleneck's auxiliary quantile loss touch disjoint parameters, so one
backward serves both), and the per-slot optimizer update.  Its compute type
is explicit, the counterpart of ``convops.set_default_precision``:

* ``torch.float32``: the network runs in full float32; TF32 stays off in
  the forward and in the backward convolutions and products.
* ``torch.bfloat16``: the batch is cast to bf16 and the network carries bf16
  activations (convs with bf16 operands and float32 sums, GDN through K2
  and K3); the distortion target stays the float32 batch.

On the card every GDN and fused conv+GDN layer goes through its kernel;
CPU tensors take the plain versions.
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.tasks import make_forward_fn
from ..utils.device import full_f32
from .optim import apply_module_updates

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype}")


def _net_aux(model) -> Dict:
    """What the loss composer needs from the model."""
    if not hasattr(model, "fact_ent"):
        return {}
    return {"fact_ent_params": model.fact_ent.params(),
            "num_filters": model.fact_ent.num_filters}


def make_train_step(model, criterion, optimizers,
                    enabled_modules: Optional[Sequence[str]] = None,
                    trainable_modules: Optional[Sequence[str]] = None,
                    compute_dtype: torch.dtype = torch.float32):
    """Build ``train_step(x, lrs, step, noise=None, generator=None) ->
    (stats, grads)``.

    ``x`` is a float32 NHWC batch on the model's device, ``lrs`` a dict of
    learning rates per optimizer slot, ``step`` the 1-based step number.
    The bottleneck's noise is ``noise`` when given, else drawn from
    ``generator``.  ``stats`` is a dict of detached scalars (and the
    ``dist`` vector); ``grads`` is ``{module: {param name: gradient}}`` of
    this step, before accumulation and clipping.  The model's parameters
    and the optimizers' state are updated in place."""
    _check_dtype(compute_dtype)
    trainable = [m for m in (trainable_modules or []) if hasattr(model, m)]
    forward = make_forward_fn(model, enabled_modules, trainable)
    names = [(m, n) for m in trainable
             for n, _ in getattr(model, m).named_parameters()]
    leaves = [getattr(model, m).get_parameter(n) for m, n in names]

    def train_step(x: torch.Tensor, lrs: Dict[str, float], step: int,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        # TF32 off for the forward and for autograd's backward kernels
        with full_f32():
            outputs = forward(x.to(compute_dtype), train=True, noise=noise,
                              generator=generator)
            loss_dict = criterion(x, outputs, net=_net_aux(model))
            total = torch.mean(loss_dict["loss"])
            if "entropy_loss" in loss_dict:
                total = total + torch.mean(loss_dict["entropy_loss"])
            got = torch.autograd.grad(total, leaves, allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in trainable}
        for (m, n), g, p in zip(names, got, leaves):
            grads[m][n] = torch.zeros_like(p) if g is None else g
        loss_dict["x_min"] = x.min()
        loss_dict["x_max"] = x.max()
        loss_dict["x_std"] = torch.std(x, correction=0)
        apply_module_updates(optimizers, grads, lrs, step)
        return _summary_stats(outputs, loss_dict), grads

    return train_step


def make_eval_step(model, criterion,
                   enabled_modules: Optional[Sequence[str]] = None,
                   compute_dtype: torch.dtype = torch.float32):
    """Build ``eval_step(x) -> stats``: round-to-median quantization, no
    gradient, in ``compute_dtype``."""
    _check_dtype(compute_dtype)
    forward = make_forward_fn(model, enabled_modules, trainable_modules=[])

    @torch.no_grad()
    def eval_step(x: torch.Tensor):
        with full_f32():
            outputs = forward(x.to(compute_dtype), train=False)
            loss_dict = criterion(x, outputs, net=_net_aux(model))
        return _summary_stats(outputs, loss_dict)

    return eval_step


def _summary_stats(outputs, loss_dict) -> Dict[str, torch.Tensor]:
    """Detached scalar summary (``_summary_stats`` there; standard
    deviations are the population's, as ``jnp.std``)."""
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
        stats["x_r_std"] = torch.std(x_r.float(), correction=0)
    if outputs.get("y") is not None:
        stats["y_min"] = outputs["y"].detach().min()
        stats["y_max"] = outputs["y"].detach().max()
    if outputs.get("p_y") is not None:
        stats["p_y_min"] = outputs["p_y"].detach().min()
        stats["p_y_max"] = outputs["p_y"].detach().max()
    return stats


def valid(eval_step, data):
    """A validation pass over ``data`` (an iterable of ``x`` or ``(x, t)``);
    returns ``(mean loss, {"val_<stat>": mean})`` over the scalar stats."""
    sum_loss, count = 0.0, 0
    rec: Dict[str, list] = {}
    for batch in data:
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        stats = eval_step(x)
        sum_loss += float(stats["loss"])
        count += 1
        for k, v in stats.items():
            if v.dim() == 0:
                rec.setdefault(k, []).append(float(v))
    if count == 0:
        return float("nan"), {}
    avg = {"val_" + k: float(np.nanmean(v)) for k, v in rec.items()}
    return sum_loss / count, avg
