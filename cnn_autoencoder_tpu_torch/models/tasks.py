"""Forward-pass composition with per-module enable/trainable gating.

Counterpart of the JAX package's ``models/tasks.py:make_forward_fn``: one
``forward`` built from the enabled and trainable module sets, producing the
output dict ``{x_r, fx_brg, y, y_q, p_y, t_pred, t_aux_pred, s_pred,
s_aux_pred}`` and ``new_state``, the batch norms' new running statistics
of each trainable module in train mode (JAX: the ``batch_stats``
collection ``apply`` returns mutated).  A module that is enabled but not
trainable runs with its parameters detached (``torch.func.functional_call``),
the counterpart of the JAX package's ``stop_gradient`` on its variables: its
own parameters get no gradient, while gradients flow through it to
trainable modules upstream; under the model mesh axis its layers gather
their detached shards without a backward (a frozen flagship codec still
launches its kernels on the gathered parameters).  As in the JAX package,
such a module cannot run its batch norms in train mode (JAX raises
``ModifyScopeVariableError``; the port raises ``ValueError``).  Disabled modules are identity stubs.
The classifier (``t_pred``, ``t_aux_pred``) and the segmenter (``s_pred``,
``s_aux_pred``) run on the quantized latent ``y_q``, the segmenter with
the decoder's bridges ``fx_brg`` too (JAX ``models/tasks.py:90-104``), in
float32 in both compute modes (``models/classifiers.py``).
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.batchnorm import BatchNorm

ALL_MODULES = ("encoder", "decoder", "fact_ent", "class_model", "seg_model")


def module_runner(model, trainable_modules: Optional[Sequence[str]] = None
                  ) -> Callable:
    """``run(name, *args, **kwargs)``: the model's child ``name`` on the
    arguments, with its parameters detached unless it is trainable."""
    trainable = set(trainable_modules or ())

    def run(name, *args, **kwargs):
        module = getattr(model, name)
        if name in trainable:
            return module(*args, **kwargs)
        frozen = {k: v.detach() for k, v in module.named_parameters()}
        frozen.update(module.named_buffers())
        return torch.func.functional_call(module, frozen, args, kwargs)

    return run


def draw_masks(model, enabled: Sequence[str], batch: int,
               generator: Optional[torch.Generator] = None, device=None
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The dropout keep-masks of one train-mode forward, ``{module: {unit:
    mask}}``, drawn from ``generator`` module by module (encoder, then
    decoder).  Each mask spans every channel of its unit, so under the
    model mesh axis every rank of a model group draws the same ones."""
    return {name: getattr(model, name).draw_masks(batch, generator, device)
            for name in ("encoder", "decoder") if name in enabled}


def fold_batch_stats(model, new_state: Dict[str, Dict[str, torch.Tensor]]
                     ) -> None:
    """Write ``new_state`` (``forward``'s) into the batch norms' buffers
    (under the model mesh axis, the rank's slices: a batch norm records
    its buffers' slice of the new running values)."""
    with torch.no_grad():
        for name, stats in new_state.items():
            buffers = dict(getattr(model, name).named_buffers())
            for key, value in stats.items():
                buffers[key].copy_(value)


def make_forward_fn(model, enabled_modules: Optional[Sequence[str]] = None,
                    trainable_modules: Optional[Sequence[str]] = None,
                    remat: bool = False) -> Callable:
    """Build ``forward(x, train=False, noise=None, generator=None,
    masks=None, compute_dtype=None, rows=None) -> (outputs, new_state)``.

    ``train`` selects the bottleneck's noise quantization (``noise`` or
    draws from ``generator``) over round-to-median, and the batch norms'
    and dropout's train mode.  Train-mode dropout takes ``masks``
    (``draw_masks``' layout), else draws them from ``generator`` before
    anything else runs.  ``compute_dtype`` is the network's compute type
    (None: x's), handed to every layer.  The decoder's input takes the
    latent's dtype, as in the JAX package.  ``rows`` (start, stop, global
    batch) says that ``x`` is those rows of a global batch (a data-parallel
    rank's share): the masks and the noise are then drawn for the global
    batch and sliced (``noise`` and ``masks``, when given, are the
    share's).  ``remat`` recomputes the
    encoder's, the decoder's and the heads' forwards in the backward
    (``torch.utils.checkpoint``), the JAX package's ``jax.checkpoint``: the
    masks and the bottleneck's noise are drawn outside the recomputed
    parts, so the recompute sees the same values."""
    if enabled_modules is None:
        enabled_modules = [m for m in ALL_MODULES if hasattr(model, m)]
    enabled = [m for m in enabled_modules if hasattr(model, m)]
    trainable = set(trainable_modules or ())
    run = module_runner(model, trainable)
    # each module's batch norms, by their names in its state dict
    norms = {name: {m: path for path, m in getattr(model, name)
                    .named_modules() if isinstance(m, BatchNorm)}
             for name in ("encoder", "decoder", "class_model", "seg_model")
             if name in enabled}

    def run_net(name, inp, train, collected, **kwargs):
        if train and norms[name] and name not in trainable:
            raise ValueError(f"{name} is not trainable, so its batch norms "
                             "cannot update their statistics in train mode "
                             "(the JAX package raises "
                             "ModifyScopeVariableError)")
        stats = {} if train and norms[name] else None
        kwargs.update(train=train, batch_stats=stats)
        if remat and train:
            out = checkpoint(run, name, inp, use_reentrant=False,
                             preserve_rng_state=False, **kwargs)
        else:
            out = run(name, inp, **kwargs)
        if stats:
            # recorded by the first forward; a recompute writes the same
            # dict again after this read
            collected[name] = {f"{norms[name][m]}.{k}": v
                               for m, pair in stats.items()
                               for k, v in zip(("mean", "var"), pair)}
        return out

    def forward(x: torch.Tensor, train: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Dict] = None, compute_dtype=None,
                rows: Optional[Tuple[int, int, int]] = None):
        # rows (start, stop, global batch): x is that slice of a global
        # batch, and the masks and the noise drawn here are the global
        # batch's, sliced, so every rank draws what one process would
        start, stop, total = rows or (0, x.shape[0], x.shape[0])
        if train and masks is None:
            masks = draw_masks(model, enabled, total, generator, x.device)
            if rows:
                masks = {m: {u: k[start:stop] for u, k in unit.items()}
                         for m, unit in masks.items()}
        new_state: Dict[str, Dict[str, torch.Tensor]] = {}
        def run_cae(name, inp):
            return run_net(name, inp, train, new_state,
                           compute_dtype=compute_dtype,
                           masks=(masks or {}).get(name))

        y = run_cae("encoder", x) if "encoder" in enabled else x
        if "fact_ent" in enabled:
            if train and noise is None and rows:
                noise = (torch.rand((total,) + tuple(y.shape[1:]),
                                    generator=generator, dtype=y.dtype,
                                    device=y.device) - 0.5)[start:stop]
            y_q, p_y = run("fact_ent", y, training=train, noise=noise,
                           generator=generator)
        else:
            y_q, p_y = y, None
        if "decoder" in enabled:
            x_r, fx_brg = run_cae("decoder", y_q.to(y.dtype))
        else:
            x_r, fx_brg = y_q, None
        t_pred = t_aux_pred = s_pred = s_aux_pred = None
        if "class_model" in enabled:
            t_pred, t_aux_pred = run_net("class_model", y_q, train,
                                         new_state)
        if "seg_model" in enabled:
            s_pred, s_aux_pred = run_net("seg_model", y_q, train, new_state,
                                         fx_brg=fx_brg)
        outputs = dict(x_r=x_r, fx_brg=fx_brg, y=y, y_q=y_q, p_y=p_y,
                       t_pred=t_pred, t_aux_pred=t_aux_pred, s_pred=s_pred,
                       s_aux_pred=s_aux_pred)
        return outputs, new_state

    return forward
