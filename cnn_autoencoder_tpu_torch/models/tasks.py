"""Forward-pass composition with per-module enable/trainable gating.

Counterpart of the JAX package's ``models/tasks.py:make_forward_fn``: one
``forward`` built from the enabled and trainable module sets, producing the
output dict ``{x_r, fx_brg, y, y_q, p_y, t_pred, t_aux_pred, s_pred,
s_aux_pred}``.  A module that is enabled but not trainable runs with its
parameters detached (``torch.func.functional_call``), the counterpart of the
JAX package's ``stop_gradient`` on its variables: its own parameters get no
gradient, while gradients flow through it to trainable modules upstream.
Disabled modules are identity stubs.  The classifier and segmenter heads
are not ported and raise.
"""

from typing import Callable, Optional, Sequence

import torch

ALL_MODULES = ("encoder", "decoder", "fact_ent", "class_model", "seg_model")
_PORTED = ("encoder", "decoder", "fact_ent")


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


def make_forward_fn(model, enabled_modules: Optional[Sequence[str]] = None,
                    trainable_modules: Optional[Sequence[str]] = None
                    ) -> Callable:
    """Build ``forward(x, train=False, noise=None, generator=None) ->
    outputs``.  ``train`` selects the bottleneck's noise quantization
    (``noise`` or draws from ``generator``) over round-to-median.  The
    decoder's input takes x's dtype, the network's compute type."""
    if enabled_modules is None:
        enabled_modules = [m for m in ALL_MODULES if hasattr(model, m)]
    enabled = [m for m in enabled_modules if hasattr(model, m)]
    for name in enabled:
        if name not in _PORTED:
            raise ValueError(f"module {name} is not ported yet")
    run = module_runner(model, trainable_modules)

    def forward(x: torch.Tensor, train: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        y = run("encoder", x) if "encoder" in enabled else x
        if "fact_ent" in enabled:
            y_q, p_y = run("fact_ent", y, training=train, noise=noise,
                           generator=generator)
        else:
            y_q, p_y = y, None
        if "decoder" in enabled:
            x_r, fx_brg = run("decoder", y_q.to(x.dtype))
        else:
            x_r, fx_brg = y_q, None
        return dict(x_r=x_r, fx_brg=fx_brg, y=y, y_q=y_q, p_y=p_y,
                    t_pred=None, t_aux_pred=None, s_pred=None,
                    s_aux_pred=None)

    return forward
