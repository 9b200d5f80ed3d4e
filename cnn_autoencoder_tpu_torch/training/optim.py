"""Per-module optimizer slots, the aux-parameter split and gradient
accumulation: the JAX package's ``training/optim.py:29-191`` (optax) in
plain PyTorch.

* One slot per trainable module, each with its own algorithm (Adam, AdamW,
  SGD), weight decay and accumulation factor.
* Parameters whose name holds ``quantiles`` or ``aux`` go to a separate
  ``<module>_aux`` slot (the bottleneck's quantiles).
* Per slot, in optax's order: ``clip_by_global_norm(clip_norm)``, then
  Adam's L2 folded into the gradient before the moments (``Adam``), or the
  decay added after the moments (``AdamW``), or the decay alone (``SGD``).
* Gradients accumulate by summation; every ``grad_accumulate`` steps the
  transform runs and the parameters move by ``p - lr * u``, with ``lr`` a
  host-scheduled float per slot.

Parameters and optimizer state are updated in place (the JAX package
returns new trees); nothing else differs.  ``optimizer_state_dict`` /
``load_optimizer_state_dict`` carry a slot's state through a checkpoint in
the layout the JAX CLI writes under ``optimizer_<slot>``: flax's state dict
of the slot's optax chain, the moments as trees of the module's parameters
in the JAX layout (batch norms' ``scale`` and ``bias`` among them; their
running statistics are not parameters and have no slot).
"""

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.weights import state_from_jax, state_to_jax

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ALGORITHMS = ("Adam", "AdamW", "SGD")


def is_aux_name(name: str) -> bool:
    low = name.lower()
    return "quantiles" in low or "aux" in low


@dataclasses.dataclass
class ModuleOptimizer:
    """One optimizer slot: its parameters, its transform's settings and its
    state (Adam's moments and count, the accumulated gradient)."""
    module: str
    params: Dict[str, torch.nn.Parameter]
    algo: str = "Adam"
    weight_decay: float = 0.0
    grad_accumulate: int = 1
    clip_norm: float = 1.0
    count: int = 0
    mu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    acc: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.algo not in ALGORITHMS:
            raise ValueError(f"Unknown optimizer algorithm: {self.algo}")
        for name, p in self.params.items():
            self.acc[name] = torch.zeros_like(p)
            if self.algo != "SGD":
                self.mu[name] = torch.zeros_like(self.acc[name])
                self.nu[name] = torch.zeros_like(self.acc[name])

    def _transform(self, grads: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        u = dict(grads)
        if self.clip_norm and self.clip_norm > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in u.values()))
            keep = g_norm < self.clip_norm
            u = {k: torch.where(keep, g, (g / g_norm) * self.clip_norm)
                 for k, g in u.items()}
        wd = self.weight_decay
        if wd and self.algo in ("Adam", "SGD"):
            u = {k: g + wd * self.params[k] for k, g in u.items()}
        if self.algo in ("Adam", "AdamW"):
            self.count += 1
            # 1 - b**count in float32, as optax computes it
            one, n = np.float32(1), np.float32(self.count)
            c1 = float(one - np.float32(ADAM_B1) ** n)
            c2 = float(one - np.float32(ADAM_B2) ** n)
            for k, g in u.items():
                self.mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[k]
                self.nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[k]
                mu_hat = self.mu[k] / c1
                nu_hat = self.nu[k] / c2
                u[k] = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
        if wd and self.algo == "AdamW":
            u = {k: g + wd * self.params[k] for k, g in u.items()}
        return u

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float,
             step: int) -> None:
        """Add ``grads`` to the accumulator; on an update step run the
        transform and move the parameters by ``-lr * u``."""
        for k in self.params:
            self.acc[k] = self.acc[k] + grads[k]
        if self.grad_accumulate > 1 and step % self.grad_accumulate != 0:
            return
        updates = self._transform(self.acc)
        for k, p in self.params.items():
            p.sub_(lr * updates[k])
            self.acc[k] = torch.zeros_like(self.acc[k])


def setup_optimizers(model, trainable_modules: Sequence[str],
                     mod_optim_algo: Optional[Dict[str, str]] = None,
                     mod_weight_decay: Optional[Dict[str, float]] = None,
                     mod_aux_weight_decay: Optional[Dict[str, float]] = None,
                     mod_grad_accumulate: Optional[Dict[str, int]] = None,
                     clip_norm: float = 1.0) -> Dict[str, ModuleOptimizer]:
    """One slot per trainable module of ``model``, and a ``<module>_aux``
    slot where the module has aux parameters.  Names follow the reference:
    ``encoder``, ``fact_ent``, ``fact_ent_aux``..."""
    algos = mod_optim_algo or {}
    decays = mod_weight_decay or {}
    aux_decays = mod_aux_weight_decay or {}
    accums = mod_grad_accumulate or {}
    slots: Dict[str, ModuleOptimizer] = {}
    for k in trainable_modules:
        if not hasattr(model, k):
            continue
        named = dict(getattr(model, k).named_parameters())
        main = {n: p for n, p in named.items() if not is_aux_name(n)}
        aux = {n: p for n, p in named.items() if is_aux_name(n)}
        common = dict(algo=algos.get(k, "Adam"),
                      grad_accumulate=int(accums.get(k, 1) or 1),
                      clip_norm=clip_norm)
        slots[k] = ModuleOptimizer(k, main,
                                   weight_decay=decays.get(k, 0.0) or 0.0,
                                   **common)
        if aux:
            slots[k + "_aux"] = ModuleOptimizer(
                k, aux, weight_decay=aux_decays.get(k, 0.0) or 0.0, **common)
    return slots


def apply_module_updates(optimizers: Dict[str, ModuleOptimizer],
                         grads: Dict[str, Dict[str, torch.Tensor]],
                         learning_rates: Dict[str, float],
                         step: int) -> None:
    """One optimizer step for every slot; ``grads`` is ``{module: {param
    name: gradient}}``, ``step`` the 1-based step number that accumulation
    counts."""
    for name, slot in optimizers.items():
        slot.step({k: grads[slot.module][k] for k in slot.params},
                  float(learning_rates[name]), step)


def _chain(slot: ModuleOptimizer) -> List[str]:
    """The transforms of the slot's optax chain, in the JAX package's order
    (``training/optim.py:make_transform`` there)."""
    parts = ["clip"] if slot.clip_norm and slot.clip_norm > 0 else []
    decay = ["decay"] if slot.weight_decay else []
    if slot.algo == "AdamW":
        return parts + ["adam"] + decay
    return parts + decay + (["adam"] if slot.algo == "Adam" else [])


def _moment_tree(slot: ModuleOptimizer, moments: Dict[str, torch.Tensor],
                 model) -> Dict:
    """A slot's moments as the JAX tree of its whole module, None at the
    parameters of the module's other slot."""
    names = [n for n, _ in getattr(model, slot.module).named_parameters()]
    flat = {f"{slot.module}.{n}": moments.get(n) for n in names}
    return state_to_jax(flat, model.config)[slot.module]["params"]


def optimizer_state_dict(slot: ModuleOptimizer, model) -> Dict:
    """The slot's state as the JAX CLI saves it: ``{"<i>": state of the i-th
    transform}``, ``{}`` for clipping and weight decay, ``{"count": int32,
    "mu": tree, "nu": tree}`` for Adam's scaling.  Gradients accumulated
    between updates are not part of it, as in the JAX package."""
    out = {}
    for i, part in enumerate(_chain(slot)):
        out[str(i)] = {} if part != "adam" else {
            "count": np.asarray(slot.count, np.int32),
            "mu": _moment_tree(slot, slot.mu, model),
            "nu": _moment_tree(slot, slot.nu, model)}
    return out


def load_optimizer_state_dict(slot: ModuleOptimizer, model,
                              state: Dict) -> None:
    """Restore the slot from ``state`` (``optimizer_state_dict``'s layout,
    as either package writes it)."""
    chain = _chain(slot)
    if set(state) != {str(i) for i in range(len(chain))}:
        raise ValueError(f"optimizer state of {sorted(state)} does not fit "
                         f"the slot's chain {chain}")
    for i, part in enumerate(chain):
        if part != "adam":
            continue
        saved = state[str(i)]
        slot.count = int(saved["count"])
        for key, dst in (("mu", slot.mu), ("nu", slot.nu)):
            flat = state_from_jax({slot.module: {"params": saved[key]}},
                                  model.config)
            for name, p in slot.params.items():
                dst[name] = flat[f"{slot.module}.{name}"].to(p.device)
