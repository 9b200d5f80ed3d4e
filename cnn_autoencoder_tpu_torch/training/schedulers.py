"""Host-side learning-rate schedulers.

The port's copy of the JAX package's ``training/schedulers.py``: the train
step takes a ``{slot: lr}`` dict of floats each step, so each scheduler is a
plain Python object that mutates its slot's entry of that shared dict.
Semantics follow torch's schedulers of the same names (ReduceLROnPlateau,
StepLR, LinearLR, ExponentialLR, CosineAnnealingLR); LinearLR also makes the
CLI's early-warmup ramp.  ``state_dict`` / ``load_state_dict`` carry a
scheduler through a checkpoint in the JAX package's layout.
"""

import math
from typing import Dict, Optional


class _Scheduler:
    needs_metrics = False

    def __init__(self, lrs: Dict[str, float], name: str):
        self._lrs = lrs
        self._name = name
        self._base_lr = lrs[name]
        self._epoch = 0

    @property
    def last_lr(self) -> float:
        return self._lrs[self._name]

    def state_dict(self):
        return {"epoch": self._epoch, "lr": self._lrs[self._name],
                "base_lr": self._base_lr}

    def load_state_dict(self, state):
        self._epoch = int(state["epoch"])
        self._base_lr = float(state.get("base_lr", self._base_lr))
        self._lrs[self._name] = float(state["lr"])

    def step(self, metrics: Optional[float] = None):
        self._epoch += 1
        self._update(metrics)

    def _update(self, metrics):
        raise NotImplementedError


class StepLR(_Scheduler):
    def __init__(self, lrs, name, step_size=30, gamma=0.1, **_):
        super().__init__(lrs, name)
        self._step_size = int(step_size)
        self._gamma = float(gamma)

    def _update(self, metrics):
        if self._epoch % self._step_size == 0:
            self._lrs[self._name] *= self._gamma


class ExponentialLR(_Scheduler):
    def __init__(self, lrs, name, gamma=0.95, **_):
        super().__init__(lrs, name)
        self._gamma = float(gamma)

    def _update(self, metrics):
        self._lrs[self._name] *= self._gamma


class LinearLR(_Scheduler):
    """Linear ramp from start_factor to end_factor over total_iters steps."""

    def __init__(self, lrs, name, start_factor=1.0 / 3, end_factor=1.0,
                 total_iters=5, **_):
        super().__init__(lrs, name)
        self._start = float(start_factor)
        self._end = float(end_factor)
        self._total = int(total_iters)
        self._lrs[name] = self._base_lr * self._start

    def _update(self, metrics):
        t = min(self._epoch, self._total)
        factor = self._start + (self._end - self._start) * t / self._total
        self._lrs[self._name] = self._base_lr * factor


class CosineAnnealingLR(_Scheduler):
    def __init__(self, lrs, name, T_max=50, eta_min=0.0, **_):
        super().__init__(lrs, name)
        self._t_max = int(T_max)
        self._eta_min = float(eta_min)

    def _update(self, metrics):
        t = self._epoch % (2 * self._t_max)
        cos = (1 + math.cos(math.pi * t / self._t_max)) / 2
        self._lrs[self._name] = (self._eta_min
                                 + (self._base_lr - self._eta_min) * cos)


class ReduceLROnPlateau(_Scheduler):
    needs_metrics = True

    def __init__(self, lrs, name, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, min_lr=0.0, **_):
        super().__init__(lrs, name)
        self._mode = mode
        self._factor = float(factor)
        self._patience = int(patience)
        self._threshold = float(threshold)
        self._min_lr = float(min_lr)
        self._best = None
        self._bad = 0

    def _is_better(self, metric):
        if self._best is None:
            return True
        if self._mode == "min":
            return metric < self._best * (1 - self._threshold)
        return metric > self._best * (1 + self._threshold)

    def _update(self, metrics):
        if metrics is None:
            return
        if self._is_better(metrics):
            self._best = metrics
            self._bad = 0
        else:
            self._bad += 1
            if self._bad > self._patience:
                self._lrs[self._name] = max(
                    self._lrs[self._name] * self._factor, self._min_lr)
                self._bad = 0

    def state_dict(self):
        s = super().state_dict()
        s.update({"best": self._best, "bad": self._bad})
        return s

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self._best = state.get("best")
        self._bad = int(state.get("bad", 0))


SCHEDULER_ALGORITHMS = {
    "ReduceLROnPlateau": ReduceLROnPlateau,
    "StepLR": StepLR,
    "LinearLR": LinearLR,
    "ExponentialLR": ExponentialLR,
    "CosineAnnealingLR": CosineAnnealingLR,
}
