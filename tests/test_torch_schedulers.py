"""The port's schedulers (``training/schedulers.py``) and stopping criteria
(``criteria/stopping.py``) against the JAX package's: the same learning
rate trajectories and ``state_dict`` at every step on the same settings and
metric sequence, a resume mid-trajectory from either package's state, and
the same stopping decisions on seeded metric sequences."""

import numpy as np
import pytest

from cnn_autoencoder_tpu.criteria import stopping as jstop
from cnn_autoencoder_tpu.training import schedulers as jsched
from cnn_autoencoder_tpu_torch.criteria import stopping as tstop
from cnn_autoencoder_tpu_torch.training import schedulers as tsched

STEPS = 30
SCHEDULERS = [
    ("StepLR", dict(step_size=4, gamma=0.5)),
    ("ExponentialLR", dict(gamma=0.9)),
    ("LinearLR", dict(start_factor=0.25, end_factor=1.0, total_iters=7)),
    ("CosineAnnealingLR", dict(T_max=6, eta_min=1e-4)),
    ("ReduceLROnPlateau", dict(factor=0.5, patience=2, threshold=1e-3,
                               min_lr=1e-4)),
    ("ReduceLROnPlateau", dict(mode="max", factor=0.3, patience=1)),
]


def _metrics(seed):
    """A noisy, mostly falling loss with plateaus."""
    rng = np.random.RandomState(seed)
    return list(np.maximum.accumulate(rng.rand(STEPS))[::-1]
                + rng.rand(STEPS) * 0.05)


def _walk(module, name, kw, metrics, start=0, state=None):
    """(lrs of both slots, state dicts) after each step from ``start``."""
    lrs = {"encoder": 0.02, "decoder": 0.01}
    sched = module.SCHEDULER_ALGORITHMS[name](lrs, "encoder", **kw)
    if state is not None:
        sched.load_state_dict(state)
    out = []
    for k in range(start, STEPS):
        sched.step(metrics[k] if sched.needs_metrics else None)
        out.append((dict(lrs), sched.state_dict()))
    return out


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_trajectory_and_resume_match_jax(name, kw):
    metrics = _metrics(3)
    jax_walk = _walk(jsched, name, kw, metrics)
    assert _walk(tsched, name, kw, metrics) == jax_walk
    # either package resumes from the other's state at step 11
    for src, dst in ((jsched, tsched), (tsched, jsched)):
        state = _walk(src, name, kw, metrics)[10][1]
        assert _walk(dst, name, kw, metrics, 11, state) == jax_walk[11:]


def _decisions(module, criteria_kw, metrics, every):
    """(early stopping, penalty) decisions of ``setup_stopping_criteria``
    over a run with a validation every ``every`` steps and three penalty
    sub-iterations a step."""
    crit = module.setup_stopping_criteria(**criteria_kw)
    out = []
    for step, metric in enumerate(metrics, start=1):
        early = crit["early_stopping"]
        out.append(("early", early.check(), repr(early)))
        if step % every == 0:
            early.update(iteration=step, metric=metric)
        else:
            early.update(iteration=step)
        if "penalty" in crit:
            pen = crit["penalty"]
            pen.reset()
            for sub in range(1, 4):
                pen.update(iteration=sub, metric=metric * sub)
                out.append(("penalty", pen.check(), repr(pen)))
    return out


@pytest.mark.parametrize("criterion,kw", [
    ("RateMSE", dict(early_patience=3, early_warmup=4)),
    ("RateMSE", dict(early_patience=2, early_warmup=-1, target="max")),
    ("RateMSEPA", dict(early_patience=5, early_warmup=0,
                       energy_limit=0.6)),
    ("RateMSEPB", dict(early_patience=4, early_warmup=2, energy_limit=None,
                       sub_iter_steps=2)),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_stopping_decisions_match_jax(criterion, kw, seed):
    metrics = _metrics(seed)
    criteria_kw = dict(steps=STEPS - 4, criterion=criterion, **kw)
    got = _decisions(tstop, criteria_kw, metrics, every=2)
    assert got == _decisions(jstop, criteria_kw, metrics, every=2)
    assert any(not d for _, d, _ in got)   # something stops in every case


def test_checkpointed_schedulers_hold_numpy_values():
    """A checkpoint gives a scheduler its state as 0-d numpy arrays (and
    None for a plateau scheduler that has seen no metric): the port's
    schedulers load them as the JAX package's do."""
    for module in (jsched, tsched):
        lrs = {"encoder": 0.02}
        s = module.ReduceLROnPlateau(lrs, "encoder", patience=0)
        state = {"epoch": np.asarray(3), "lr": np.asarray(0.005),
                 "base_lr": np.asarray(0.02), "best": np.asarray(0.7),
                 "bad": np.asarray(0)}
        s.load_state_dict(state)
        s.step(0.8)
        assert lrs["encoder"] == pytest.approx(0.0005)
        s.load_state_dict({**state, "best": None})
        s.step(0.8)
        assert lrs["encoder"] == pytest.approx(0.005)
