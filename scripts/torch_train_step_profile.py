#!/usr/bin/env python3
"""Profile the port's bare train step on a CUDA card: the device time and
the number of device operations a step, in float32 and bf16.

    python3 scripts/torch_train_step_profile.py [--root DIR] [--model M]
        [--modes float32,bf16] [--top N]

``--root`` is the checkout whose ``cnn_autoencoder_tpu_torch`` is imported
(default: this one), so two commits can be compared on one card: unpack
the other commit into a directory and run parent, change, change, parent,
one process each.  The step is ``chip_smoke.py`` phase 5's: RateMSE at
lambda 0.01, encoder, decoder and factorized entropy trainable, 16 seeded
synthetic patches of 256^2, the noise (and dropout masks) from a seeded
generator.  ``--model flagship`` (the default) trains the flagship
checkpoint of this checkout; ``R`` and ``B`` are ``chip_smoke.py`` phase
10's models at the flagship's widths (``-res``; ``-bn -do 0.1``), built
from seed 0.  After ``--warmup`` steps, ``--steps`` steps run under
``torch.profiler`` and as many again under CUDA events.

Prints one JSON line a mode: ``busy_ms`` (the device time of every kernel
and copy, a step), ``device_ops`` (their count, a step), ``step_ms`` (the
CUDA-event mean of an unprofiled step, which moves with the host), the
card's name and power limit, and the ``--top`` largest rows by device
time (default five), each [ms a step, calls a step, name].
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "benchmarks", "bench_flagship.msgpack")
BATCH, PATCH, LR = 16, 256, 1e-4
OPTIONS = {"R": {"use_residual": True},
           "B": {"batch_norm": True, "dropout": 0.1}}


def synthetic_batch(torch):
    """chip_smoke.py's synthetic patches: uniform 60..220 plus seeded
    noise, in [0, 1]."""
    rng = np.random.RandomState(0)
    x = np.clip(rng.rand(BATCH, PATCH, PATCH, 3) * 160 + 60
                + rng.randn(BATCH, PATCH, PATCH, 3) * 6, 0, 255)
    return torch.from_numpy((x / 255.0).astype(np.float32)).cuda()


def make_model(torch, name):
    from cnn_autoencoder_tpu_torch.models.factory import (
        autoencoder_from_state_dict, build_model)
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    if name == "flagship":
        return autoencoder_from_state_dict(CHECKPOINT, device="cuda").train()
    config = {k: v for k, v in load_checkpoint(CHECKPOINT).items()
              if not isinstance(v, dict)}
    config.update(OPTIONS[name])
    return build_model(config, torch.Generator().manual_seed(0),
                       device="cuda").train()


def make_step(torch, model_name, dtype, x):
    from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
    from cnn_autoencoder_tpu_torch.training.loop import make_train_step
    from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
    model = make_model(torch, model_name)
    trainable = ["encoder", "decoder", "fact_ent"]
    optimizers = setup_optimizers(model, trainable)
    step = make_train_step(model, setup_loss("RateMSE",
                                             distortion_lambda=0.01),
                           optimizers, trainable_modules=trainable,
                           compute_dtype=dtype)
    lrs = {k: LR for k in optimizers}
    gen = torch.Generator(device="cuda").manual_seed(0)
    return lambda i: step(x, lrs, i, generator=gen)


def profile_steps(torch, step, first, n, top_rows):
    """Device time and operation count over ``n`` steps, a step, and the
    ``top_rows`` largest rows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n):
            step(i)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "Activity Buffer Request"]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3 / n
    ops = sum(r[1] for r in rows) / n
    top = [[round(us / 1e3 / n, 4), count / n, key[:80]]
           for us, count, key in rows[:top_rows]]
    return busy, ops, top


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT)
    parser.add_argument("--model", default="flagship",
                        choices=["flagship"] + sorted(OPTIONS))
    parser.add_argument("--label", default="")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--modes", default="float32,bf16")
    parser.add_argument("--top", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("a CUDA card is needed")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    x = synthetic_batch(torch)
    dtypes = {"float32": torch.float32, "bf16": torch.bfloat16}
    for mode in args.modes.split(","):
        step = make_step(torch, args.model, dtypes[mode], x)
        for i in range(1, args.warmup + 1):
            step(i)
        first = args.warmup + 1
        busy, ops, top = profile_steps(torch, step, first, args.steps,
                                       args.top)
        first += args.steps
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(first, first + args.steps):
            step(i)
        end.record()
        end.synchronize()
        print(json.dumps({
            "label": args.label, "root": os.path.abspath(args.root),
            "model": args.model, "mode": mode, "busy_ms": busy,
            "device_ops": ops, "step_ms": start.elapsed_time(end) / args.steps,
            "steps": args.steps,
            "card": card[0] if card else None, "top": top}), flush=True)
        del step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
