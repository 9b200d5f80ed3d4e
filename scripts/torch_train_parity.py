#!/usr/bin/env python3
"""How closely the port's training runs through the kernels follow the same
runs through the plain versions, on a CUDA card.

    python3 scripts/torch_train_parity.py     # from the root of a checkout

The train CLI of ``chip_smoke.py`` phase 9 (the flagship, batch 16 x 256^2
on phase 8's synthetic slides, ``-s 2``: 3 batches), in float32:

* ``MultiscaleRateMSSSIM`` from three starts: color layers from seed 0,
  the same with ``-opt SGD``, and color layers fit by least squares
  (``chip_smoke.multiscale_flagship``).  For each, two runs through the
  kernels and one through the plain versions: the largest relative loss
  difference per step between the kernel runs and against the plain run,
  and between the kernel and plain runs the step-1 gradients' largest
  relative differences by parameter and their sign flips.
* ``RateMSEPA`` and ``RateMSEPB`` (``-ss 3``), ``RUNS`` runs through the
  kernels each: every sub-step's spread over the runs, and for each run
  whose loss leaves the others' median by more than 1e-6 at a sub-step,
  how many of its likelihoods sat at the 1e-9 floor there.

Every figure is printed beside the card's name and power limit; the work
files go to ``build/loss_parity/`` (no "train" or "val" in the path: the
CLI sorts its files by those words) and are removed at the end.
"""

import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RUNS = 6


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def run(torch, cs, work, label, flags, plain=False):
    """(losses, record) of one float32 CLI run."""
    rec = {}
    with cs.step_likelihoods(rec):
        if plain:
            with cs.plain_versions():
                _, losses, _, _, _ = cs.cli_run(
                    torch, work, "float32", label, cs.EC_STEPS, flags, rec)
        else:
            _, losses, _, _, _ = cs.cli_run(
                torch, work, "float32", label, cs.EC_STEPS, flags, rec)
    return losses, rec


def max_rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def gradient_gap(torch, rec, ref):
    """The 4 largest relative norm differences of the step-1 gradients by
    parameter, and the count of differing signs over all of them."""
    gaps, flips, n = [], 0, 0
    for m, gs in rec["grads"].items():
        for k, g in gs.items():
            a, b = g.double(), ref["grads"][m][k].double()
            gaps.append((float((a - b).norm() / b.norm().clamp_min(1e-300)),
                         f"{m}.{k}"))
            flips += int(((a > 0) != (b > 0)).sum())
            n += a.numel()
    gaps.sort(reverse=True)
    return [(f"{r:.2e}", k) for r, k in gaps[:4]], flips, n


def multiscale_starts(torch, cs, work, val_img, tag):
    fitted = ["-chk", cs.multiscale_flagship(torch, work, val_img)]
    for start, extra in (("seed-0 color layers", []),
                         ("seed-0 color layers, SGD", ["-opt", "SGD"]),
                         ("least-squares color layers", fitted)):
        flags = cs.MULTISCALE_FLAGS + extra
        k1, r1 = run(torch, cs, work, "k1", flags)
        k2, _ = run(torch, cs, work, "k2", flags)
        p, rp = run(torch, cs, work, "p", flags, plain=True)
        gaps, flips, n = gradient_gap(torch, r1, rp)
        a, b, floored = cs.off_floor_losses(torch, k1, r1, p, rp)
        print(f"{tag} MultiscaleRateMSSSIM from {start}: losses {k1}, "
              f"plain {p}; kernel runs apart {max_rel(k1, k2):.3e}, kernel "
              f"against plain {max_rel(k1, p):.3e} by step "
              f"{[f'{abs(x - y) / abs(y):.2e}' for x, y in zip(k1, p)]}, "
              f"{max_rel(a, b):.3e} without the {floored} likelihoods at "
              f"the floor in either run; step-1 gradients against plain: "
              f"largest {gaps}, {flips} of {n} signs differ", flush=True)


def floor_events(torch, cs, work, tag):
    floor = torch.tensor(cs.LIKELIHOOD_BOUND, dtype=torch.float32)
    for crit, flags in cs.PENALTY_FLAGS.items():
        runs = [run(torch, cs, work, f"{crit}{i}", ["-cr", crit] + flags)
                for i in range(RUNS)]
        losses = np.array([r[0] for r in runs])
        med = np.median(losses, axis=0)
        dev = np.abs(losses - med) / np.abs(med)
        spikes = []
        for i, j in zip(*np.nonzero(dev > 1e-6)):
            floored = int((runs[i][1]["p_y"][j] <= floor.cuda()).sum())
            spikes.append(f"run {i} sub-step {j}: {dev[i, j]:.2e} off, "
                          f"{floored} likelihoods at the floor")
        spread = (losses.max(0) - losses.min(0)) / np.abs(losses.min(0))
        print(f"{tag} {crit}: {RUNS} runs through the kernels, spread by "
              f"sub-step {[f'{v:.1e}' for v in spread]}; "
              f"{len(spikes)} sub-steps off the median by more than 1e-6: "
              f"{spikes}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_train_parity: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    tag = f"[{card()}]"
    cs.CARD = tag
    work = os.path.join(ROOT, "build", "loss_parity")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        val_img = cs.write_cli_slides(work)
        multiscale_starts(torch, cs, work, val_img, tag)
        floor_events(torch, cs, work, tag)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
