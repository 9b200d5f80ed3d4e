#!/usr/bin/env python3
"""Probe of the raw pixel copies on the card (``utils/staging.py``).

    python3 scripts/torch_staging_probe.py [--seconds 3] [--out DIR]

1. Copies of one 42 x 512² x 3 uint8 batch, host ms a call (median of
   20): pageable ``.to()`` / ``.cpu()`` against ``to_device`` /
   ``to_host``, on an idle card and behind 20 ms of queued kernels; and
   the host copies into and out of a pinned buffer by torch (intra-op
   threads) against numpy (the calling thread), alone and four threads at
   once; and four threads fetching at once.
2. The encode and decode cells of ``portbench`` (seed 1, their own
   traffic) under ``torch.profiler`` for ``--seconds``: device seconds by
   copy kind, the streams the copies and the kernels ran on, and the share
   of the copies' time during which a kernel ran on another stream; and
   the window's link bytes, raw and staged (``GLOBAL_TIMER``), and what
   the pinned pools hold.

Prints one JSON line and writes it to ``--out``/staging_probe.json
(``build/`` by default).  Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPE = (42, 512, 512, 3)


def _median_ms(fn, n=20):
    fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _queue(ms=20.0):
    """Kernels worth about ``ms`` on the current stream (calibrated once)."""
    a = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        a = a @ a.clamp_(-1, 1)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) * 1e3 / 10
    reps = max(1, int(ms / per))

    def fill():
        b = a
        for _ in range(reps):
            b = b @ a
        return b
    return fill


def copies():
    from cnn_autoencoder_tpu_torch.utils.staging import to_device, to_host
    x = np.random.RandomState(0).randint(0, 256, SHAPE).astype(np.uint8)
    t = torch.from_numpy(x).cuda()
    fill = _queue()
    res = {}
    for name, fn in (("h2d_pageable", lambda: torch.from_numpy(x).cuda()),
                     ("h2d_staged", lambda: to_device(x, "cuda")),
                     ("d2h_pageable", lambda: t.cpu().numpy()),
                     ("d2h_staged", lambda: to_host(t))):
        res[name + "_idle_ms"] = _median_ms(fn)

        def loaded(fn=fn):
            fill()
            fn()
        # the host's wait behind 20 ms of queued kernels, and whether the
        # staged upload's result is ready before the queue has run
        res[name + "_queued_ms"] = _median_ms(loaded)
    staged = torch.empty(SHAPE, dtype=torch.uint8, pin_memory=True)
    staged.copy_(t)

    def torch_out():
        out = torch.empty(SHAPE, dtype=torch.uint8)
        out.copy_(staged)
        return out.numpy()

    def numpy_out():
        return np.array(staged.numpy())

    def torch_in():
        staged.copy_(torch.from_numpy(x))

    def numpy_in():
        np.copyto(staged.numpy(), x)

    for name, fn in (("copyout_torch", torch_out),
                     ("copyout_numpy", numpy_out),
                     ("copyin_torch", torch_in),
                     ("copyin_numpy", numpy_in)):
        res[name + "_ms"] = _median_ms(fn)

        def four(fn=fn):
            ts = [threading.Thread(target=fn) for _ in range(4)]
            for th in ts:
                th.start()
            for th in ts:
                th.join()
        res[name + "_4threads_ms"] = _median_ms(four, 10)

    def four_fetch(fetch):
        def run():
            ts = [threading.Thread(target=fetch) for _ in range(4)]
            for th in ts:
                th.start()
            for th in ts:
                th.join()
        return run
    res["d2h_pageable_4threads_ms"] = _median_ms(
        four_fetch(lambda: t.cpu().numpy()), 10)
    res["d2h_staged_4threads_ms"] = _median_ms(
        four_fetch(lambda: to_host(t)), 10)
    np.testing.assert_array_equal(to_host(t), x)
    assert torch.equal(to_device(x, "cuda"), t)
    return res


def _events(prof):
    """(kind, name, stream, start us, end us) of the device's kernels and
    copies, from the profiler's chrome trace (its events carry their
    stream)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = []
    for e in events:
        kind = {"kernel": "kernel", "gpu_memcpy": "copy"}.get(e.get("cat"))
        if kind is None or e.get("ph") != "X":
            continue
        s = float(e["ts"])
        stream = int(e.get("args", {}).get("stream", -1))
        out.append((kind, e["name"], stream, s, s + float(e.get("dur", 0))))
    return out


def _overlap(copies_, kernels):
    """The share of the copies' time during which some kernel ran on
    another stream."""
    import bisect
    total = over = 0.0
    ks = sorted((s, e, st) for _, _, st, s, e in kernels)
    starts = [k[0] for k in ks]
    longest = max((k[1] - k[0] for k in ks), default=0.0)
    for _, _, stream, s, e in copies_:
        total += e - s
        cov = []
        for ks_, ke, kst in ks[bisect.bisect_left(starts, s - longest):]:
            if ks_ >= e:
                break
            if ke > s and kst != stream:
                cov.append((max(s, ks_), min(e, ke)))
        cov.sort()
        end = s
        for a, b in cov:
            if b > end:
                over += b - max(a, end)
                end = b
    return over / total if total else None


def cell(name: str, seconds: float):
    from portbench import run, serving
    from torch.profiler import ProfilerActivity, profile
    from torch._C._profiler import _ExperimentalConfig
    import importlib
    cellj = run.load_json("workloads", name + ".json")
    config = run.load_json("configs", cellj["config"] + ".json")
    traffic = importlib.import_module("portbench.traffic."
                                      + cellj["traffic"])
    from cnn_autoencoder_tpu_torch.utils.profiling import GLOBAL_TIMER
    state = traffic.setup(config, cellj["params"], 1, "cuda")
    torch.cuda.synchronize()
    GLOBAL_TIMER.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        t0 = time.perf_counter()
        out = traffic.run(state, seconds)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    serving.release(state)
    ev = _events(prof)
    cps = [e for e in ev if e[0] == "copy"]
    ks = [e for e in ev if e[0] == "kernel"]
    by_name = {}
    for _, n, st, s, e in cps:
        key = f"{n} (stream {st})"
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    from cnn_autoencoder_tpu_torch.utils.staging import staging
    st = staging("cuda")
    return {"window_s": window, "batches": out["work"]["batches"],
            "link_bytes": GLOBAL_TIMER.link_bytes(),
            "pools": {d: {"buffers": p.buffers, "bytes": p.size}
                      for d, p in (("h2d", st.up), ("d2h", st.down))},
            "rate": out["e2e"],
            "copy_s_by_name_and_stream": by_name,
            "kernel_streams": sorted({e[2] for e in ks}),
            "kernel_s": sum(e[4] - e[3] for e in ks) / 1e6,
            "copy_overlap_share": _overlap(cps, ks)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from portbench import run
    run.prepare_environment(run.load_json("configs", "flagship.json"))
    res = {"device": torch.cuda.get_device_name(0), "copies": copies()}
    for name in ("flagship.encode", "flagship.decode"):
        res[name] = cell(name, args.seconds)
    line = json.dumps(res)
    print(line)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "staging_probe.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
