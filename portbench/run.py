#!/usr/bin/env python3
"""The benchmark of ``cnn_autoencoder_tpu_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

One process runs one cell (``workloads/<cell>.json``): it sets up the
cell's traffic kind (``traffic/<kind>.py``) on its configuration
(``configs/<config>.json``) from the seed, warms up every shape the traffic
uses, measures for ``--seconds``, compares what the timed path produced
with the plain reference (``reference/``) and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (``metrics/<name>.py``), read from a ``torch.profiler``
trace of a window of at most ``TRACE_SECONDS``.  Which metrics a cell
reports is read from ``BENCHMARK.json``.  The last lines on standard error,
and the line's last key ``checks``, give each number compared with its
limit.

It needs the card: without CUDA, or with fewer cards than the cell asks
for, it exits with code 2 and prints no result.  It exits with code 3,
and prints no result, when the process holds JAX or the JAX package once
the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# this file's folder is not a folder of top-level modules (``trace.py``
# would hide the standard library's)
sys.path = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cnn_autoencoder_tpu")
TRACE_SECONDS = 4.0


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def prepare_environment(config) -> None:
    """Before the program is imported: its precision as the configuration
    states it and no other switch of it set; its build and kernel caches
    at fixed paths inside the checkout."""
    for k in [k for k in os.environ if k.startswith("CAE_TPU_")]:
        del os.environ[k]
    os.environ["CAE_TPU_PRECISION"] = config["precision"]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def cell_metrics(bench, cell: str):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    the cell reports."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in names]
    return e2e, layer


def resolve(name: str, have) -> Optional[str]:
    """What a metric is read from: its own name where ``have(name)``, else
    its name less the last ``.part``, and so on (``mfu.train.residual``
    takes the reader ``mfu.train``, ``train_img_per_s.residual`` the
    traffic's ``train_img_per_s``); None where nothing matches."""
    while not have(name):
        if "." not in name:
            return None
        name = name.rsplit(".", 1)[0]
    return name


def reader_path(name: str) -> Optional[str]:
    got = resolve(name, lambda n: os.path.exists(
        os.path.join(HERE, "metrics", n + ".py")))
    return got and os.path.join(HERE, "metrics", got + ".py")


def read_metric(name: str, trace, ctx):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace, ctx)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None, bench=None):
    """Run one cell; returns the result line as a dict (``checks`` last).
    ``overrides`` replaces traffic parameters (tests run small cells on
    the CPU)."""
    cell = load_json("workloads", name + ".json")
    config = load_json("configs", cell["config"] + ".json")
    prepare_environment(config)
    import torch
    from portbench import trace as tr
    bench = bench or load_json(os.pardir, "BENCHMARK.json")
    e2e, layer = cell_metrics(bench, name)
    params = dict(cell["params"], **(overrides or {}))
    traffic = importlib.import_module("portbench.traffic." + cell["traffic"])
    cuda = device == "cuda"
    state = traffic.setup(config, params, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    traces = []
    if trace:
        spans, probe = tr.Spans(), tr.Probe()
        if hasattr(traffic, "trace_spans"):
            traffic.trace_spans(state, spans)
        probe.attach()
        try:
            with tr.profiled(traces, probe):
                out = traffic.run(state, min(seconds, TRACE_SECONDS))
        finally:
            probe.detach()
            spans.detach()
    else:
        out = traffic.run(state, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    numbers = traffic.check(state, out)
    limits = params["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = out["failed"] == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    metrics = {}
    if trace:
        ctx = {"config": config, "params": params, "work": out["work"]}
        for m in layer:
            value = read_metric(m["name"], traces[0], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else out["e2e"][
                resolve(m["name"], lambda n: n in out["e2e"])]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = traces[0].busy_s()
        dev["window_s"] = traces[0].window_s
        result["breakdown"] = traces[0].breakdown()
    result["checks"] = checks
    return result


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = load_json("workloads", args.workload + ".json")["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this process sees {seen}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    print(f"portbench: card {power_limit()}", file=sys.stderr)
    if result["failed"]:
        print(f"portbench: {result['failed']} requests failed",
              file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
