#!/usr/bin/env python3
"""Where the time of the port's slide pipeline goes, on a CUDA card.

    python3 scripts/torch_slide_pipeline.py     # from the root of a checkout

The 4096^2 synthetic slide of ``chip_smoke.py`` phase 7 (4 batches of
16 x 512^2, the flagship checkpoint), for ``cae_tpu`` and ``cae`` in float32
and bf16:

* ``cores, serial``: the cores' ``encode_tiles`` / ``decode_tiles`` on the
  4 batches one after the other on one thread (no store), after a warm-up;
* ``pipeline, W workers``: ``compress_pixels_to_cae_turbo`` /
  ``compress_pixels_to_cae`` and their decoders with
  ``pipeline.tiles.FETCH_WORKERS`` = W (1 and 4), each run three times;
* ``batch reads``: the pipeline's tile reads of the 4 batches alone, on
  the main thread;
* ``device busy``: the device time of the kernels and copies of one
  pipeline compress and one decompress (torch.profiler) over their wall
  time.

Every figure is printed beside the card's name and power limit; the
stores go to ``build/slide_pipeline/`` and are removed at the end.
"""

import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHECKPOINT = os.path.join(ROOT, "benchmarks", "bench_flagship.msgpack")
SLIDE, PATCH, REPS = 4096, 512, 3


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def busy_ms(torch, fn):
    """(device ms, wall ms) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = sum(evt.self_device_time_total for evt in prof.key_averages()
             if evt.device_type == torch.autograd.DeviceType.CUDA
             and evt.key != "Activity Buffer Request")
    return us / 1e3, wall * 1e3


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import synth_histology
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.pipeline import tiles
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore

    tag = card()
    print(tag, f"torch {torch.__version__}", flush=True)
    work = os.path.join(ROOT, "build", "slide_pipeline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    img = synth_histology(SLIDE, SLIDE, seed=0)
    mpix = SLIDE * SLIDE / 1e6
    model = autoencoder_from_state_dict(CHECKPOINT, device="cuda")
    read_tile = tiles._read_tile_fn(img, PATCH)
    grid = tiles._tile_grid(SLIDE, SLIDE, PATCH)
    batch = tiles.default_batch_tiles(PATCH, None, len(grid))
    groups = list(tiles._iter_batches(grid, batch))
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            ms, batches = timed(torch, lambda: [
                tiles._stacked_batch(pool, read_tile, g, batch)
                for g in groups])
        print(f"[{tag}] batch reads: {len(groups)} batches of {batch} on "
              f"the main thread {ms:.1f} ms", flush=True)
        for mode, dtype in (("float32", torch.float32),
                            ("bf16", torch.bfloat16)):
            core = CAETurboCore(model, num_streams=1024, device="cuda",
                                compute_dtype=dtype)
            for codec, c, comp, decomp in (
                    ("cae_tpu", core, tiles.compress_pixels_to_cae_turbo,
                     tiles.decompress_cae_turbo_array),
                    ("cae", core.base, tiles.compress_pixels_to_cae,
                     tiles.decompress_cae_array)):
                label = f"[{tag}] {codec} ({mode})"
                frames = [c.encode_tiles(b) for b in batches]   # warm-up
                [c.decode_tiles(f) for f in frames]
                enc, frames = timed(torch, lambda: [c.encode_tiles(b)
                                                    for b in batches])
                dec, _ = timed(torch, lambda: [c.decode_tiles(f)
                                               for f in frames])
                print(f"{label} cores, serial: encode {mpix / enc * 1e3:.3f}"
                      f" MP/s ({enc:.1f} ms), decode {mpix / dec * 1e3:.3f} "
                      f"MP/s ({dec:.1f} ms)", flush=True)
                path = os.path.join(work, f"{codec}_{mode}.zarr")
                for workers in (1, 4):
                    tiles.FETCH_WORKERS = workers
                    encs, decs = [], []
                    for _ in range(REPS):
                        ms, arr = timed(torch, lambda: comp(
                            c, img, path, patch_size=PATCH))
                        encs.append(ms)
                        ms, _ = timed(torch, lambda: decomp(arr, core=c))
                        decs.append(ms)
                    print(f"{label} pipeline, {workers} workers: encode "
                          + ", ".join(f"{mpix / t * 1e3:.3f}" for t in encs)
                          + " MP/s, decode "
                          + ", ".join(f"{mpix / t * 1e3:.3f}" for t in decs)
                          + " MP/s", flush=True)
                tiles.FETCH_WORKERS = 4
                dev_e, wall_e = busy_ms(torch, lambda: comp(
                    c, img, path, patch_size=PATCH))
                arr = tiles.zarrlib.open(path, device="cuda")["0/0"]
                dev_d, wall_d = busy_ms(torch, lambda: decomp(arr, core=c))
                print(f"{label} device busy under the profiler: compress "
                      f"{dev_e:.1f} of {wall_e:.1f} ms "
                      f"({100 * dev_e / wall_e:.1f} %), decompress "
                      f"{dev_d:.1f} of {wall_d:.1f} ms "
                      f"({100 * dev_d / wall_d:.1f} %)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
