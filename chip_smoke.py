#!/usr/bin/env python3
"""Drive the PyTorch port (``cnn_autoencoder_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build the CUDA kernels from ``cnn_autoencoder_tpu_torch/csrc``
   (ptxas registers, spills and shared memory logged for every
   instantiation), and check in the built library's SASS that K1 (on
   float32 and on bf16 rows), K2, K3 and K4 multiply on the tensor cores
   (HMMA);
   meanwhile build K1's, K2's, K3's, K4's and the rANS kernels' probes
   (``csrc/probes``): K1 with one TF32 pass, the control that must fail
   K1's accuracy check; K1, K2, K3 and K4 without their device-memory
   traffic, to time what the SM spends; K2 and K3 with cycle counts by part
   of a tile; K4 with one pass for its float32 conv and with every mma
   operand in registers; K5 and K6's state pass with clock64 marks around
   their serial loops.
2. Serving kernels: each kernel's wrapper on card tensors at the shapes the
   serving path gives it (16 tiles of 512^2 through the flagship), held
   against its plain PyTorch version on the same inputs, then timed with
   CUDA events beside the plain version and its bound; K1 also at ragged
   rows, every shared-memory layout of its C range and a misaligned row
   pointer, its one-pass control, and its probes' times; K1 on bf16 rows
   at the bf16 round trip's three calls (one bf16 ulp), ragged rows, both
   its layouts and a misaligned row pointer, timed beside cuBLAS's bf16
   product of its shape; K4 in both
   variants and both types at ragged Cin and Cout and at Cout 129 to
   1024, its probes' times, its bf16 serving variant at the round trip's
   shape, and timed at (8, 128, 128, 192) -> 192; K6
   (state pass, compaction) and K5 bit-identical to their plain versions
   at S = 1024, 100, 2048, 3000 and 65535, a peaked table, a 60x60
   plane and 192 channels of 255 values (a table past the state pass's
   shared memory),
   with one state pass compacted at two capacities and whole and cut
   queues, timed at each of these but the peaked table and the plane, and
   their serial chain from the probe.
3. Serving end to end: the flagship checkpoint through ``CAETurboCore``
   (the ``cae_tpu`` codec's batched core), ``encode_tiles`` then
   ``decode_tiles`` on 16 synthetic 512^2 tiles, with launch counts reset
   just before and read just after (K1 3, K4 1, one state pass, one
   compaction per capacity tried, K5 1); then the same tiles through the
   plain versions on the card; then one tile through the ``cae_tpu``
   codec object; then the same tiles through a core of 2048 streams; then
   the device time by operation and the host<->device copies of one more
   round trip (torch.profiler).  Then the decoder's transposed
   convolutions, float32 and bf16, timed three ways (the port's, cuDNN's
   default and cuDNN's deterministic algorithms, the last two timings
   only); then the same round trip in bf16 (a core built with
   ``compute_dtype=torch.bfloat16``), its launches counted on their own
   (K1 on bf16 rows 3, K4 1, K6 and K5 as in float32), symbols lossless,
   the plain versions on the card at bf16 held as in float32, PSNR within
   0.05 dB of the float32 round trip's; three decodes of the same frames
   bit-equal in each precision, with cuDNN's deterministic switch off;
   and the device time by operation of one bf16 round trip.
4. Training kernels: K2, K3 and K4's training variant against their plain
   versions at the training path's shapes (batch 16 of 256^2 through the
   flagship: 262144 and 65536 rows of K2 and K3), float32 and bf16,
   forward and inverse GDN, K2 and K3 also at C = 3, 48, 128, 130, 256 and
   512 with ragged and misaligned rows, K2 at norms below 2^-100; then
   timed by CUDA events (K2's device time beside it), K2 and K3 each beside
   its probes and beside cuBLAS's bf16 product of the same shape (a
   yardstick only).
5. Training end to end: the flagship's RateMSE train step (lambda 0.01,
   encoder, decoder and fact_ent trainable, Adam at lr 1e-4; the
   configuration of ``scripts/bench_train.py``), from the flagship
   checkpoint, on a batch of 16 synthetic 256^2 patches, 3 float32 steps
   and 3 bf16 steps with launch counts reset just before and read just
   after each run; every trainable parameter's step-1 gradient finite and
   non-zero; the same steps with the same noise through the plain versions
   on the card, losses held to the kernels' run; then the step time, an
   eval step and the device time by operation of one more step.
6. Host coder and every CAE codec: (a) build the host rANS library
   (``coding/csrc/rans.cpp``, ``g++``) and hold it byte for byte to the
   plain Python coder on one 64^2 crop's symbols, with and without
   escapes; (b) the 16 flagship 512^2 tiles through ``CAECodecCore`` (the
   ``cae`` codec's core): symbols equal to ``CAETurboCore``'s, lossless
   host coding, reconstructions bit-equal to the turbo decode, encode and
   decode MP/s with the host coder's ms and bytes a tile, in float32 and
   again in bf16 (symbols equal to the bf16 turbo core's, two decodes
   bit-equal, reconstructions bit-equal to its turbo decode); (c) the
   fallbacks to host frames: one symbol out of its table, a flagship copy
   with a scaled encoder, six overflowing capacities at S = 16; (d) one
   decode batch of v4, host and v3 frames and a 500 x 300 tile; (e)
   ``cae_bn`` on one tile's float latent.  Launch counts are reset after
   (b)'s warm-up and read just after its timed round trips, and logged on
   their own: the ``cae`` path launches K1 and K4 and no rANS kernel.
   Nothing sets cuDNN's deterministic switch outside phase 3's timings.
7. One JSON line ``{"kernels": [...]}`` (launches summed over the counted
   runs of phases 3 and 5), then the last line
   ``{"ok": true, "device": {...}}``.

It needs a CUDA card and the repository around it; without either it exits
non-zero and prints no result.
"""

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "benchmarks", "bench_flagship.msgpack")
TILES = 16          # tiles of 512^2 in the serving batch
TRAIN_BATCH, TRAIN_PATCH, TRAIN_STEPS, TRAIN_LR = 16, 256, 3, 1e-4
TIMED_STEPS = 10

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12        # float32 on the CUDA cores (no tensor cores)
PEAK_BF16_S = 989e12      # bf16 on the tensor cores, dense
PEAK_TF32_S = 495e12      # TF32 on the tensor cores, dense
# 32-bit integer operations issue on 64 of the 128 lanes of each SM
# (Hopper white paper): half the float32 rate
PEAK_I32_S = PEAK_F32_S / 2
# K1 against gdn_plain, max relative error: the three-pass kernel reads
# about 1.2e-6 at most, one TF32 pass about 1e-5
K1_REL_LIMIT = 3e-6
# the rANS state pass stages its table (8 bytes an entry, 4 an offset) in
# shared memory up to this size (kEncSmemMax, csrc/rans.cu)
ENC_SMEM_MAX = 200 * 1024
K1_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "gdn_tc_probe.cu")
# K1's probe builds and their defines (csrc/gdn_tc.cu)
K1_PROBES = {"one_pass": ["-DGDN_TC_PASSES=1"],
             "no_io": ["-DGDN_TC_NO_IO=1"],
             "no_io_one_pass": ["-DGDN_TC_NO_IO=1", "-DGDN_TC_PASSES=1"]}
K4_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "conv_gdn_probe.cu")
# K4's probe builds and their defines (csrc/conv_gdn.cu)
K4_PROBES = {"k4_one_pass": ["-DCONV_GDN_PASSES=1"],
             "k4_no_io": ["-DCONV_GDN_NO_IO=1"],
             "k4_no_io_one_pass": ["-DCONV_GDN_NO_IO=1",
                                   "-DCONV_GDN_PASSES=1"],
             "k4_no_io_no_lds": ["-DCONV_GDN_NO_IO=1", "-DCONV_GDN_NO_LDS=1"]}
K2_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "gdn_fwd_probe.cu")
# K2's probe builds and their defines (csrc/gdn_fwd_bf16_tc.cu); all count
# the cycles of each part of a tile
K2_PROBES = {"k2_laps": [], "k2_no_io": ["-DGDN_FWD_NO_IO=1"]}
K3_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                               "probes", "gdn_bwd_probe.cu")
# K3's probe builds and their defines (csrc/gdn_bf16_tc.cu); both count the
# cycles of each part of a tile
K3_PROBES = {"k3_laps": [], "k3_no_io": ["-DGDN_BWD_NO_IO=1"]}
RANS_PROBE_SOURCE = os.path.join(ROOT, "cnn_autoencoder_tpu_torch", "csrc",
                                 "probes", "rans_probe.cu")
PROBES = {}  # probe name -> its loaded library (phase 1)
# K4's edge geometries ((B, H, W, Cin), Cout): ragged Cin and Cout, Cin < 32,
# and Cout past one 128-channel block up to 1024
K4_EDGE_CASES = (((2, 18, 14, 72), 40), ((1, 4, 6, 64), 128),
                 ((1, 2, 2, 3), 5), ((2, 10, 12, 64), 129),
                 ((2, 8, 8, 64), 192), ((1, 8, 8, 128), 256),
                 ((1, 6, 4, 64), 512), ((1, 4, 4, 32), 1024),
                 ((1, 4, 6, 33), 200))

# (name, TPU kernel it replaces)
REPLACES = {
    "gdn_fwd": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:71",
    "gdn_fwd_bf16": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:71",
    "gdn_train_fwd": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:230",
    "gdn_train_bwd": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:279",
    "conv_gdn_fwd": "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "conv_gdn_train_fwd":
        "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "rans_encode_states": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:319",
    "rans_compact": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:319",
    "rans_decode": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:119",
}
SOURCES = {
    "gdn_fwd": "cnn_autoencoder_tpu_torch/csrc/gdn_tc.cu",
    "gdn_fwd_bf16": "cnn_autoencoder_tpu_torch/csrc/gdn_fwd_bf16_tc.cu",
    "gdn_train_fwd": "cnn_autoencoder_tpu_torch/csrc/gdn_fwd_bf16_tc.cu",
    "gdn_train_bwd": "cnn_autoencoder_tpu_torch/csrc/gdn_bf16_tc.cu",
    "conv_gdn_fwd": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "conv_gdn_train_fwd": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "rans_encode_states": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
    "rans_compact": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
    "rans_decode": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
}
# the 'cae' codec's round trip (CAECodecCore), by precision: the model's
# GDN and fused conv + GDN layers, no device rANS
CAE_KERNELS = {"float32": ("gdn_fwd", "conv_gdn_fwd"),
               "bf16": ("gdn_fwd_bf16", "conv_gdn_fwd")}
CAE_ROUNDS = 5      # timed 'cae' round trips in phase 6
# the 'cae_tpu' round trip's kernels by precision; the GDN layers (down_0,
# up_0, up_1) take K1 three times, on float32 or on bf16 rows
SERVING_KERNELS = {"float32": ("gdn_fwd", "conv_gdn_fwd", "rans_encode_states",
                               "rans_compact", "rans_decode"),
                   "bf16": ("gdn_fwd_bf16", "conv_gdn_fwd",
                            "rans_encode_states", "rans_compact",
                            "rans_decode")}
# bf16 serving's PSNR against float32 serving's (tests/test_bf16_rd.py's
# budget)
BF16_PSNR_DB = 0.05
# launches per train step, by compute mode; every other kernel launches 0
STEP_LAUNCHES = {
    "float32": {"gdn_fwd": 3, "conv_gdn_train_fwd": 1},
    "bf16": {"gdn_train_fwd": 3, "gdn_train_bwd": 3, "conv_gdn_train_fwd": 1},
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def bound_ms(nbytes, ops, op_rate=None):
    """(least time in ms, 'bytes' or 'operations').  ``ops`` is a count
    at ``op_rate``, or a list of (count, rate) pairs by operation type."""
    pairs = ops if op_rate is None else [(ops, op_rate)]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, sum(n / r for n, r in pairs)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps):
    """Mean device ms per call of the kernels ``fn`` launches, over ``reps``
    calls after one warm-up (torch.profiler's kernel times): for kernels of
    a few microseconds, CUDA events around the calls would time the
    wrappers' host work instead."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(evt.self_device_time_total for evt in prof.key_averages()
             if evt.device_type == torch.autograd.DeviceType.CUDA
             and evt.key != "Activity Buffer Request")
    return us / reps / 1e3


def image(h, w, seed):
    """Smooth field + seeded noise, after the JAX package's turbo test
    tiles, with the field shifted per seed."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (np.sin(yy / 9.0 + seed) + np.cos(xx / 11.0))[:, :, None] * 55 + 128
    img = img + np.random.RandomState(seed).randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def sample_symbols(tables, ch_map, batch, seed):
    """(B, T, S) int32 symbols drawn from each position's channel table."""
    rng = np.random.RandomState(seed)
    freq = tables.freq.cpu().numpy().astype(np.float64)
    length = tables.length.cpu().numpy()
    offset = tables.offset.cpu().numpy()
    ch = ch_map.cpu().numpy()
    out = np.empty((batch,) + ch.shape, np.int32)
    for c in np.unique(ch):
        p = freq[c, :length[c]] / freq[c, :length[c]].sum()
        sel = ch == c
        out[:, sel] = rng.choice(length[c], size=(batch, int(sel.sum())),
                                 p=p) + offset[c]
    return out


# -- phase 1 -----------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    probes = start_probes(build)
    try:
        build.load_library()
    finally:
        PROBES.update(finish_probes(build, probes))
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds:.1f} s), K1's, K2's, K3's, K4's and the "
        "rANS probes with them")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())
    check_tc_sass(build)


def start_probes(build):
    """Start one nvcc for each of K1's, K2's, K3's, K4's and the rANS
    kernels' probe builds (into build/probes); returns {name: (process,
    library path)}."""
    out = os.path.join(ROOT, "build", "probes")
    os.makedirs(out, exist_ok=True)
    procs = {}
    builds = ([(name, K1_PROBE_SOURCE, d) for name, d in K1_PROBES.items()]
              + [(name, K2_PROBE_SOURCE, d) for name, d in K2_PROBES.items()]
              + [(name, K3_PROBE_SOURCE, d) for name, d in K3_PROBES.items()]
              + [(name, K4_PROBE_SOURCE, d) for name, d in K4_PROBES.items()]
              + [("rans_probe", RANS_PROBE_SOURCE, [])])
    for name, source, defines in builds:
        path = os.path.join(out, f"{name}.so")
        cmd = ([build.cuda_tool()] + build.ARCH_FLAGS
               + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared"]
               + defines + [source, "-o", path])
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path)
    return procs


def finish_probes(build, procs):
    """Wait for every probe build; returns {name: loaded library}."""
    outs = {name: (p.communicate()[0], p.returncode, path)
            for name, (p, path) in procs.items()}
    libs = {}
    for name, (out, rc, path) in outs.items():
        check(rc == 0, f"probe build {name} failed:\n{out}")
        lib = ctypes.CDLL(path)
        if name == "rans_probe":
            for fn in ("cae_rans_encode_states", "cae_rans_decode"):
                getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            lib.cae_rans_probe_read.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                                ctypes.c_int]
            lib.cae_rans_probe_laps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        elif name in K2_PROBES:
            lib.cae_gdn_train_fwd.argtypes = build.SIGNATURES[
                "cae_gdn_train_fwd"]
            lib.cae_gdn_fwd_probe_laps.argtypes = [ctypes.c_void_p]
            lib.cae_gdn_fwd_probe_groups.argtypes = []
        elif name in K3_PROBES:
            lib.cae_gdn_train_bwd.argtypes = build.SIGNATURES[
                "cae_gdn_train_bwd"]
            lib.cae_gdn_bwd_probe_laps.argtypes = [ctypes.c_void_p]
        elif name in K4_PROBES:
            lib.cae_conv_gdn_fwd.argtypes = build.SIGNATURES[
                "cae_conv_gdn_fwd"]
        else:
            lib.cae_gdn_fwd.argtypes = build.SIGNATURES["cae_gdn_fwd"]
            lib.cae_gdn_mma_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p]
            lib.cae_gdn_fwd_layout.argtypes = [ctypes.c_int,
                                               ctypes.c_void_p]
        libs[name] = lib
    return libs


def check_tc_sass(build):
    """K1's, K2's, K3's and K4's instantiations in the built library's SASS
    (cuobjdump), each of which must hold HMMA (tensor-core) instructions."""
    lib = build.load_library()._name
    dump = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, timeout=300)
    check(dump.returncode == 0, f"cuobjdump failed: {dump.stderr.strip()}")
    counts = {"gdn_tc_kernel": {}, "gdn_fwd_tc": {}, "gdn_bwd_tc": {},
              "conv_gdn_mma_kernel": {}}
    without_r = 0  # K1's bf16 instantiations: the template's kWantR false
    for part in dump.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        for kind, found in counts.items():
            if kind in name:
                found[name] = sum(" HMMA." in line
                                  for line in part.splitlines())
                without_r += kind == "gdn_fwd_tc" and "ELb0EE" in name
    check(without_r == 4, f"gdn_fwd_tc: {without_r} instantiations without "
          "r (K1 on bf16 rows), expected 4")
    # K2 and K1 on bf16 rows (gdn_fwd_tc with and without r): resident and
    # streamed layouts, each for GDN and IGDN; K3: its resident and streamed
    # layouts, each for bf16 and float32 g
    for kind, want in (("gdn_tc_kernel", 5), ("gdn_fwd_tc", 8),
                       ("gdn_bwd_tc", 4), ("conv_gdn_mma_kernel", 6)):
        found = counts[kind]
        log(f"{kind} SASS: {len(found)} instantiations, HMMA instructions "
            f"{sorted(found.values())}")
        check(len(found) == want and all(found.values()),
              f"{kind} SASS lacks HMMA: {found}")


# -- phase 2 -----------------------------------------------------------------


def edge_geometries(torch, rng):
    """GDN and conv+GDN at small ragged shapes (rows and channels that fill
    no tile), and what the conv+GDN kernel refuses."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (conv_gdn_kernel,
                                                       gdn_kernel)

    def params(c):
        gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32))
        beta = torch.from_numpy((1.0 + rng.rand(c)).astype(np.float32))
        return gamma.cuda(), beta.cuda()

    # K1: ragged rows and channels; C = 136, 256, 500, 1000, 1552, 1553
    # and 2048 take each shared-memory layout of csrc/gdn_tc.cu (gamma
    # resident or streamed, 64- or 32-row tiles, double- or
    # single-buffered, x in K-slices); the last case has rows 4 bytes off
    # 16-byte alignment (4-byte copies)
    for n, c in ((1000, 48), (77, 130), (5, 3), (300, 136), (300, 256),
                 (100, 500), (70, 1000), (33, 1552), (67, 1553),
                 (100, 2048), (131, 128)):
        x = torch.from_numpy(rng.randn(n * c + 1).astype(np.float32)).cuda()
        x = x[1:].view(n, c) if (n, c) == (131, 128) else x[:-1].view(n, c)
        gamma, beta = params(c)
        rels = []
        for inverse in (False, True):
            got = gdn_kernel.gdn_cuda(x, gamma, beta, inverse)
            ref = gdn_kernel.gdn_plain(x, gamma, beta, inverse)
            rels.append(float(((got - ref).abs()
                               / ref.abs().clamp_min(1e-30)).max()))
            check(rels[-1] <= K1_REL_LIMIT, f"gdn_fwd ({n}, {c}) "
                  f"inverse={inverse}: max relative error {rels[-1]:.3e}")
        log(f"gdn_fwd ({n}, {c}): max rel {rels[0]:.3e} / {rels[1]:.3e} "
            f"(GDN / IGDN); layout {k1_layout(c)}")
    bad = k1_root_mismatches(torch)
    log(f"gdn_fwd epilogue roots against sqrtf and 1.0f / s over every "
        f"positive float32 in range: {bad[0]} and {bad[1]} mismatches")
    check(bad == (0, 0), f"gdn_fwd epilogue roots: {bad} mismatches")
    # K4: ragged Cin and Cout, and Cout past one 128-channel block (the
    # layout that passes y through device memory), both variants and types
    for shape, cout in K4_EDGE_CASES:
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
        kernel = torch.from_numpy((rng.randn(3, 3, shape[3], cout) * 0.05)
                                  .astype(np.float32)).cuda()
        gamma, beta = params(cout)
        for dt in (torch.float32, torch.bfloat16):
            check_conv_case(torch, x.to(dt), kernel, gamma, beta,
                            f"{shape} -> {cout} {str(dt)[6:]}")
    x = torch.zeros((1, 5, 4, 64), device="cuda")
    gamma, beta = params(64)
    try:
        conv_gdn_kernel.conv_gdn_cuda(
            x, torch.zeros((3, 3, 64, 64), device="cuda"), gamma, beta)
        raise SmokeError("conv_gdn_fwd took odd H")
    except ValueError:
        pass
    torch.cuda.synchronize()
    log("gdn_fwd and conv_gdn_fwd agree with their plain versions at ragged "
        "shapes, conv_gdn_fwd and conv_gdn_train_fwd up to Cout = 1024 in "
        "float32 and bf16; conv_gdn_fwd refuses odd H")


def k1_layout(c):
    """The layout K1 takes for c channels, from its launch plan
    (csrc/probes/gdn_tc_probe.cu:cae_gdn_fwd_layout)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    out = (ctypes.c_int * 7)()
    build.check_launch(PROBES["one_pass"].cae_gdn_fwd_layout(
        c, ctypes.addressof(out)), "gdn_fwd layout")
    return dict(zip(("groups", "rows", "gamma_resident", "x_sliced",
                     "x_buffers", "smem_bytes", "most_blocks"), out))


def k1_probe(torch, name, x, gamma, beta, inverse, out):
    """K1 as the probe build ``name`` computes it, into ``out``."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    n, c = x.shape
    build.check_launch(PROBES[name].cae_gdn_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), n,
        c, int(inverse), torch.cuda.current_stream().cuda_stream), name)
    return out


def k1_root_mismatches(torch):
    """Over every positive float32 value in K1's fast range: how many give
    an epilogue square root, and a reciprocal of it, other than sqrtf and
    1.0f / s (csrc/gdn_tc.cu:cae_gdn_root_check)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    bad = torch.zeros(2, dtype=torch.int64, device="cuda")
    build.check_launch(build.load_library().cae_gdn_root_check(
        0, 1 << 31, bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "gdn_fwd root check")
    return tuple(bad.tolist())


def mma_tf32_tflops(torch):
    """TFLOP/s of the mma.sync TF32 products K1 issues, with one 8-warp
    block per SM as K1 runs (csrc/probes/gdn_tc_probe.cu:
    cae_gdn_mma_probe): the ceiling of its three passes on this card."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    lib = PROBES["one_pass"]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    iters = 4096
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        build.check_launch(lib.cae_gdn_mma_probe(out.data_ptr(), blocks,
                                                 iters, stream), "mma probe")
    ms = cuda_ms(torch, run, 3)
    return blocks * 8 * iters * 8 * (2 * 16 * 8 * 8) / ms / 1e9


def k1_serving(torch, model, b, h, w, rng):
    """K1 at the round trip's shapes with the flagship's parameters: down_0
    (GDN) and up_1 (IGDN) over (B 256^2, 128) rows, up_0 (IGDN) over
    (B 128^2, 128); each against its plain version and against the
    one-pass control, down_0 and up_0 timed, down_0 beside K1's probes.
    Returns down_0's record."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel
    rows = b * (h // 2) * (w // 2)
    rec = None
    mma_tflops = mma_tf32_tflops(torch)
    log(f"mma.sync TF32 on this card: {mma_tflops:.1f} TFLOP/s (one 8-warp "
        "block per SM)")
    with torch.no_grad():
        for inverse, unit, n in ((False, model.encoder.down_0, rows),
                                 (True, model.decoder.up_1, rows),
                                 (True, model.decoder.up_0, rows // 4)):
            mod = unit.gdn_up if inverse else unit.gdn_down
            gamma, beta = mod.effective_params()
            c = gamma.shape[0]
            x = torch.from_numpy(rng.randn(n, c).astype(np.float32)
                                 * 0.5).cuda()
            got = gdn_kernel.gdn_cuda(x, gamma, beta, inverse)
            ref = gdn_kernel.gdn_plain(x, gamma, beta, inverse)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "gdn_fwd: non-finite")
            err = (got - ref).abs()
            rel = float((err / ref.abs().clamp_min(1e-30)).max())
            # the one-pass control must fail the limit the kernel holds
            gamma, beta = gamma.detach().contiguous(), beta.detach()
            one = k1_probe(torch, "one_pass", x, gamma, beta, inverse,
                           torch.empty_like(x))
            rel_one = float(((one - ref).abs()
                             / ref.abs().clamp_min(1e-30)).max())
            del one
            log(f"gdn_fwd inverse={inverse} {tuple(x.shape)}: max abs "
                f"{float(err.max()):.3e} max rel {rel:.3e}; one-pass "
                f"control max rel {rel_one:.3e} (limit {K1_REL_LIMIT:.0e})")
            check(rel <= K1_REL_LIMIT, f"gdn_fwd inverse={inverse}: max "
                  f"relative error {rel:.3e} > {K1_REL_LIMIT:.0e}")
            check(rel_one > K1_REL_LIMIT, f"gdn_fwd inverse={inverse}: the "
                  f"one-pass control passed ({rel_one:.3e})")
            if unit is model.decoder.up_1:
                continue
            ms = cuda_ms(torch, lambda: gdn_kernel.gdn_cuda(
                x, gamma, beta, inverse), 20)
            plain_ms = cuda_ms(torch, lambda: gdn_kernel.gdn_plain(
                x, gamma, beta, inverse), 10)
            nbytes = 8 * n * c + 4 * c * (c + 1)
            # the pool as three TF32 passes, the rest in float32
            bms, by = bound_ms(nbytes, [(3 * 2 * n * c * c, PEAK_TF32_S),
                                        (5 * n * c, PEAK_F32_S)])
            log(f"gdn_fwd {(n, c)} inverse={inverse}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms; bytes bound "
                f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms, three-pass TF32 "
                f"operations {6 * n * c * c / PEAK_TF32_S * 1e3:.4f} ms, "
                f"bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of it; "
                "the three passes at the mma.sync rate "
                f"{6 * n * c * c / mma_tflops / 1e9:.4f} ms; "
                "the earlier CUDA-core design's float32 ceiling "
                f"{n * c * (2 * c + 5) / PEAK_F32_S * 1e3:.4f} ms; layout "
                f"{k1_layout(c)}")
            if not inverse:
                k1_probe_times(torch, x, gamma, beta, ms)
                rec = dict(max_abs_err=float(err.max()), ms=ms,
                           plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           shape=list(x.shape))
            del x, got, ref, err
    return rec


def k1_probe_times(torch, x, gamma, beta, ms):
    """K1's time split by its probes at x's shape (GDN): one TF32 pass,
    and both pass counts without x's and y's device-memory traffic, beside
    a device copy of x (the bytes K1 moves)."""
    out = torch.empty_like(x)
    t = {name: cuda_ms(torch, lambda: k1_probe(torch, name, x, gamma, beta,
                                               False, out), 20)
         for name in K1_PROBES}
    copy_ms = cuda_ms(torch, lambda: out.copy_(x), 20)
    two_low = t["no_io"] - t["no_io_one_pass"]
    log(f"gdn_fwd {tuple(x.shape)} probes: kernel {ms:.4f} ms, one pass "
        f"{t['one_pass']:.4f} ms; without device-memory traffic "
        f"{t['no_io']:.4f} ms (three passes), {t['no_io_one_pass']:.4f} ms "
        f"(one pass); a device copy of x {copy_ms:.4f} ms. In the SM: the "
        f"two low passes {two_low:.4f} ms, so three passes about "
        f"{1.5 * two_low:.4f} ms and the rest (x^2 split, fragment loads, "
        f"epilogue, barriers) about {t['no_io'] - 1.5 * two_low:.4f} ms")


def k1_bf16_bound(n, c):
    """K1 on bf16 rows: its bytes (x in and y out, 2 bytes each, and the
    float32 parameters) against its operations (the pool in one bf16
    pass at the bf16 rate, five float32 operations an element after it)."""
    return bound_ms(4 * n * c + 4 * c * (c + 1),
                    [(2 * n * c * c, PEAK_BF16_S), (5 * n * c, PEAK_F32_S)])


def k1_bf16_edges(torch, rng):
    """K1 on bf16 rows against gdn_plain (one bf16 ulp) at ragged rows,
    every shared-memory layout of its C range (gamma resident for C <= 128,
    streamed in 64-deep slices above) and rows one element past a 16-byte
    boundary (staged element by element)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    for n, c in ((1000, 48), (77, 130), (5, 3), (9, 128), (300, 256),
                 (33, 512), (131, 128)):
        buf = torch.from_numpy(rng.randn(n * c + 8).astype(np.float32))
        buf = buf.cuda().to(torch.bfloat16)
        misaligned = (n, c) == (131, 128)
        x = buf[1:1 + n * c] if misaligned else buf[:n * c]
        x = x.view(n, c)
        check(not misaligned or x.data_ptr() % 16 != 0,
              "misaligned K1 bf16 case: the view is aligned")
        gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32))
        beta = torch.from_numpy((1.0 + rng.rand(c)).astype(np.float32))
        gamma, beta = gamma.cuda(), beta.cuda()
        for inverse in (False, True):
            got = gk.gdn_cuda(x, gamma, beta, inverse)
            ref = gk.gdn_plain(x, gamma, beta, inverse)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16
                  and bool(torch.isfinite(got.float()).all())
                  and bf16_ulps(got, ref) <= 1,
                  f"gdn_fwd_bf16 ({n}, {c}) inverse={inverse}: more than "
                  "one bf16 ulp from gdn_plain")
    log("gdn_fwd_bf16 within one bf16 ulp of gdn_plain at (1000, 48), "
        "(77, 130), (5, 3), (9, 128), (300, 256), (33, 512) and misaligned "
        "(131, 128) rows, GDN and IGDN")


def k1_bf16_serving(torch, model, b, h, w):
    """K1 on bf16 rows at the bf16 round trip's three calls with the
    flagship's parameters: down_0 (GDN) and up_1 (IGDN) over (B 256^2,
    128) rows, up_0 (IGDN) over (B 128^2, 128); each within one bf16 ulp of
    gdn_plain and timed by CUDA events beside it, its bound and cuBLAS's
    bf16 (N, C) @ (C, C) product (a yardstick).  Returns down_0's
    record."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = b * (h // 2) * (w // 2)
    rec, total_ms, total_bms = None, 0.0, 0.0
    with torch.no_grad():
        for inverse, unit, n in ((False, model.encoder.down_0, rows),
                                 (True, model.decoder.up_1, rows),
                                 (True, model.decoder.up_0, rows // 4)):
            mod = unit.gdn_up if inverse else unit.gdn_down
            gamma, beta = (t.detach() for t in mod.effective_params())
            c = gamma.shape[0]
            x = (0.5 * torch.randn(n, c, device="cuda", generator=gen)
                 ).to(torch.bfloat16)
            got = gk.gdn_cuda(x, gamma, beta, inverse)
            ref = gk.gdn_plain(x, gamma, beta, inverse)
            torch.cuda.synchronize()
            ulps = bf16_ulps(got, ref)
            err = float((got.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()) and ulps <= 1,
                  f"gdn_fwd_bf16 inverse={inverse} ({n}, {c}): {ulps} bf16 "
                  "ulps from gdn_plain")
            ms = cuda_ms(torch, lambda: gk.gdn_cuda(x, gamma, beta, inverse),
                         20)
            plain_ms = cuda_ms(torch, lambda: gk.gdn_plain(
                x, gamma, beta, inverse), 10)
            gb = gamma.to(torch.bfloat16)
            mm_ms = cuda_ms(torch, lambda: torch.matmul(x, gb), 20)
            bms, by = k1_bf16_bound(n, c)
            total_ms += ms
            total_bms += bms
            log(f"gdn_fwd_bf16 inverse={inverse} ({n}, {c}): {ulps} ulp, max "
                f"abs {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of "
                f"it; cuBLAS bf16 ({n}, {c}) @ ({c}, {c}) alone {mm_ms:.4f} "
                "ms (a yardstick)")
            if rec is None:
                rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, shape=[n, c])
            del x, got, ref
    log(f"gdn_fwd_bf16: the bf16 round trip's three calls {total_ms:.4f} ms "
        f"against their bound {total_bms:.4f} ms")
    return rec


def k4_bound(x, cout, want_y):
    """K4's bound at x's shape: its bytes (x, out in x's type, y in float32
    where wanted, the parameters) against its operations at the card's rate
    for their type: three TF32 passes for each float32 product, the bf16
    conv's products at the bf16 rate, the pool (float32 y^2) in three TF32
    passes in both types, and five float32 operations an output in the
    epilogue.  Returns (bound ms, what bounds it, design ms): the last is
    the operations as the design issues them (the bf16 conv in one TF32
    pass), its ceiling."""
    import torch
    b, h, w, cin = x.shape
    npix = b * (h // 2) * (w // 2)
    size = x.element_size()
    conv_ops = npix * 2 * 9 * cin * cout
    pool_ops = npix * 2 * cout * cout
    epilogue = (5 * npix * cout, PEAK_F32_S)
    if x.dtype == torch.bfloat16:
        conv, conv_tf32 = (conv_ops, PEAK_BF16_S), conv_ops
    else:
        conv, conv_tf32 = (3 * conv_ops, PEAK_TF32_S), 3 * conv_ops
    nbytes = (size * (x.numel() + npix * cout) + 4 * npix * cout * want_y
              + 4 * (9 * cin * cout + cout * (cout + 1)))
    bms, by = bound_ms(nbytes, [conv, (3 * pool_ops, PEAK_TF32_S), epilogue])
    design_ms = ((conv_tf32 + 3 * pool_ops) / PEAK_TF32_S
                 + epilogue[0] / PEAK_F32_S) * 1e3
    return bms, by, design_ms


def k4_probe_times(torch, x, kernel, gamma, beta, ms):
    """K4's serving time split by its probes at x's shape (float32): one
    TF32 pass for the conv, and both pass counts without the copies into
    the ring, beside a device copy of x and the three passes' time at the
    mma.sync rate.  The one-pass build is also the control of K4's
    accuracy limits: its out and y must fail the 1e-4 of max |out| and of
    max |y| that the kernel holds."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    kernel, gamma, beta = (t.detach().float().contiguous()
                           for t in (kernel, gamma, beta))
    npix = b * (h // 2) * (w // 2)
    work = torch.empty(build.load_library().cae_conv_gdn_workspace(
        npix, cin, cout, 0, 1), dtype=torch.uint8, device="cuda")
    out = torch.empty((b, h // 2, w // 2, cout), device="cuda")
    y = torch.empty_like(out)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, y_ptr=None):
        build.check_launch(PROBES[name].cae_conv_gdn_fwd(
            x.data_ptr(), kernel.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), y_ptr, work.data_ptr(), b, h, w,
            cin, cout, 0, stream), name)

    run("k4_one_pass", y.data_ptr())
    out_p, y_p = cg.conv_gdn_train_plain(x, kernel, gamma, beta)
    torch.cuda.synchronize()
    ok_o, o_err = close(out, out_p, 0.0, 1e-4)
    ok_y, y_err = close(y, y_p, 0.0, 1e-4)
    log(f"conv_gdn_fwd {tuple(x.shape)} one-pass control: out max abs "
        f"{o_err:.3e} (limit {1e-4 * float(out_p.abs().max()):.3e}), y max "
        f"abs {y_err:.3e} (limit {1e-4 * float(y_p.abs().max()):.3e})")
    check(not ok_o and not ok_y, "conv_gdn_fwd: the one-pass control passes "
          "K4's limits, which then cannot tell three passes from one")
    del out_p, y_p, y
    t = {name: cuda_ms(torch, lambda: run(name), 10) for name in K4_PROBES}
    copy_ms = cuda_ms(torch, lambda: torch.empty_like(x).copy_(x), 10)
    passes = 3 * npix * 2 * cout * (9 * cin + cout)
    two_low = t["k4_no_io"] - t["k4_no_io_one_pass"]
    log(f"conv_gdn_fwd {tuple(x.shape)} probes: kernel {ms:.4f} ms, one "
        f"pass {t['k4_one_pass']:.4f} ms; without copies into the ring "
        f"{t['k4_no_io']:.4f} ms (three passes), "
        f"{t['k4_no_io_one_pass']:.4f} ms (one pass); a device copy of x "
        f"{copy_ms:.4f} ms; without copies or fragment loads (operands in "
        f"registers) {t['k4_no_io_no_lds']:.4f} ms; the three passes at the "
        f"mma.sync rate {passes / mma_tf32_tflops(torch) / 1e9:.4f} ms. "
        "In the SM: "
        f"the conv's two low passes and x's split {two_low:.4f} ms, the "
        f"fragment loads and splits "
        f"{t['k4_no_io'] - t['k4_no_io_no_lds']:.4f} ms; the copies' share "
        f"{ms - t['k4_no_io']:.4f} ms")


def k4_wide_time(torch, rng):
    """K4's serving variant at a Cout past one 128-channel block, (8, 128,
    128, 192) -> 192 float32 (y passes through device memory), against its
    plain version, timed."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    cin = cout = 192
    x = torch.from_numpy(rng.rand(8, 128, 128, cin).astype(np.float32)).cuda()
    kernel = torch.from_numpy((rng.randn(3, 3, cin, cout) * 0.03)
                              .astype(np.float32)).cuda()
    gamma = torch.from_numpy((0.01 * rng.rand(cout, cout))
                             .astype(np.float32)).cuda()
    beta = torch.from_numpy((1.0 + rng.rand(cout)).astype(np.float32)).cuda()
    got = cg.conv_gdn_cuda(x, kernel, gamma, beta)
    ref = cg.conv_gdn_plain(x, kernel, gamma, beta)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(err <= 1e-4 * scale, f"conv_gdn_fwd {tuple(x.shape)} -> {cout}: "
          f"error {err:.3e} above 1e-4 max|out|")
    ms = cuda_ms(torch, lambda: cg.conv_gdn_cuda(x, kernel, gamma, beta), 10)
    plain_ms = cuda_ms(torch, lambda: cg.conv_gdn_plain(
        x, kernel, gamma, beta), 5)
    bms, by, _ = k4_bound(x, cout, want_y=False)
    log(f"conv_gdn_fwd {tuple(x.shape)} -> {cout} float32: max abs "
        f"{err:.3e} (max|out| {scale:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{100 * bms / ms:.1f}% of it")


def phase_kernels(torch, model, core, tiles):
    """Every kernel against its plain version at the serving path's shapes;
    returns {name: record}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    b, h, w = tiles, 512, 512
    out = {}
    edge_geometries(torch, rng)

    out["gdn_fwd"] = k1_serving(torch, model, b, h, w, rng)
    k1_bf16_edges(torch, rng)
    out["gdn_fwd_bf16"] = k1_bf16_serving(torch, model, b, h, w)

    # K4: reflect pad + 3x3/s2 conv + GDN, flagship down_1: (B, 256, 256,
    # 128) -> (B, 128, 128, 128)
    with torch.no_grad():
        unit = model.encoder.down_1
        kernel = unit.conv_down.kernel_hwio()
        gamma, beta = unit.gdn_down.effective_params()
        cin, cout = kernel.shape[2], kernel.shape[3]
        x = torch.from_numpy(rng.rand(b, h // 2, w // 2, cin)
                             .astype(np.float32)).to(dev)
        got = conv_gdn_kernel.conv_gdn_cuda(x, kernel, gamma, beta)
        ref = conv_gdn_kernel.conv_gdn_plain(x, kernel, gamma, beta)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (b, h // 4, w // 4, cout),
              f"conv_gdn_fwd: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "conv_gdn_fwd: non-finite")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"conv_gdn_fwd {tuple(x.shape)} -> {tuple(got.shape)}: max abs "
            f"{err:.3e} (tolerance 1e-4 * max|out| = {1e-4 * scale:.3e})")
        check(err <= 1e-4 * scale, "conv_gdn_fwd: error above 1e-4 max|out|")
        ms = cuda_ms(torch, lambda: conv_gdn_kernel.conv_gdn_cuda(
            x, kernel, gamma, beta), 10)
        plain_ms = cuda_ms(torch, lambda: conv_gdn_kernel.conv_gdn_plain(
            x, kernel, gamma, beta), 5)
        bms, by, _ = k4_bound(x, cout, want_y=False)
        log(f"conv_gdn_fwd {tuple(x.shape)} -> {cout} float32: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), {100 * bms / ms:.1f}% of it")
        out["conv_gdn_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bms, bound_by=by,
                                   shape=list(x.shape))
        k4_probe_times(torch, x, kernel, gamma, beta, ms)
        # the bf16 serving variant, which the bf16 round trip launches
        xb = x.to(torch.bfloat16)
        check_conv_case(torch, xb, kernel, gamma, beta,
                        f"{tuple(x.shape)} -> {cout} bf16")
        ms_b = cuda_ms(torch, lambda: conv_gdn_kernel.conv_gdn_cuda(
            xb, kernel, gamma, beta), 10)
        bms_b, by_b, design_b = k4_bound(xb, cout, want_y=False)
        log(f"conv_gdn_fwd {tuple(x.shape)} -> {cout} bf16: kernel "
            f"{ms_b:.4f} ms, bound {bms_b:.4f} ms ({by_b}), "
            f"{100 * bms_b / ms_b:.1f}% of it; the design's one-pass TF32 "
            f"ceiling {design_b:.4f} ms")
        del x, xb, got, ref
        k4_wide_time(torch, rng)

    out.update(rans_kernels(torch, core, b))
    for name, rec in out.items():
        log(f"{name} {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    return out


def rans_cases(torch, core, b, rng):
    """(label, symbols (B, T, S), channel map (T, S), tables) of the rANS
    checks, symbols drawn from each position's channel table: the serving
    geometry (latent 64x64x48, S = 1024: T = 192, B tiles), a peaked table
    (freq > 2^11, states above 2^31), a 60x60 plane (not a multiple of S:
    steps that span two channels), 100 streams, and the serving latent at
    more than 1024 streams: 2048, 3000 (not a multiple of 32; steps span
    channels) and 65535 (the frame's largest S, 16 channels a step); and
    192 channels of 255 values at S = 1024 (the state pass's unstaged
    table)."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import (
        DeviceTables, pack_streams, stream_channel_map)
    dev = torch.device("cuda")
    tables = core.tables
    s = core.num_streams

    def drawn(cmap, batch, seed):
        return torch.from_numpy(sample_symbols(tables, cmap, batch,
                                               seed)).to(dev)

    ch_map = core._ch_map(64, 64, s)
    cases = [("flagship 64x64", drawn(ch_map, b, 1), ch_map, tables)]
    freq = torch.tensor([[3968, 64, 32, 32]], dtype=torch.int32)
    peaked = DeviceTables(
        freq=freq, start=torch.tensor([[0, 3968, 4032, 4064]],
                                      dtype=torch.int32),
        slot=torch.repeat_interleave(torch.arange(4, dtype=torch.int32),
                                     freq[0].long())[None],
        offset=torch.tensor([-1], dtype=torch.int32),
        length=torch.tensor([4], dtype=torch.int32), support=4).to(dev)
    pk_map = torch.zeros((64, s), dtype=torch.int32, device=dev)
    pk_sym = torch.from_numpy(rng.randint(0, 4, (4, 64, s)).astype(np.int32)
                              - 1).to(dev)
    cases.append(("peaked freq 3968", pk_sym, pk_map, peaked))
    odd_map = core._ch_map(60, 60, s)
    n_odd = tables.freq.shape[0] * 60 * 60
    odd = sample_symbols(tables, odd_map, 4, 2).reshape(4, -1)[:, :n_odd]
    check(bool((odd_map != odd_map[:, :1]).any()),
          "the 60x60 geometry should have multi-channel steps")
    cases.append(("plane 60x60 (not a multiple of S)",
                  pack_streams(torch.from_numpy(odd), s).to(dev), odd_map,
                  tables))
    s100_map = torch.from_numpy(stream_channel_map(48, (8, 8), 100)).to(dev)
    cases.append(("100 streams", drawn(s100_map, 3, 3), s100_map, tables))
    for streams, batch in ((2048, 4), (3000, 4), (65535, 2)):
        cmap = torch.from_numpy(stream_channel_map(48, (64, 64),
                                                   streams)).to(dev)
        cases.append((f"{streams} streams 64x64", drawn(cmap, batch, streams),
                      cmap, tables))
    # 192 channels (the factory's default channels_bn) whose tables reach
    # 255 values: the flagship's tables four times over, widened from its
    # support to 255 columns by an entry no symbol takes; past ENC_SMEM_MAX
    # staged bytes, so the state pass reads its table from device memory
    def widen(a, value):
        a = a.repeat(4, 1)
        return torch.cat([a, torch.full((a.shape[0], 255 - a.shape[1]),
                                        value, dtype=a.dtype,
                                        device=a.device)], dim=1)

    wide = DeviceTables(
        freq=widen(tables.freq, 1), start=widen(tables.start, 4095),
        slot=tables.slot.repeat(4, 1), offset=tables.offset.repeat(4),
        length=tables.length.repeat(4), support=255)
    check(wide.freq.numel() * 8 + wide.offset.numel() * 4 > ENC_SMEM_MAX,
          "the 192-channel table should exceed the state pass's staging")
    cmap = torch.from_numpy(stream_channel_map(192, (64, 64), s)).to(dev)
    cases.append(("192 channels 64x64", torch.from_numpy(sample_symbols(
        wide, cmap, 2, 5)).to(dev), cmap, wide))
    return cases


def u16_equal(torch, a, b):
    """Bit equality of two uint16 tensors (compared as int16)."""
    return a.dtype == b.dtype == torch.uint16 and torch.equal(
        a.view(torch.int16), b.view(torch.int16))


def u16_prefix(torch, words, n, width=None):
    """The first n words of each row, zero-padded to width (int16 views:
    the copy kernels need no uint16 support)."""
    rows = words.shape[0]
    out = torch.zeros((rows, width or n), dtype=torch.int16,
                      device=words.device)
    out[:, :n] = words.view(torch.int16)[:, :n]
    return out.view(torch.uint16)


def check_rans_case(torch, label, sym, cmap, tab):
    """K6's passes and K5 against their plain versions on one case: the
    state pass's buffers, one state pass compacted at a short capacity, then again at the worst case
    (the re-compaction an overflowing batch takes); the decode of the whole
    queue, the whole queue padded to 128 words as the codec uploads it
    (staged through K5's window), and queues cut short (reads clamp to the
    last word), at an odd length and at a multiple of 8.  Returns the
    worst-case words and totals."""
    from cnn_autoencoder_tpu_torch.ops.kernels import rans_kernel as rk
    t, s = cmap.shape
    args = (sym, cmap, tab.freq, tab.start, tab.offset)
    state = rk.encode_states_cuda(*args)
    plain = rk.rans_encode_states_plain(*args)
    torch.cuda.synchronize()
    check(u16_equal(torch, state.words, plain.words)
          and all(torch.equal(getattr(state, k), getattr(plain, k))
                  for k in ("flags", "final", "counts")),
          f"rans_encode {label}: the state pass differs from the plain "
          "version")
    worst = 2 * s + t * s
    for cap in (2 * s + 100, worst):
        words, totals = rk.compact_cuda(state, cap)
        words_p, totals_p = rk.rans_compact_plain(plain, cap)
        torch.cuda.synchronize()
        check(torch.equal(totals, totals_p), f"rans_encode {label} "
              f"capacity {cap}: totals differ from the plain version")
        check(u16_equal(torch, words, words_p), f"rans_encode {label} "
              f"capacity {cap}: words differ from the plain version")
    lut = rk.pack_dec_lut(tab.freq, tab.start, tab.slot)
    keep = int(totals.min()) // 2
    queues = [("whole", words),
              ("padded", u16_prefix(torch, words, worst,
                                    -(-worst // 128) * 128)),
              (f"cut to {keep}", u16_prefix(torch, words, keep)),
              (f"cut to {keep & ~7}", u16_prefix(torch, words, keep & ~7))]
    for qlabel, q in queues:
        vals = rk.decode_interleaved_cuda(q, cmap, lut, t)
        vals_p = rk.rans_decode_plain(q, cmap, lut, t)
        torch.cuda.synchronize()
        check(torch.equal(vals, vals_p), f"rans_decode {label} {qlabel} "
              "queue: differs from the plain version")
        if qlabel in ("whole", "padded"):
            check(torch.equal(vals + tab.offset[cmap.long()][None], sym),
                  f"rans_decode {label}: does not give back the symbols")
    log(f"rans {label}: {tuple(sym.shape)} {int(totals.sum())} words; "
        "encode (one state pass, compacted at two capacities) and decode "
        "(whole, padded and cut queues) bit-identical to the plain versions")
    return words, totals


def rans_kernels(torch, core, b):
    """K6 (state pass and compaction) and K5 against their plain versions
    on every case of rans_cases, timed on each but the peaked table and
    the plane, with their bounds and (at the serving geometry) the probe's
    serial-chain figure; returns {name: record} for the serving
    geometry."""
    from cnn_autoencoder_tpu_torch.ops.kernels import rans_kernel as rk
    cases = rans_cases(torch, core, b, np.random.RandomState(4))
    out = {}
    for label, sym, cmap, tab in cases:
        words, totals = check_rans_case(torch, label, sym, cmap, tab)
        if label.startswith("peaked") or label.startswith("plane"):
            continue
        t, s = cmap.shape
        bsz = sym.shape[0]
        args = (sym, cmap, tab.freq, tab.start, tab.offset)
        # the capacity the codec's last compaction of this batch takes
        cap = int(totals.max())
        state = rk.encode_states_cuda(*args)
        queue = u16_prefix(torch, words, cap, -(-cap // 128) * 128)
        lut = rk.pack_dec_lut(tab.freq, tab.start, tab.slot)
        st_ms = device_ms(torch, lambda: rk.encode_states_cuda(*args), 20)
        cp_ms = device_ms(torch, lambda: rk.compact_cuda(state, cap), 20)
        k6_ms = st_ms + cp_ms
        dec_ms = device_ms(torch, lambda: rk.decode_interleaved_cuda(
            queue, cmap, lut, t), 20)
        # the same calls with their wrappers' host work (CUDA events)
        k6_wall = cuda_ms(torch, lambda: rk.compact_cuda(
            rk.encode_states_cuda(*args), cap), 20)
        dec_wall = cuda_ms(torch, lambda: rk.decode_interleaved_cuda(
            queue, cmap, lut, t), 20)
        n_words = int(totals.sum())
        # K6 as one function: symbols, map and tables in, words and
        # totals out; about a dozen integer operations per symbol.  The
        # scratch between its two passes is the design's, not the
        # function's: the passes share this one bound, the state pass the
        # inputs' part, the compaction the outputs'.
        k6_in = (4 * (sym.numel() + cmap.numel() + tab.offset.numel())
                 + 8 * tab.freq.numel())
        k6_out = 2 * n_words + 4 * bsz
        k6_bms, k6_by = bound_ms(k6_in + k6_out, 12 * sym.numel(),
                                 PEAK_I32_S)
        dec_bms, dec_by = bound_ms(2 * n_words + 4 * (cmap.numel()
                                                      + lut.numel()
                                                      + sym.numel()),
                                   12 * sym.numel(), PEAK_I32_S)
        log(f"rans {label} {tuple(sym.shape)}, device time: state pass "
            f"{st_ms:.4f} ms, compaction {cp_ms:.4f} ms (capacity {cap}), "
            f"both {k6_ms:.4f} ms against K6's bound {k6_bms:.4f} ms "
            f"({k6_by}); decode {dec_ms:.4f} ms against {dec_bms:.4f} ms "
            f"({dec_by}); with the wrappers' host work (CUDA events) "
            f"{k6_wall:.4f} and {dec_wall:.4f} ms")
        if label != "flagship 64x64":
            continue
        st_plain = cuda_ms(torch, lambda: rk.rans_encode_states_plain(
            *args), 3)
        plain_state = rk.rans_encode_states_plain(*args)
        cp_plain = cuda_ms(torch, lambda: rk.rans_compact_plain(
            plain_state, cap), 3)
        dec_plain = cuda_ms(torch, lambda: rk.rans_decode_plain(
            queue, cmap, lut, t), 3)
        st_bms = k6_bms * k6_in / (k6_in + k6_out)
        cp_bms = k6_bms * k6_out / (k6_in + k6_out)
        shape = list(sym.shape)
        out["rans_encode_states"] = dict(
            max_abs_err=0.0, ms=st_ms, plain_ms=st_plain, bound_ms=st_bms,
            bound_by=k6_by, shape=shape)
        out["rans_compact"] = dict(
            max_abs_err=0.0, ms=cp_ms, plain_ms=cp_plain, bound_ms=cp_bms,
            bound_by=k6_by, shape=shape)
        out["rans_decode"] = dict(
            max_abs_err=0.0, ms=dec_ms, plain_ms=dec_plain,
            bound_ms=dec_bms, bound_by=dec_by, shape=shape)
        log(f"K6 at {tuple(sym.shape)}: both passes {k6_ms:.4f} ms, bound "
            f"{k6_bms:.4f} ms; K5 {dec_ms:.4f} ms, bound {dec_bms:.4f} ms")
        rans_chain_probe(torch, sym, cmap, tab, queue, k6_ms, dec_ms,
                         k6_bms, dec_bms)
    return out


def rans_chain_probe(torch, sym, cmap, tab, queue, k6_ms, dec_ms, k6_bms,
                     dec_bms):
    """The serial chain of K6's state pass and of K5 from their probe build
    (csrc/probes/rans_probe.cu: thread 0 of each block reads clock64 and
    the nanosecond timer around its loop): cycles a step in the kernel at
    the serving geometry, and with one warp of 32 streams on one tile (the
    step's dependent chain alone, nothing else on its SM); the chain
    figure is the latter's T steps at the clock read beside it."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    from cnn_autoencoder_tpu_torch.ops.kernels import rans_kernel as rk
    lib = PROBES["rans_probe"]
    stream = torch.cuda.current_stream().cuda_stream

    def read(which, blocks, steps):
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4 * blocks))()
        build.check_launch(lib.cae_rans_probe_read(
            which, ctypes.addressof(buf), blocks), "rans probe read")
        rec = np.ctypeslib.as_array(buf).astype(np.float64).reshape(
            blocks, 4)
        cycles, ns = rec[:, 1] - rec[:, 0], rec[:, 3] - rec[:, 2]
        return float(cycles.mean() / steps), float(cycles.sum() / ns.sum())

    def probe(sym, cmap, q):
        b, t, s = sym.shape
        st = rk.encode_states_cuda(sym, cmap, tab.freq, tab.start,
                                   tab.offset)
        lut = rk.pack_dec_lut(tab.freq, tab.start, tab.slot)
        vals = torch.empty((b, t, s), dtype=torch.int32, device="cuda")
        scratch = torch.empty((b, s), dtype=torch.int32, device="cuda")
        blocks = b * -(-(-(-s // 32) * 32) // 256)
        for _ in range(2):  # the second launch is read
            build.check_launch(lib.cae_rans_encode_states(
                sym.data_ptr(), cmap.data_ptr(), tab.freq.data_ptr(),
                tab.start.data_ptr(), tab.offset.data_ptr(),
                tab.freq.shape[0], tab.freq.shape[1], b, t, s,
                st.words.data_ptr(), st.flags.data_ptr(),
                st.final.data_ptr(), st.counts.data_ptr(), stream),
                "rans probe state pass")
        enc = read(0, blocks, t)
        for _ in range(2):
            build.check_launch(lib.cae_rans_decode(
                q.data_ptr(), b, q.shape[1], cmap.data_ptr(),
                lut.data_ptr(), lut.shape[0], vals.data_ptr(),
                scratch.data_ptr(), t, s, stream), "rans probe decode")
        dec = read(1, b, t)
        laps = (ctypes.c_ulonglong * (4 * b))()
        build.check_launch(lib.cae_rans_probe_laps(ctypes.addressof(laps), b),
                           "rans probe laps")
        laps = np.ctypeslib.as_array(laps).astype(np.float64).reshape(b, 4)
        check(torch.equal(vals, rk.decode_interleaved_cuda(q, cmap, lut, t)),
              "rans probe build: decode differs from the library's")
        return enc, dec, laps.mean(axis=0) / t

    t = cmap.shape[0]
    (enc_step, enc_ghz), (dec_step, dec_ghz), laps = probe(sym, cmap, queue)
    one_sym = sym[:1, :, :32].contiguous()
    one_map = cmap[:, :32].contiguous()
    one_words, one_tot = rk.compact_cuda(rk.encode_states_cuda(
        one_sym, one_map, tab.freq, tab.start, tab.offset), 64 + t * 32)
    (enc_chain, enc_ghz1), (dec_chain, dec_ghz1), _ = probe(
        one_sym, one_map, u16_prefix(torch, one_words, 64 + t * 32,
                                     -(-(64 + t * 32) // 128) * 128))
    for name, step, ghz, chain, ghz1, ms, bms in (
            ("rans_encode_states", enc_step, enc_ghz, enc_chain, enc_ghz1,
             k6_ms, k6_bms),
            ("rans_decode", dec_step, dec_ghz, dec_chain, dec_ghz1, dec_ms,
             dec_bms)):
        log(f"{name} probe {tuple(sym.shape)}: {step:.1f} cycles a step in "
            f"the kernel ({step * t / ghz / 1e6:.4f} ms over {t} steps at "
            f"{ghz:.3f} GHz); one warp alone {chain:.1f} cycles a step, so "
            f"the serial chain of {t} steps takes "
            f"{chain * t / ghz1 / 1e6:.4f} ms at {ghz1:.3f} GHz; kernel "
            f"{ms:.4f} ms (K6: both passes), byte bound {bms:.4f} ms")
    log(f"rans_decode probe {tuple(sym.shape)}: a step's cycles by part "
        f"(thread 0 of each block, mean): the states' decode {laps[0]:.1f}, "
        f"the wait for copies and the barrier {laps[1]:.1f}, the counts of "
        f"the warps before {laps[2]:.1f}, the refills {laps[3]:.1f}")


# -- phase 3 -----------------------------------------------------------------


def plain_reconstruct(torch, model, core, tiles_u8, symbols):
    """The serving round trip through the plain versions only, on the card,
    at the core's compute type: (symbols (B, C, lh, lw), u8 reconstruction
    (B, H, W, 3)).  The plain rANS round trip runs on the plain encoder's
    own symbols; the plain decoder synthesizes ``symbols`` (the kernels'
    path's), so the two reconstructions come from the same quantized
    latent, as tests/test_rd_parity.py compares them."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import (
        pack_streams, unpack_streams)
    from cnn_autoencoder_tpu_torch.ops.kernels.conv_gdn_kernel import \
        conv_gdn_plain
    from cnn_autoencoder_tpu_torch.ops.kernels.gdn_kernel import gdn_plain
    from cnn_autoencoder_tpu_torch.ops.kernels.rans_kernel import (
        pack_dec_lut, rans_decode_plain, rans_encode_plain)

    def gdn(x, mod, inverse):
        gamma, beta = mod.effective_params()
        c = x.shape[-1]
        return gdn_plain(x.reshape(-1, c), gamma, beta,
                         inverse).reshape(x.shape)

    dtype = core.base.compute_dtype
    with torch.no_grad():
        x = (torch.from_numpy(tiles_u8).cuda().float() / 255.0).to(dtype)
        for name in model.encoder.names:
            unit = getattr(model.encoder, name)
            if unit.fused:
                gamma, beta = unit.gdn_down.effective_params()
                x = conv_gdn_plain(x, unit.conv_down.kernel_hwio(), gamma,
                                   beta)
            elif unit.act == "GDN":
                x = gdn(unit.conv_down(x), unit.gdn_down, False)
            else:
                check(unit.act is None, f"{name}: activation {unit.act}")
                x = unit.conv_down(x)
        sym = torch.round(x - core.base._med).to(torch.int32)
        sym = sym.permute(0, 3, 1, 2).contiguous()
        bsz, c, lh, lw = sym.shape
        s = core.num_streams
        cmap = core._ch_map(lh, lw, s)
        tab = core.tables
        packed = pack_streams(sym.reshape(bsz, -1), s)
        t = packed.shape[1]
        words, totals = rans_encode_plain(packed, cmap, tab.freq, tab.start,
                                          tab.offset, 2 * s + t * s)
        vals = rans_decode_plain(words, cmap, pack_dec_lut(
            tab.freq, tab.start, tab.slot), t)
        dec = unpack_streams(vals + tab.offset[cmap.long()][None],
                             c * lh * lw).reshape(sym.shape)
        check(torch.equal(dec, sym), "plain rANS round trip lost symbols")
        y = (symbols.permute(0, 2, 3, 1).float() + core.base._med).to(dtype)
        for name in model.decoder.names:
            unit = getattr(model.decoder, name)
            y = unit.deconv_up(y)
            if unit.act == "GDN":
                y = gdn(y, unit.gdn_up, True)
            else:
                check(unit.act is None, f"{name}: activation {unit.act}")
        rec = torch.clamp(y.float() * 255.0, 0, 255).to(torch.uint8)
    return sym, rec.cpu().numpy()


def serving_round_trip(torch, model, core, imgs, mode):
    """One counted, timed round trip of the tiles through ``core`` at its
    precision ``mode`` (launch counts reset just before and read just
    after), symbols lossless, then the same tiles through the plain
    versions on the card.  Returns (launches, record of the round trip)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import is_turbo_frame
    tiles = imgs.shape[0]
    mpix = tiles * 512 * 512 / 1e6

    # warm-up pass (cuDNN plans, allocator), then the counted, timed pass
    core.decode_tiles(core.encode_tiles(imgs))
    torch.cuda.synchronize()
    retries = core.capacity_retries
    reset_launch_counts()
    t0 = time.perf_counter()
    frames = core.encode_tiles(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = core.decode_tiles(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    retries = core.capacity_retries - retries
    log(f"serving path ({mode}) launches: {launches}; {retries} capacity "
        f"retries: {launches['rans_encode_states']} state pass and "
        f"{launches['rans_compact']} compactions in the round trip")
    for name, n in launches.items():
        check((n > 0) == (name in SERVING_KERNELS[mode]),
              f"kernel {name}: {n} launches on the {mode} serving path")
    gdn = "gdn_fwd" if mode == "float32" else "gdn_fwd_bf16"
    check(launches[gdn] == 3 and launches["conv_gdn_fwd"] == 1
          and launches["rans_decode"] == 1, f"{mode} serving path: "
          f"{gdn} {launches[gdn]}, conv_gdn_fwd {launches['conv_gdn_fwd']}, "
          f"rans_decode {launches['rans_decode']} launches; expected 3, 1, 1")
    check(launches["rans_encode_states"] == 1
          and launches["rans_compact"] == 1 + retries,
          "the encode should run one state pass and one compaction per "
          "capacity tried")

    check(len(frames) == tiles and all(is_turbo_frame(f) for f in frames),
          "not every frame is a turbo frame")
    check(rec.shape == imgs.shape and rec.dtype == np.uint8,
          f"reconstruction {rec.shape} {rec.dtype}")
    with torch.no_grad():
        sym_enc = core.latent_symbols(imgs)
        sym_dec = core.symbols_from_frames(
            frames, core.num_streams, 512, 512)
    check(torch.equal(sym_enc, sym_dec), "decoded symbols differ from the "
          "encoded ones")
    mse = np.mean((rec.astype(np.float64) - imgs) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    bpp = 8.0 * sum(len(f) for f in frames) / (tiles * 512 * 512)
    log(f"end to end ({mode}): {tiles} tiles of 512^2, all turbo, symbols "
        f"lossless; PSNR {psnr:.3f} dB, {bpp:.4f} bpp; encode "
        f"{mpix / (t1 - t0):.3f} MP/s ({(t1 - t0) * 1e3:.1f} ms), decode "
        f"{mpix / (t2 - t1):.3f} MP/s ({(t2 - t1) * 1e3:.1f} ms)")

    sym_p, rec_p = plain_reconstruct(torch, model, core, imgs, sym_enc)
    flips = float((sym_p != sym_enc).float().mean())
    diff = np.abs(rec_p.astype(np.int32) - rec)
    frac = float(np.mean(diff != 0))
    log(f"plain versions on the card ({mode}): symbol flips {flips:.3e}; "
        f"from the same symbols, u8 pixels differing {frac:.3e}, max "
        f"difference {int(diff.max())}")
    check(flips <= 1e-4, f"{mode}: symbol flips {flips:.3e} > 1e-4")
    check(frac < 5e-3 and int(diff.max()) <= 1, f"{mode}: plain and kernel "
          "reconstructions differ beyond 0.5% / 1 level")
    return launches, dict(frames=frames, rec=rec, sym=sym_enc, psnr=psnr,
                          bpp=bpp, encode_ms=(t1 - t0) * 1e3,
                          decode_ms=(t2 - t1) * 1e3)


def phase_end_to_end(torch, model, core, tiles):
    """Phase 3: the float32 and bf16 round trips, each with its own launch
    counts, the deconvolutions and decodes bit-equal from run to run;
    returns (launches summed over both round trips, the bf16 core)."""
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        CAETurboCore, ConvolutionalAutoencoderTurbo)

    imgs = np.stack([image(512, 512, seed) for seed in range(tiles)])
    launches, f32 = serving_round_trip(torch, model, core, imgs, "float32")
    frames, rec, sym_enc = f32["frames"], f32["rec"], f32["sym"]

    # the codec object a zarr store holds, on one tile
    codec = ConvolutionalAutoencoderTurbo(CHECKPOINT, num_streams=1024)
    buf = codec.encode(imgs[0])
    check(buf == frames[0], "codec.encode differs from encode_tiles")
    # cuBLAS may pick another algorithm for the products of a batch of
    # one, so the reconstruction is held to the u8 tolerance, not bit
    # equality
    diff = np.abs(codec.decode(buf).astype(np.int32) - rec[0])
    check(np.mean(diff != 0) < 5e-3 and int(diff.max()) <= 1,
          "codec.decode differs from decode_tiles beyond 0.5% / 1 level")
    round_trip_2048(torch, model, imgs, sym_enc, rec)
    profile_device(torch, lambda: core.decode_tiles(core.encode_tiles(imgs)),
                   "one more round trip", copies=True)

    deconv_times(torch, model, tiles)
    core16 = CAETurboCore(model, num_streams=1024, device="cuda",
                          compute_dtype=torch.bfloat16)
    bf16_launches, bf16 = serving_round_trip(torch, model, core16, imgs,
                                             "bf16")
    d_psnr = bf16["psnr"] - f32["psnr"]
    mpix = tiles * 512 * 512 / 1e6
    log(f"bf16 against float32 serving: PSNR {bf16['psnr']:.3f} / "
        f"{f32['psnr']:.3f} dB (delta {d_psnr:+.4f}, limit "
        f"{BF16_PSNR_DB}), {bf16['bpp']:.4f} / {f32['bpp']:.4f} bpp; "
        f"encode {mpix / bf16['encode_ms'] * 1e3:.3f} / "
        f"{mpix / f32['encode_ms'] * 1e3:.3f} MP/s, decode "
        f"{mpix / bf16['decode_ms'] * 1e3:.3f} / "
        f"{mpix / f32['decode_ms'] * 1e3:.3f} MP/s")
    check(abs(d_psnr) <= BF16_PSNR_DB, f"bf16 serving PSNR differs from "
          f"float32's by {d_psnr:+.4f} dB")
    for name, n in bf16_launches.items():
        launches[name] += n
    for label, c, fr in (("float32", core, frames),
                         ("bf16", core16, bf16["frames"])):
        decodes_bit_equal(torch, c, fr, label)
    profile_device(torch, lambda: core16.decode_tiles(
        core16.encode_tiles(imgs)), "one more bf16 round trip", copies=True)
    return launches, core16


def deconv_times(torch, model, tiles):
    """The decoder's transposed convolutions at the round trip's shapes,
    float32 and bf16, three ways: the port's (a fixed order of sums),
    cuDNN's ``F.conv_transpose2d`` at its default algorithms, and the same
    with ``torch.backends.cudnn.deterministic`` (timings only, set for the
    call and restored)."""
    import torch.nn.functional as F
    from cnn_autoencoder_tpu_torch.ops.convops import _conv_operands
    from cnn_autoencoder_tpu_torch.utils.device import full_f32
    gen = torch.Generator(device="cuda").manual_seed(12)

    def cudnn(x, weight, bias):
        with full_f32():
            return F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias,
                                      stride=2, padding=1, output_padding=1)

    def cudnn_deterministic(x, weight, bias):
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return cudnn(x, weight, bias)
        finally:
            torch.backends.cudnn.deterministic = saved

    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            totals = np.zeros(3)
            for i, name in enumerate(model.decoder.names):
                mod = getattr(model.decoder, name).deconv_up
                side = 64 * 2 ** i
                x = (0.5 * torch.randn(tiles, side, side, mod.weight.shape[0],
                                       device="cuda", generator=gen)
                     ).to(dtype)
                weight, bias = _conv_operands(x, mod.weight, mod.bias)
                t = np.array([cuda_ms(torch, lambda: mod(x), 10)]
                             + [cuda_ms(torch, lambda: fn(x, weight, bias), 10)
                                for fn in (cudnn, cudnn_deterministic)])
                totals += t
                log(f"deconv {name} {tuple(x.shape)} -> "
                    f"{mod.weight.shape[1]} {str(dtype)[6:]}: port "
                    f"{t[0]:.4f} ms, cuDNN default {t[1]:.4f} ms, cuDNN "
                    f"deterministic {t[2]:.4f} ms")
                del x
            log(f"deconv: the three layers {str(dtype)[6:]}: port "
                f"{totals[0]:.4f} ms, cuDNN default {totals[1]:.4f} ms, cuDNN "
                f"deterministic {totals[2]:.4f} ms")
    torch.cuda.empty_cache()


def decodes_bit_equal(torch, core, frames, label):
    """Three decodes of the same frames, bit-equal, with cuDNN's
    deterministic switch off (fault 5: cuDNN's default transposed
    convolutions add in a varying order; the port's do not)."""
    check(not torch.backends.cudnn.deterministic,
          "cudnn.deterministic is set")
    recs = [core.decode_tiles(frames) for _ in range(3)]
    check(all(np.array_equal(recs[0], r) for r in recs[1:]),
          f"{label}: three decodes of the same symbols differ")
    log(f"{label}: three decodes of the same {len(frames)} frames are "
        f"bit-equal ({recs[0].size} values each)")


def round_trip_2048(torch, model, imgs, sym_enc, rec):
    """The same tiles through a CAETurboCore of 2048 streams (above the
    1024 the earlier rANS kernels took): symbols lossless, the
    reconstruction that of the 1024-stream core within the u8 tolerance."""
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    core = CAETurboCore(model, num_streams=2048, device="cuda")
    core.decode_tiles(core.encode_tiles(imgs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = core.encode_tiles(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec2 = core.decode_tiles(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        sym_dec = core.symbols_from_frames(frames, 2048, 512, 512)
    check(torch.equal(sym_dec, sym_enc), "2048 streams: decoded symbols "
          "differ from the encoded ones")
    diff = np.abs(rec2.astype(np.int32) - rec)
    check(np.mean(diff != 0) < 5e-3 and int(diff.max()) <= 1,
          "2048 streams: reconstruction differs from 1024 streams'")
    mpix = imgs.shape[0] * 512 * 512 / 1e6
    bpp = 8.0 * sum(len(f) for f in frames) / (imgs.shape[0] * 512 * 512)
    log(f"end to end at 2048 streams: symbols lossless, {bpp:.4f} bpp, "
        f"{core.capacity_retries} capacity retries over two round trips; "
        f"encode {mpix / (t1 - t0):.3f} MP/s ({(t1 - t0) * 1e3:.1f} ms), "
        f"decode {mpix / (t2 - t1):.3f} MP/s ({(t2 - t1) * 1e3:.1f} ms)")


def profile_device(torch, fn, label, copies=False):
    """Device time by operation over one more call of ``fn`` (the 15
    largest rows and every row of the port's own kernels), and the share
    of the wall time the device was busy; with ``copies``, the host<->device
    copies' time, count and bytes from the trace.  Returns the busy
    seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # device-side entries only (kernels and copies): an operator's row
        # repeats the device time of the kernels it launched
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key == "Activity Buffer Request"):
            continue
        rows.append((evt.self_device_time_total, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"profile of {label}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%)")
    for us, count, key in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")
    # the port's own kernels (csrc/, anonymous namespaces) below those rows
    ours = [r for r in rows[15:] if "(anonymous namespace)::" in r[2]
            and "at::native" not in r[2]]
    if ours:
        log("  ... the port's kernels below them:")
    for us, count, key in ours:
        log(f"  {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")
    if copies:
        copy_rows(prof)
    return busy


def copy_rows(prof):
    """Host<->device copies of a profile, from its trace (the bytes are
    only there): ms, count and bytes by direction."""
    path = os.path.join(ROOT, "build", "profile_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    rows = {}
    for evt in events:
        name = evt.get("name", "")
        if evt.get("cat") != "gpu_memcpy" or ("HtoD" not in name
                                               and "DtoH" not in name):
            continue
        row = rows.setdefault(name, [0.0, 0, 0])
        row[0] += evt.get("dur", 0.0) / 1e3
        row[1] += 1
        row[2] += int(evt.get("args", {}).get("bytes", 0))
    for name, (ms, count, nbytes) in sorted(rows.items()):
        log(f"  copies {name}: {ms:.3f} ms, {count}x, {nbytes} bytes")


# -- phase 4 -----------------------------------------------------------------


def bf16_ulps(a, b):
    """Largest distance in bf16 ulps between two bf16 tensors whose
    elements share their signs."""
    import torch
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def close(got, ref, rel, slack):
    """max |got - ref| <= rel * |ref| + slack * max |ref|, elementwise;
    returns (ok, max abs error)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool((err <= rel * ref.abs() + slack * ref.abs().max()).all())
    return ok, float(err.max())


def check_gdn_fwd_case(torch, x, gamma, beta, inverse, label):
    """K2 against its plain version: y to 1e-5 relative (float32) or one
    bf16 ulp, r to one bf16 ulp.  Returns (max abs error of y, r)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    bf16 = x.dtype == torch.bfloat16
    y, rb = gk.gdn_train_fwd_cuda(x, gamma, beta, inverse)
    y_p, rb_p = gk.gdn_train_fwd_plain(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y.float()).all()), f"{label}: y not finite")
    if bf16:
        check(bf16_ulps(y, y_p) <= 1, f"gdn_train_fwd {label}: y differs "
              "from the plain version by more than one bf16 ulp")
    ok, y_err = close(y, y_p, 1e-5, 0.0) if not bf16 else close(y, y_p, 1, 0)
    check(ok, f"gdn_train_fwd {label}: y error {y_err:.3e}")
    check(bf16_ulps(rb, rb_p) <= 1, f"gdn_train_fwd {label}: r differs "
          "by more than one bf16 ulp")
    return y_err, rb


def check_gdn_train_case(torch, x, gamma, beta, inverse, label, rng):
    """K2 then K3 on the same rows, each against its plain version: K2 by
    check_gdn_fwd_case, dnb to one bf16 ulp, dx to one bf16 ulp (2^-7
    relative) or 1e-5 relative, plus 1e-5 of max |dx| for the sums' order.
    Returns the max abs errors of y and dx."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    bf16 = x.dtype == torch.bfloat16
    y_err, rb = check_gdn_fwd_case(torch, x, gamma, beta, inverse, label)
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).cuda()
    g = g.to(x.dtype)
    xb = x.to(torch.bfloat16)
    dx, dnb = gk.gdn_train_bwd_cuda(g, xb, rb, gamma, inverse)
    dx_p, dnb_p = gk.gdn_train_bwd_plain(g, xb, rb, gamma, inverse)
    torch.cuda.synchronize()
    check(bf16_ulps(dnb, dnb_p) <= 1, f"gdn_train_bwd {label}: dnb differs "
          "by more than one bf16 ulp")
    ok, dx_err = close(dx, dx_p, 2.0 ** -7 if bf16 else 1e-5, 1e-5)
    check(ok, f"gdn_train_bwd {label}: dx error {dx_err:.3e}")
    log(f"gdn_train_fwd/bwd {label}: y max abs {y_err:.3e}, dx max abs "
        f"{dx_err:.3e}, dnb identical on "
        f"{float((dnb == dnb_p).float().mean()):.6f} of elements")
    return y_err, dx_err


def check_gdn_train_misaligned(torch, rng):
    """K2 and K3 on inputs whose rows start one element past a 16-byte
    boundary (views into larger buffers), which they stage element by
    element: held to their plain versions with check_gdn_train_case's
    limits."""
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    rows, c = 131, 128
    gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32)).cuda()
    beta = torch.from_numpy((1.0 + rng.rand(c)).astype(np.float32)).cuda()

    def shifted(a, dt):
        buf = torch.empty(a.size + 8, dtype=dt, device="cuda")
        view = buf[1:1 + a.size].view(rows, c)
        view.copy_(torch.from_numpy(a).to(dt))
        return view

    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        x = shifted(rng.randn(rows, c).astype(np.float32), dtype)
        g = shifted(rng.randn(rows, c).astype(np.float32), dtype)
        xb = shifted(rng.randn(rows, c).astype(np.float32), torch.bfloat16)
        rb = shifted((0.5 + rng.rand(rows, c)).astype(np.float32),
                     torch.bfloat16)
        check(x.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0
              and xb.data_ptr() % 16 != 0,
              "misaligned K2/K3 case: the views are aligned")
        for inverse in (False, True):
            label = f"misaligned ({rows}, {c}) {str(dtype)[6:]} " \
                    f"inverse={inverse}"
            y_err, _ = check_gdn_fwd_case(torch, x, gamma, beta, inverse,
                                          label)
            dx, dnb = gk.gdn_train_bwd_cuda(g, xb, rb, gamma, inverse)
            dx_p, dnb_p = gk.gdn_train_bwd_plain(g, xb, rb, gamma, inverse)
            torch.cuda.synchronize()
            check(bf16_ulps(dnb, dnb_p) <= 1, f"gdn_train_bwd {label}: dnb "
                  "differs by more than one bf16 ulp")
            ok, err = close(dx, dx_p, 2.0 ** -7 if bf16 else 1e-5, 1e-5)
            check(ok, f"gdn_train_bwd {label}: dx error {err:.3e}")
            log(f"gdn_train_fwd/bwd {label}: y max abs {y_err:.3e}, dx max "
                f"abs {err:.3e}")


def time_probes(torch, kernel, probes, call, laps_fn, parts, tiles, shape):
    """Each probe build of ``probes`` (``call(lib, name)`` launches it once)
    timed by CUDA events, with the clock64 cycles of each part of a tile
    that its ``laps_fn`` reads and zeroes (thread 0 of a block, over
    ``tiles`` tiles a launch); returns {name: ms}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    reps, times = 20, {}
    for name in probes:
        lib = PROBES[name]
        laps = (ctypes.c_ulonglong * 4)()
        read = getattr(lib, laps_fn)
        build.check_launch(read(laps), name)  # zero
        times[name] = cuda_ms(torch, lambda: call(lib, name), reps)
        build.check_launch(read(laps), name)
        per_tile = [v / ((reps + 1) * tiles) for v in laps]
        log(f"{kernel} probe {name} {shape} bf16: {times[name]:.4f} ms; "
            "cycles a 32-row tile (thread 0 of a block) by part: "
            + ", ".join(f"{p} {v:.1f}" for p, v in zip(parts, per_tile)))
    return times


def k2_yardsticks(torch, xb, gamma, beta, ms, dev_ms, bms, mm_ms):
    """K2 at the timed shape (CUDA events around the wrapper ``ms``, the
    device time of its kernels ``dev_ms``) beside its probes (the kernel
    with cycle counts by part of a tile; the same without device-memory
    traffic, what the SM spends) and beside cuBLAS's bf16 product of the
    same shape alone (``mm_ms``)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    n, c = xb.shape
    y = torch.empty_like(xb)
    rb = torch.empty_like(xb)
    g32 = gamma.detach().float().contiguous()
    b32 = beta.detach().float().contiguous()
    work = torch.empty(build.load_library().cae_gdn_train_fwd_workspace(c),
                       dtype=torch.uint8, device=xb.device)

    def call(lib, name):
        build.check_launch(lib.cae_gdn_train_fwd(
            xb.data_ptr(), g32.data_ptr(), b32.data_ptr(), y.data_ptr(),
            rb.data_ptr(), work.data_ptr(), n, c, 0,
            torch.cuda.current_stream().cuda_stream), name)

    # thread 0 is in the first of a block's groups: one tile in as many as
    # the probe's resident block holds
    groups = PROBES["k2_laps"].cae_gdn_fwd_probe_groups()
    time_probes(torch, "gdn_train_fwd", K2_PROBES, call,
                "cae_gdn_fwd_probe_laps",
                ("wait for copies", "x^2", "product", "epilogue"),
                -(-n // (32 * groups)), [n, c])
    log(f"gdn_train_fwd {[n, c]} bf16: kernel {ms:.4f} ms by CUDA events "
        f"around the wrapper ({dev_ms:.4f} ms device time), "
        f"{100 * bms / ms:.1f}% of its bound {bms:.4f} ms; cuBLAS bf16 "
        f"({n}, {c}) @ ({c}, {c}) alone {mm_ms:.4f} ms (a yardstick)")


def k3_yardsticks(torch, g, xb, rb, gamma, ms, bms, mm_ms):
    """K3 at the timed shape beside its probes (the kernel with cycle
    counts by part of a tile; the same without device-memory traffic, what
    the SM spends) and beside cuBLAS's bf16 product of the same shape
    alone (``mm_ms``)."""
    from cnn_autoencoder_tpu_torch.ops.kernels import build
    n, c = g.shape
    dx = torch.empty_like(g)
    dnb = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    g32 = gamma.detach().float().contiguous()
    work = torch.empty(build.load_library().cae_gdn_train_bwd_workspace(c),
                       dtype=torch.uint8, device=g.device)

    def call(lib, name):
        build.check_launch(lib.cae_gdn_train_bwd(
            g.data_ptr(), xb.data_ptr(), rb.data_ptr(), g32.data_ptr(),
            dx.data_ptr(), dnb.data_ptr(), work.data_ptr(), n, c, 0,
            int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), name)

    # thread 0 is in the first of a block's two groups: half the 32-row tiles
    time_probes(torch, "gdn_train_bwd", K3_PROBES, call,
                "cae_gdn_bwd_probe_laps",
                ("wait for copies", "dnb", "product", "dx"), -(-n // 64),
                [n, c])
    log(f"gdn_train_bwd {[n, c]} bf16: kernel {ms:.4f} ms; cuBLAS bf16 "
        f"({n}, {c}) @ ({c}, {c}) alone {mm_ms:.4f} ms (a yardstick); "
        f"bound {bms:.4f} ms")


def check_conv_train_case(torch, x, kernel, gamma, beta, label):
    """K4's training variant against its plain version: y to 1e-4 of
    max |y|, out to 1e-4 of max |out| (float32) or one bf16 ulp plus
    that.  Returns the max abs error of out."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    out, y = cg.conv_gdn_train_cuda(x, kernel, gamma, beta)
    out_p, y_p = cg.conv_gdn_train_plain(x, kernel, gamma, beta)
    torch.cuda.synchronize()
    check(out.shape == out_p.shape and out.dtype == x.dtype
          and y.dtype == torch.float32, f"conv_gdn_train_fwd {label}: "
          f"{tuple(out.shape)} {out.dtype} {y.dtype}")
    check(bool(torch.isfinite(out.float()).all()), f"{label}: not finite")
    ok_y, y_err = close(y, y_p, 0.0, 1e-4)
    bf16 = x.dtype == torch.bfloat16
    ok_o, o_err = close(out, out_p, 2.0 ** -7 if bf16 else 0.0, 1e-4)
    check(ok_y and ok_o, f"conv_gdn_train_fwd {label}: y error {y_err:.3e}, "
          f"out error {o_err:.3e}")
    log(f"conv_gdn_train_fwd {label}: out max abs {o_err:.3e}, y max abs "
        f"{y_err:.3e}")
    return o_err


def check_conv_case(torch, x, kernel, gamma, beta, label):
    """K4 in both variants at one geometry: the training variant by
    check_conv_train_case, the serving variant against the plain version
    to the same out tolerance and equal to the training variant's out."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    check_conv_train_case(torch, x, kernel, gamma, beta, label)
    got = cg.conv_gdn_cuda(x, kernel, gamma, beta)
    ref = cg.conv_gdn_plain(x, kernel, gamma, beta)
    torch.cuda.synchronize()
    ok, err = close(got, ref, 2.0 ** -7 if x.dtype == torch.bfloat16
                    else 0.0, 1e-4)
    check(ok and got.shape == ref.shape, f"conv_gdn_fwd {label}: out error "
          f"{err:.3e}")
    check(torch.equal(got, cg.conv_gdn_train_cuda(x, kernel, gamma, beta)[0]),
          f"conv_gdn_fwd {label}: differs from the training variant's out")


def phase_train_kernels(torch, model):
    """K2, K3 and K4's training variant against their plain versions at the
    training path's shapes and at ragged ones, then timed at the path's
    shapes; returns {name: record}."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    rng = np.random.RandomState(1)
    b, h = TRAIN_BATCH, TRAIN_PATCH
    n = b * (h // 2) ** 2           # rows of down_0 and up_1
    out = {}
    with torch.no_grad():
        # K2/K3 at the path's shapes: down_0 (forward, n rows), up_0
        # (inverse, n / 4 rows) and up_1 (inverse, n rows)
        errs = {}
        for rows, inverse, unit, gdn_name in (
                (n, False, model.encoder.down_0, "gdn_down"),
                (n // 4, True, model.decoder.up_0, "gdn_up"),
                (n, True, model.decoder.up_1, "gdn_up")):
            gamma, beta = getattr(unit, gdn_name).effective_params()
            c = gamma.shape[0]
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.from_numpy(rng.randn(rows, c).astype(np.float32)
                                     * 0.5).cuda().to(dtype)
                errs[(rows, inverse, dtype)] = check_gdn_train_case(
                    torch, x, gamma, beta, inverse,
                    f"({rows}, {c}) {str(dtype)[6:]} inverse={inverse}", rng)
                del x
        # C = 48 (the latent's width), ragged C and rows (K3's resident
        # layout up to C = 128, its streamed one above)
        for rows, c in ((1000, 48), (203, 3), (1001, 128), (9, 128),
                        (77, 130), (130, 256), (70, 512)):
            gamma = torch.from_numpy((0.1 * rng.rand(c, c))
                                     .astype(np.float32)).cuda()
            beta = torch.from_numpy((1.0 + rng.rand(c))
                                    .astype(np.float32)).cuda()
            for dtype in (torch.bfloat16, torch.float32):
                for inverse in (False, True):
                    x = torch.from_numpy(rng.randn(rows, c).astype(
                        np.float32)).cuda().to(dtype)
                    check_gdn_train_case(
                        torch, x, gamma, beta, inverse,
                        f"({rows}, {c}) {str(dtype)[6:]} inverse={inverse}",
                        rng)
        # K2 at norms below the range of its branch-free square root (beta
        # 1e-35 and rows of zeros), where its IGDN falls back to sqrtf (K3's
        # function overflows there: r^3 of those rows is past float32)
        c = 128
        gamma = torch.from_numpy((0.1 * rng.rand(c, c)).astype(np.float32)) \
            .cuda()
        beta = torch.full((c,), 1e-35, device="cuda")
        x32 = rng.randn(67, c).astype(np.float32)
        x32[::3] = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            for inverse in (False, True):
                label = f"(67, {c}) beta 1e-35 {str(dtype)[6:]} " \
                        f"inverse={inverse}"
                y_err, _ = check_gdn_fwd_case(
                    torch, torch.from_numpy(x32).cuda().to(dtype), gamma,
                    beta, inverse, label)
                log(f"gdn_train_fwd {label}: y max abs {y_err:.3e}")
        check_gdn_train_misaligned(torch, rng)

        # K4 training variant: down_1 at the path's shape, and ragged
        unit = model.encoder.down_1
        kernel = unit.conv_down.kernel_hwio()
        gamma, beta = unit.gdn_down.effective_params()
        cin, cout = kernel.shape[2], kernel.shape[3]
        x32 = torch.from_numpy(rng.rand(b, h // 2, h // 2, cin)
                               .astype(np.float32)).cuda()
        conv_err = {dt: check_conv_train_case(
            torch, x32.to(dt), kernel, gamma, beta,
            f"{tuple(x32.shape)} {str(dt)[6:]}")
            for dt in (torch.float32, torch.bfloat16)}
        for shape, co in (((2, 18, 14, 72), 40), ((1, 4, 6, 64), 128)):
            xr = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
            kr = torch.from_numpy((rng.randn(3, 3, shape[3], co) * 0.05)
                                  .astype(np.float32)).cuda()
            gr = torch.from_numpy((0.1 * rng.rand(co, co))
                                  .astype(np.float32)).cuda()
            br = torch.from_numpy((1.0 + rng.rand(co))
                                  .astype(np.float32)).cuda()
            for dt in (torch.float32, torch.bfloat16):
                check_conv_train_case(torch, xr.to(dt), kr, gr, br,
                                      f"{shape} -> {co} {str(dt)[6:]}")
                # the serving variant in bf16 (eval in bf16) gives the
                # training variant's output
                served = cg.conv_gdn_cuda(xr.to(dt), kr, gr, br)
                check(torch.equal(served, cg.conv_gdn_train_cuda(
                    xr.to(dt), kr, gr, br)[0]),
                    f"conv_gdn_fwd {shape} {dt}: differs from the training "
                    "variant's output")

        # timing at the path's shapes (bf16 rows for K2/K3, their mode)
        gamma0, beta0 = model.encoder.down_0.gdn_down.effective_params()
        c = gamma0.shape[0]
        xb = torch.from_numpy(rng.randn(n, c).astype(np.float32) * 0.5) \
            .cuda().to(torch.bfloat16)
        _, rb = gk.gdn_train_fwd_cuda(xb, gamma0, beta0)
        gb = torch.from_numpy(rng.randn(n, c).astype(np.float32)).cuda() \
            .to(torch.bfloat16)
        nc = n * c
        # K2 by CUDA events around the wrapper, as K1, K3 and K4 are timed;
        # the device time of its prep and main kernel beside it, in the log
        def k2():
            return gk.gdn_train_fwd_cuda(xb, gamma0, beta0)

        ms, dev_ms = cuda_ms(torch, k2, 20), device_ms(torch, k2, 20)
        plain_ms = cuda_ms(torch, lambda: gk.gdn_train_fwd_plain(
            xb, gamma0, beta0), 10)
        bms, by = bound_ms(6 * nc + 4 * c * (c + 1),
                           [(2 * nc * c, PEAK_BF16_S), (5 * nc, PEAK_F32_S)])
        out["gdn_train_fwd"] = dict(
            max_abs_err=errs[(n, False, torch.bfloat16)][0], ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, shape=[n, c])
        # cuBLAS's bf16 product of K2's and K3's shape alone: a yardstick
        # for the log (torch.matmul; no single library call computes
        # either function)
        a = torch.randn(n, c, device="cuda").to(torch.bfloat16)
        b = gamma0.detach().to(torch.bfloat16)
        mm_ms = cuda_ms(torch, lambda: torch.matmul(a, b), 20)
        del a
        k2_yardsticks(torch, xb, gamma0, beta0, ms, dev_ms, bms, mm_ms)
        ms = cuda_ms(torch, lambda: gk.gdn_train_bwd_cuda(gb, xb, rb, gamma0),
                     20)
        plain_ms = cuda_ms(torch, lambda: gk.gdn_train_bwd_plain(
            gb, xb, rb, gamma0), 10)
        bms, by = bound_ms(10 * nc + 4 * c * c,
                           [(2 * nc * c, PEAK_BF16_S), (12 * nc, PEAK_F32_S)])
        out["gdn_train_bwd"] = dict(
            max_abs_err=errs[(n, False, torch.bfloat16)][1], ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, shape=[n, c])
        k3_yardsticks(torch, gb, xb, rb, gamma0, ms, bms, mm_ms)
        del xb, gb, rb

        for dt, name in ((torch.bfloat16, "bf16"),
                         (torch.float32, "float32")):
            xt = x32.to(dt)
            ms = cuda_ms(torch, lambda: cg.conv_gdn_train_cuda(
                xt, kernel, gamma, beta), 10)
            plain_ms = cuda_ms(torch, lambda: cg.conv_gdn_train_plain(
                xt, kernel, gamma, beta), 5)
            bms, by, design_ms = k4_bound(xt, cout, want_y=True)
            log(f"conv_gdn_train_fwd {name} {tuple(xt.shape)}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}), {100 * bms / ms:.1f}% of it; design ceiling "
                f"(its TF32 passes) {design_ms:.4f} ms")
            # the line's entry is the float32 mode, the default
            out["conv_gdn_train_fwd"] = dict(
                max_abs_err=conv_err[dt], ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, shape=list(xt.shape))
        del x32
    for name in ("gdn_train_fwd", "gdn_train_bwd"):
        rec = out[name]
        log(f"{name} {rec['shape']} bf16: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), {100 * rec['bound_ms'] / rec['ms']:.1f}% "
            "of it")
    return out


# -- phase 5 -----------------------------------------------------------------


def synthetic_batch(torch):
    """scripts/bench_train.py's synthetic patches: uniform 60..220 plus
    seeded noise, in [0, 1]."""
    rng = np.random.RandomState(0)
    b, p = TRAIN_BATCH, TRAIN_PATCH
    x = np.clip(rng.rand(b, p, p, 3) * 160 + 60
                + rng.randn(b, p, p, 3) * 6, 0, 255).astype(np.float32)
    return torch.from_numpy(x / 255.0).cuda()


@contextlib.contextmanager
def plain_versions():
    """Swap the training path's CUDA wrappers for their plain versions in
    the kernel modules' namespaces for the block: the comparison run."""
    from cnn_autoencoder_tpu_torch.ops.kernels import conv_gdn_kernel as cg
    from cnn_autoencoder_tpu_torch.ops.kernels import gdn_kernel as gk
    swaps = [(gk, "gdn_cuda", gk.gdn_plain),
             (gk, "gdn_bf16_cuda", gk.gdn_plain),
             (gk, "gdn_train_fwd_cuda", gk.gdn_train_fwd_plain),
             (gk, "gdn_train_bwd_cuda", gk.gdn_train_bwd_plain),
             (cg, "conv_gdn_cuda", cg.conv_gdn_plain),
             (cg, "conv_gdn_train_cuda", cg.conv_gdn_train_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_setup(torch, compute_dtype, x):
    """A fresh flagship model from the checkpoint with its optimizers and
    train step; returns (model, criterion, step(i) -> (stats, grads))."""
    from cnn_autoencoder_tpu_torch.criteria.loss import setup_loss
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.training.loop import make_train_step
    from cnn_autoencoder_tpu_torch.training.optim import setup_optimizers
    model = autoencoder_from_state_dict(CHECKPOINT, device="cuda").train()
    trainable = ["encoder", "decoder", "fact_ent"]
    criterion = setup_loss("RateMSE", distortion_lambda=0.01)
    optimizers = setup_optimizers(model, trainable)
    train_step = make_train_step(model, criterion, optimizers,
                                 trainable_modules=trainable,
                                 compute_dtype=compute_dtype)
    lrs = {k: TRAIN_LR for k in optimizers}
    gen = torch.Generator(device="cuda").manual_seed(0)
    return model, criterion, lambda i: train_step(x, lrs, i, generator=gen)


def phase_training(torch):
    """The counted train steps in both modes, the plain comparison, the
    step time, an eval step and a profile; returns the launch counts."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.training.loop import make_eval_step
    x = synthetic_batch(torch)
    totals = {}
    for mode, dtype, rtol in (("float32", torch.float32, 1e-5),
                              ("bf16", torch.bfloat16, 2e-2)):
        model, criterion, step = train_setup(torch, dtype, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # this mode's peak alone
        reset_launch_counts()
        losses, times = [], []
        for i in range(1, TRAIN_STEPS + 1):
            t0 = time.perf_counter()
            stats, grads = step(i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(stats["loss"]))
            if i == 1:
                for module, gs in grads.items():
                    for name, g in gs.items():
                        check(bool(torch.isfinite(g).all())
                              and float(g.abs().max()) > 0,
                              f"{mode} step 1: the gradient of "
                              f"{module}.{name} is zero or not finite")
                n_grads = sum(len(gs) for gs in grads.values())
        launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
        expected = {name: STEP_LAUNCHES[mode].get(name, 0) * TRAIN_STEPS
                    for name in launches}
        log(f"train {mode}: launches over {TRAIN_STEPS} steps {launches}")
        check(launches == expected, f"train {mode}: launches {launches}, "
              f"expected {expected}")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        check(all(np.isfinite(losses)), f"train {mode}: losses {losses}")
        log(f"train {mode}: losses {losses}; step times (ms) "
            f"{[round(t * 1e3, 3) for t in times]}; all {n_grads} "
            "step-1 gradients finite and non-zero")

        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS + 1, TRAIN_STEPS + TIMED_STEPS + 1):
            step(i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        log(f"train {mode}: {ms:.3f} ms per step over {TIMED_STEPS} steps, "
            f"{TRAIN_BATCH / ms * 1e3:.2f} images/s "
            f"(batch {TRAIN_BATCH} x {TRAIN_PATCH}^2); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        eval_stats = make_eval_step(model, criterion, compute_dtype=dtype)(x)
        check(np.isfinite(float(eval_stats["loss"])),
              f"eval {mode}: loss not finite")
        log(f"eval {mode}: loss {float(eval_stats['loss']):.6f}, rate "
            f"{float(eval_stats['rate_loss']):.6f} bpp")
        busy = profile_device(
            torch, lambda: step(TRAIN_STEPS + TIMED_STEPS + 1),
            f"one {mode} train step")
        # the profiler slows the host, so the busy share is also taken
        # against the unprofiled step time
        log(f"train {mode}: device busy {busy * 1e3:.3f} ms of the "
            f"unprofiled {ms:.3f} ms step ({100 * busy * 1e3 / ms:.1f}%)")
        del model, step

        with plain_versions():
            _, _, plain_step = train_setup(torch, dtype, x)
            plain = [float(plain_step(i)[0]["loss"])
                     for i in range(1, TRAIN_STEPS + 1)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
        log(f"train {mode}: plain versions on the card: losses {plain}, "
            f"max relative difference {rel:.3e} (limit {rtol})")
        check(rel <= rtol, f"train {mode}: losses differ from the plain "
              f"versions' by {rel:.3e} > {rtol}")
        del plain_step
        torch.cuda.empty_cache()
    return totals


# -- phase 6 -----------------------------------------------------------------


def scaled_checkpoint(factor, path=CHECKPOINT):
    """A checkpoint's state (the flagship's by default) with the encoder's
    last conv scaled by ``factor``: its latent leaves the coding tables."""
    from cnn_autoencoder_tpu_torch.training.checkpoint import load_checkpoint
    state = dict(load_checkpoint(path))
    enc = state["encoder"]["params"]
    last = sorted(enc)[-1]
    kernel = enc[last]["conv_down"]["kernel"]
    state["encoder"] = {"params": {**enc, last: {"conv_down": {
        "kernel": kernel * np.float32(factor)}}}}
    return state


def v3_frame_bytes(bufs, lengths, cap, s, true_hw):
    """Legacy frame v3 chunks from a v3 writer's (B, S, cap) per-stream word
    buffers and (B, S) word counts: header, byte-length table, then each
    stream's words in turn."""
    import struct
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        LEGACY_VERSION, TURBO_FLAG)
    bufs = np.asarray(bufs).astype("<u2")
    lengths = np.asarray(lengths)
    check(int(lengths.max()) <= cap, "v3 writer: overflow")
    out = []
    for i, (h, w) in enumerate(true_hw):
        used = np.arange(cap)[None, :] < lengths[i][:, None]
        out.append(b"".join([struct.pack(">QQ", h | TURBO_FLAG, w),
                             struct.pack(">BH", LEGACY_VERSION, s),
                             (lengths[i] * 2).astype(">u4").tobytes(),
                             bufs[i][used].tobytes()]))
    return out


def v3_frames(core, sym, true_hw, s=None):
    """Legacy frame v3 of (B, C, lh, lw) symbols over ``s`` streams (the
    core's by default), built with the port's v3 writer
    (``encode_device``) as the JAX package's v3 test builds them."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import (encode_device,
                                                              pack_streams)
    b, _, lh, lw = sym.shape
    s = s or core.num_streams
    packed = pack_streams(sym.reshape(b, -1), s)
    cap = 2 * packed.shape[1] + 8
    bufs, lengths, esc = encode_device(packed, core._ch_map(lh, lw, s),
                                       core.tables, cap)
    check(int(esc) == 0, "v3 writer: escapes")
    return v3_frame_bytes(bufs.cpu().numpy(), lengths.cpu().numpy(), cap, s,
                          true_hw)


def host_coder_check(torch, core):
    """(a) The host coder built from the repository's source, held byte for
    byte to the plain Python coder on one 64^2 crop's symbols, with and
    without escapes."""
    from cnn_autoencoder_tpu_torch.coding import _rans_py, rans
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import is_turbo_frame
    t0 = time.perf_counter()
    rans.load_library()
    log(f"host coder: built in {rans.build_seconds:.2f} s (load "
        f"{time.perf_counter() - t0:.2f} s), {rans.num_threads()} OpenMP "
        f"threads; host CPU {rans.cpu_name()}, {os.cpu_count()} cores")
    base = core.base
    sym = core.latent_symbols(image(64, 64, 99)[None]).cpu().numpy()
    c, lh, lw = sym.shape[1:]
    idx = np.repeat(np.arange(c, dtype=np.int32), lh * lw)
    flat = sym.reshape(-1).astype(np.int32)
    esc = flat.copy()
    rng = np.random.RandomState(5)
    at = rng.choice(esc.size, 24, replace=False)
    esc[at[:8]] = base.offset[idx[at[:8]]] - 1 - rng.randint(0, 500, 8)
    esc[at[8:16]] = (base.offset[idx[at[8:16]]] + base.cdf_length[idx[at[8:16]]]
                     + rng.randint(0, 5000, 8))
    esc[at[16:]] = [-(2 ** 31), 2 ** 31 - 1, -70000, 90000, -1000000,
                    3000000, -(2 ** 30), 2 ** 30]
    for label, s in (("in-table", flat), ("escapes", esc)):
        t0 = time.perf_counter()
        ours = rans.encode_with_indexes(s, idx, base.cdf, base.cdf_length,
                                        base.offset)
        t1 = time.perf_counter()
        plain = _rans_py.encode_with_indexes(
            s.tolist(), idx.tolist(), base.cdf.tolist(),
            base.cdf_length.tolist(), base.offset.tolist())
        t2 = time.perf_counter()
        check(ours == plain, f"host coder ({label}): C++ and plain streams "
              "differ")
        back = rans.decode_with_indexes(ours, idx, base.cdf, base.cdf_length,
                                        base.offset)
        check(np.array_equal(back, s), f"host coder ({label}): round trip "
              "lost symbols")
        log(f"host coder ({label}, {s.size} symbols): byte-identical to the "
            f"plain coder, {len(ours)} bytes; C++ {(t1 - t0) * 1e3:.3f} ms, "
            f"plain {(t2 - t1) * 1e3:.3f} ms")
    check(not is_turbo_frame(base.entropy_encode(sym, [(64, 64)])[0]),
          "a host frame reads as a turbo frame")


def cae_round_trip(torch, core, imgs, mode):
    """(b) The flagship tiles through the CAECodecCore of ``core`` (a
    CAETurboCore at precision ``mode``) on the card: symbols, lossless host
    coding, two decodes of the same symbols bit-equal, reconstructions
    bit-equal to the turbo decode of the same symbols, and MP/s with the
    host coder's share.  Launch counts are reset after the warm-up and read
    just after the timed round trips: the 'cae' path runs K1 (on the
    precision's rows) and K4 and no rANS kernel."""
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    base = core.base
    n = imgs.shape[0]
    mpix = n * imgs.shape[1] * imgs.shape[2] / 1e6
    base.decode_tiles(base.encode_tiles(imgs))          # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    enc_s, dec_s = [], []
    for _ in range(CAE_ROUNDS):
        t0 = time.perf_counter()
        frames = base.encode_tiles(imgs)
        t1 = time.perf_counter()
        rec = base.decode_tiles(frames)
        t2 = time.perf_counter()
        enc_s.append(t1 - t0)
        dec_s.append(t2 - t1)
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    log(f"cae path ({mode}) launches over {CAE_ROUNDS} round trips: "
        f"{launches}")
    for name, count in launches.items():
        check((count > 0) == (name in CAE_KERNELS[mode]),
              f"cae path ({mode}): kernel {name} launched {count} times")
    # the stages of the same round trip, one at a time, over as many rounds
    stages = np.zeros(4)
    for _ in range(CAE_ROUNDS):
        s0 = time.perf_counter()
        sym = base.fetch_symbols(base.encode_tiles_device(imgs))
        s1 = time.perf_counter()
        again = base.entropy_encode(sym, [imgs.shape[1:3]] * n)
        s2 = time.perf_counter()
        sym_d, _ = base.entropy_decode(frames)
        s3 = time.perf_counter()
        rec2 = base.decode_tiles_device(sym_d).cpu().numpy()
        s4 = time.perf_counter()
        stages += np.diff([s0, s1, s2, s3, s4]) * 1e3 / CAE_ROUNDS
    check(again == frames, f"cae ({mode}): the staged encode differs")
    sym_turbo = core.latent_symbols(imgs).cpu().numpy()
    check(sym.dtype == np.int8 and np.array_equal(sym, sym_turbo),
          f"cae ({mode}): symbols differ from CAETurboCore.latent_symbols")
    check(np.array_equal(sym_d, sym), f"cae ({mode}): decoded symbols differ")
    turbo_frames = core.encode_tiles(imgs)
    check(not torch.backends.cudnn.deterministic,
          "cudnn.deterministic is set")
    check(np.array_equal(rec2, rec), f"cae ({mode}): two decodes of the "
          "same symbols differ")
    check(np.array_equal(core.decode_tiles(turbo_frames), rec),
          f"cae ({mode}): reconstructions differ from the turbo decode of "
          "the same symbols")
    cae_bytes = sum(len(f) for f in frames) / n
    turbo_bytes = sum(len(f) for f in turbo_frames) / n
    enc, dec = np.mean(enc_s), np.mean(dec_s)
    log(f"cae codec ({mode}): {n} tiles of {imgs.shape[1]}x{imgs.shape[2]}, "
        f"symbols equal to the turbo core's, lossless; mean of {CAE_ROUNDS} "
        "rounds: "
        f"encode {mpix / enc:.3f} MP/s ({enc * 1e3:.1f} ms, rounds "
        f"{min(enc_s) * 1e3:.1f} to {max(enc_s) * 1e3:.1f}), decode "
        f"{mpix / dec:.3f} MP/s ({dec * 1e3:.1f} ms, rounds "
        f"{min(dec_s) * 1e3:.1f} to {max(dec_s) * 1e3:.1f}); "
        "two decodes bit-equal, and to the turbo decode")
    log(f"cae stages ({mode}), mean of {CAE_ROUNDS} rounds: device encode + "
        "int8 "
        f"fetch {stages[0]:.1f} ms, host rANS encode {stages[1]:.1f} ms, "
        f"host rANS decode {stages[2]:.1f} ms, upload + device decode + "
        f"fetch {stages[3]:.1f} ms; {cae_bytes:.1f} bytes a tile "
        f"({8 * cae_bytes / (imgs.shape[1] * imgs.shape[2]):.4f} bpp) "
        f"against the turbo frames' {turbo_bytes:.1f}")


def fallback_checks(torch, model, core, imgs):
    """(c) Batches the device coder cannot take: one symbol pushed out of
    its table, a flagship copy whose encoder's last conv is scaled (whole
    tiles escape), and six capacities that all overflow at S = 16.  Each
    writes host frames that decode to the reconstruction of its
    symbols."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        CAETurboCore, is_turbo_frame)

    def held(label, core, sym, frames, retries=None):
        hw = [imgs.shape[1:3]] * sym.shape[0]
        check(not any(is_turbo_frame(f) for f in frames),
              f"{label}: not every frame is a host frame")
        check(np.array_equal(core.base.entropy_decode(frames)[0],
                             sym.cpu().numpy()), f"{label}: lost symbols")
        rec = core.decode_tiles(frames)
        want = core.reconstruct(sym, *hw[0])
        check(np.array_equal(rec, want), f"{label}: reconstruction differs "
              "from that of its symbols")
        log(f"fallback ({label}): {len(frames)} host frames, "
            f"{sum(len(f) for f in frames) / len(frames):.1f} bytes a tile, "
            f"lossless, reconstruction equal"
            + ("" if retries is None else f"; {retries} capacity retries"))

    hw = [imgs.shape[1:3]] * 2
    sym = core.latent_symbols(imgs[:2])
    sym[0, 3, 0, 0] = int(core.tables.offset[3]) - 5
    before = core.host_fallbacks
    frames = core.frames_from_symbols(sym, hw)
    check(core.host_fallbacks == before + 1, "one-symbol escape: no fallback")
    held("one symbol out", core, sym, frames)

    scaled = CAETurboCore(autoencoder_from_state_dict(
        scaled_checkpoint(100.0), device="cuda"), num_streams=1024,
        device="cuda")
    sym = scaled.latent_symbols(imgs[:2])
    n_esc = int(scaled.escapes(sym).sum())
    frames = scaled.encode_tiles(imgs[:2])
    check(scaled.host_fallbacks == 1, "scaled encoder: no fallback")
    held(f"scaled encoder, {n_esc} of {sym.numel()} symbols escape",
         scaled, sym, frames)
    del scaled

    narrow = CAETurboCore(model, num_streams=16, device="cuda")
    narrow.expected_bits = 0.0
    sym = narrow.latent_symbols(imgs[:2])
    frames = narrow.encode_tiles(imgs[:2])
    check(narrow.host_fallbacks == 1 and narrow.capacity_retries == 5,
          f"six capacities at S = 16: {narrow.host_fallbacks} fallbacks, "
          f"{narrow.capacity_retries} retries")
    held("six capacities at S = 16", narrow, sym, frames,
         narrow.capacity_retries)


def mixed_batch_check(torch, core, imgs):
    """(d) One decode batch of v4, host and v3 frames and a 500 x 300 tile:
    each tile equal to its own format's decode."""
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import is_turbo_frame
    tiles = imgs[:3]
    hw = [tiles.shape[1:3]] * 3
    v4 = core.encode_tiles(tiles)
    host = core.base.encode_tiles(tiles)
    v3 = v3_frames(core, core.latent_symbols(tiles), hw)
    odd = image(500, 300, 77)
    odd_frame = core.encode_tiles(odd[None])[0]
    check(all(is_turbo_frame(f) for f in v4 + v3 + [odd_frame])
          and not any(is_turbo_frame(f) for f in host),
          "mixed batch: frame formats")
    batch = [v4[0], host[1], v3[2], odd_frame, host[0], v3[0], v4[1]]
    t0 = time.perf_counter()
    core.decode_tiles(batch)
    ms = (time.perf_counter() - t0) * 1e3
    groups = {"v4": ([0, 6], [v4[0], v4[1]]), "host": ([1, 4],
                                                      [host[1], host[0]]),
              "v3": ([2, 5], [v3[2], v3[0]]), "odd": ([3], [odd_frame])}
    recs = core.decode_tiles(batch)
    check(isinstance(recs, list) and len(recs) == len(batch),
          "mixed batch: not a list of 7 tiles")
    for name, (where, frames) in groups.items():
        alone = core.decode_tiles(frames)
        for i, r in zip(where, alone):
            check(np.array_equal(recs[i], r),
                  f"mixed batch: tile {i} ({name}) differs from its own "
                  "format's decode")
    check(recs[3].shape == (500, 300, 3), "mixed batch: odd tile shape")
    sym_v3 = core.symbols_from_frames_v3(v3, core.num_streams,
                                         *tiles.shape[1:3])
    check(torch.equal(sym_v3, core.latent_symbols(tiles)),
          "v3 frames: decoded symbols differ")
    log(f"mixed batch (v4, host, v3 and a 500x300 tile, 7 frames): each "
        f"tile equal to its own format's decode, {ms:.1f} ms; v3 symbols "
        "lossless")


def bottleneck_check(torch, model, imgs):
    """(e) 'cae_bn' on one tile's float latent: a lossless round trip past
    quantization."""
    from cnn_autoencoder_tpu_torch.storage.cae_codec import \
        ConvolutionalAutoencoderBottleneck
    from cnn_autoencoder_tpu_torch.storage.codecs import get_codec
    with torch.no_grad():
        y = model.encoder(torch.from_numpy(imgs[:1]).cuda().float() / 255.0)
    y = y[0].cpu().numpy()
    codec = ConvolutionalAutoencoderBottleneck(
        model.channels_bn, fact_ent=model.fact_ent.params())
    t0 = time.perf_counter()
    buf = codec.encode(y)
    t1 = time.perf_counter()
    out = get_codec(codec.get_config()).decode(buf)
    t2 = time.perf_counter()
    want = np.round(y - codec.medians) + codec.medians
    check(np.array_equal(out, want), "cae_bn: round trip differs from the "
          "quantized latent")
    log(f"cae_bn: {y.shape} float latent, {len(buf)} bytes, lossless past "
        f"quantization; encode {(t1 - t0) * 1e3:.2f} ms, decode "
        f"{(t2 - t1) * 1e3:.2f} ms")


def phase_codecs(torch, model, core, core16):
    """Phase 6: the host coder and every CAE codec; the 'cae' round trip
    at both precisions (``core16``: the bf16 turbo core)."""
    t0 = time.perf_counter()
    host_coder_check(torch, core)
    imgs = np.stack([image(512, 512, seed) for seed in range(TILES)])
    cae_round_trip(torch, core, imgs, "float32")
    cae_round_trip(torch, core16, imgs, "bf16")
    fallback_checks(torch, model, core, imgs)
    mixed_batch_check(torch, core, imgs)
    bottleneck_check(torch, model, imgs)
    log(f"codec phase: {time.perf_counter() - t0:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from cnn_autoencoder_tpu_torch.models.factory import \
            autoencoder_from_state_dict
        from cnn_autoencoder_tpu_torch.storage.turbo_codec import \
            CAETurboCore
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 2
    check(os.path.exists(CHECKPOINT), f"missing {CHECKPOINT}")

    phase_device(torch)
    model = autoencoder_from_state_dict(CHECKPOINT, device="cuda")
    core = CAETurboCore(model, num_streams=1024, device="cuda")
    records = phase_kernels(torch, model, core, TILES)
    launches, core16 = phase_end_to_end(torch, model, core, TILES)
    records.update(phase_train_kernels(torch, model))
    for name, n in phase_training(torch).items():
        launches[name] += n
    check(all(launches[name] > 0 for name in records),
          f"a kernel was not launched on the main paths: {launches}")
    phase_codecs(torch, model, core, core16)

    kernels = []
    for name, rec in records.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
