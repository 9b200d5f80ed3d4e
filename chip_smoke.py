#!/usr/bin/env python3
"""Drive the PyTorch port (``cnn_autoencoder_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build the CUDA kernels from ``cnn_autoencoder_tpu_torch/csrc``.
2. Kernels: each kernel's wrapper on card tensors at the shapes the
   serving path gives it (16 tiles of 512^2 through the flagship), held
   against its plain PyTorch version on the same inputs, then timed with
   CUDA events beside the plain version.
3. End to end: the flagship checkpoint through ``CAETurboCore`` (the
   ``cae_tpu`` codec's batched core), ``encode_tiles`` then ``decode_tiles``
   on 16 synthetic 512^2 tiles, with launch counts reset just before and
   read just after; then the same tiles through the plain versions on the
   card; then one tile through the ``cae_tpu`` codec object; then the
   device time by operation of one more round trip (torch.profiler).
4. One JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

It needs a CUDA card and the repository around it; without either it exits
non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "benchmarks", "bench_flagship.msgpack")
TILES = 16          # tiles of 512^2 in the serving batch

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12        # float32 on the CUDA cores (no tensor cores)
# 32-bit integer operations issue on 64 of the 128 lanes of each SM
# (Hopper white paper): half the float32 rate
PEAK_I32_S = PEAK_F32_S / 2

# (name, TPU kernel it replaces)
REPLACES = {
    "gdn_fwd": "cnn_autoencoder_tpu/ops/pallas/gdn_kernel.py:71",
    "conv_gdn_fwd": "cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:53",
    "rans_encode": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:319",
    "rans_decode": "cnn_autoencoder_tpu/ops/pallas/rans_kernel.py:119",
}
SOURCES = {
    "gdn_fwd": "cnn_autoencoder_tpu_torch/csrc/gdn.cu",
    "conv_gdn_fwd": "cnn_autoencoder_tpu_torch/csrc/conv_gdn.cu",
    "rans_encode": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
    "rans_decode": "cnn_autoencoder_tpu_torch/csrc/rans.cu",
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def bound_ms(nbytes, ops, op_rate):
    """(least time in ms, 'bytes' or 'operations')."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / op_rate
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
    build.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())


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

    for n, c in ((1000, 48), (77, 130), (5, 3)):
        x = torch.from_numpy(rng.randn(n, c).astype(np.float32)).cuda()
        gamma, beta = params(c)
        for inverse in (False, True):
            got = gdn_kernel.gdn_cuda(x, gamma, beta, inverse)
            ref = gdn_kernel.gdn_plain(x, gamma, beta, inverse)
            rel = float(((got - ref).abs()
                         / ref.abs().clamp_min(1e-30)).max())
            check(rel <= 1e-5, f"gdn_fwd ({n}, {c}) inverse={inverse}: "
                  f"max relative error {rel:.3e}")
    for shape, cout in (((2, 18, 14, 72), 40), ((1, 4, 6, 64), 128),
                        ((1, 2, 2, 3), 5)):
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
        kernel = torch.from_numpy((rng.randn(3, 3, shape[3], cout) * 0.05)
                                  .astype(np.float32)).cuda()
        gamma, beta = params(cout)
        got = conv_gdn_kernel.conv_gdn_cuda(x, kernel, gamma, beta)
        ref = conv_gdn_kernel.conv_gdn_plain(x, kernel, gamma, beta)
        err = float((got - ref).abs().max())
        check(got.shape == ref.shape and err <= 1e-4 * float(
            ref.abs().max()), f"conv_gdn_fwd {shape} -> {cout}: error {err}")
    for shape, cout in (((1, 4, 4, 64), 129), ((1, 5, 4, 64), 64)):
        x = torch.zeros(shape, device="cuda")
        gamma, beta = params(cout)
        try:
            conv_gdn_kernel.conv_gdn_cuda(
                x, torch.zeros((3, 3, 64, cout), device="cuda"), gamma, beta)
        except ValueError:
            continue
        raise SmokeError(f"conv_gdn_fwd took {shape} -> {cout}")
    torch.cuda.synchronize()
    log("gdn_fwd and conv_gdn_fwd agree with their plain versions at ragged "
        "shapes; conv_gdn_fwd refuses Cout > 128 and odd H")


def phase_kernels(torch, model, core, tiles):
    """Every kernel against its plain version at the serving path's shapes;
    returns {name: record}."""
    from cnn_autoencoder_tpu_torch.coding.device_rans import (
        DeviceTables, pack_streams, stream_channel_map)
    from cnn_autoencoder_tpu_torch.ops.kernels import (conv_gdn_kernel,
                                                       gdn_kernel,
                                                       rans_kernel)
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    b, h, w = tiles, 512, 512
    out = {}
    edge_geometries(torch, rng)

    # K1: GDN over (B*256^2, 128) rows, flagship down_0 / up_1 parameters
    with torch.no_grad():
        for inverse, unit, gdn_name in ((False, model.encoder.down_0,
                                         "gdn_down"),
                                        (True, model.decoder.up_1, "gdn_up")):
            gamma, beta = getattr(unit, gdn_name).effective_params()
            c = gamma.shape[0]
            x = torch.from_numpy(
                rng.randn(b * (h // 2) * (w // 2), c).astype(np.float32)
                * 0.5).to(dev)
            got = gdn_kernel.gdn_cuda(x, gamma, beta, inverse)
            ref = gdn_kernel.gdn_plain(x, gamma, beta, inverse)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "gdn_fwd: non-finite")
            err = (got - ref).abs()
            rel = float((err / ref.abs().clamp_min(1e-30)).max())
            log(f"gdn_fwd inverse={inverse} {tuple(x.shape)}: max abs "
                f"{float(err.max()):.3e} max rel {rel:.3e}")
            check(rel <= 1e-5, f"gdn_fwd inverse={inverse}: max relative "
                  f"error {rel:.3e} > 1e-5")
            if not inverse:
                n = x.shape[0]
                ms = cuda_ms(torch, lambda: gdn_kernel.gdn_cuda(
                    x, gamma, beta, False), 20)
                plain_ms = cuda_ms(torch, lambda: gdn_kernel.gdn_plain(
                    x, gamma, beta, False), 10)
                bms, by = bound_ms(8 * n * c + 4 * c * (c + 1),
                                   n * c * (2 * c + 5), PEAK_F32_S)
                out["gdn_fwd"] = dict(max_abs_err=float(err.max()), ms=ms,
                                      plain_ms=plain_ms, bound_ms=bms,
                                      bound_by=by, shape=list(x.shape))
            del x, got, ref, err

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
        npix = b * (h // 4) * (w // 4)
        bms, by = bound_ms(
            4 * (x.numel() + kernel.numel() + cout * (cout + 1)
                 + npix * cout),
            npix * (2 * 9 * cin * cout + cout * (2 * cout + 5)), PEAK_F32_S)
        out["conv_gdn_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bms, bound_by=by,
                                   shape=list(x.shape))
        del x, got, ref

    # K6 / K5: rANS on symbols drawn from the flagship tables at the serving
    # geometry (latent 64x64x48, S = 1024: T = 192), then a peaked table
    # (freq > 2^11, states above 2^31) and a plane that is not a multiple
    # of S (steps that span two channels)
    tables = core.tables
    s = core.num_streams
    cases = []
    ch_map = core._ch_map(64, 64, s)
    sym = torch.from_numpy(sample_symbols(tables, ch_map, b, 1)).to(dev)
    cases.append(("flagship 64x64", sym, ch_map, tables))
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
    odd_sym = pack_streams(torch.from_numpy(odd), s).to(dev)
    check(bool((odd_map != odd_map[:, :1]).any()),
          "the 60x60 geometry should have multi-channel steps")
    cases.append(("plane 60x60 (not a multiple of S)", odd_sym, odd_map,
                  tables))

    s100_map = torch.from_numpy(stream_channel_map(48, (8, 8), 100)).to(dev)
    cases.append(("100 streams", torch.from_numpy(sample_symbols(
        tables, s100_map, 3, 3)).to(dev), s100_map, tables))

    for label, sym, cmap, tab in cases:
        t, s_c = cmap.shape
        lut = rans_kernel.pack_dec_lut(tab.freq, tab.start, tab.slot)
        for cap in (2 * s_c + t * s_c, 2 * s_c + 100):
            words, totals = rans_kernel.encode_interleaved_cuda(
                sym, cmap, tab.freq, tab.start, tab.offset, cap)
            words_p, totals_p = rans_kernel.rans_encode_plain(
                sym, cmap, tab.freq, tab.start, tab.offset, cap)
            torch.cuda.synchronize()
            check(torch.equal(totals, totals_p), f"rans_encode {label} "
                  f"capacity {cap}: totals differ from the plain version")
            check(torch.equal(words, words_p), f"rans_encode {label} "
                  f"capacity {cap}: words differ from the plain version")
        words, totals = rans_kernel.encode_interleaved_cuda(
            sym, cmap, tab.freq, tab.start, tab.offset, 2 * s_c + t * s_c)
        # whole queues, and queues cut short (reads clamp to the last word)
        for q in (words, words[:, :int(totals.min()) // 2].contiguous()):
            vals = rans_kernel.decode_interleaved_cuda(q, cmap, lut, t)
            vals_p = rans_kernel.rans_decode_plain(q, cmap, lut, t)
            torch.cuda.synchronize()
            check(torch.equal(vals, vals_p), f"rans_decode {label} queue "
                  f"{q.shape[1]}: differs from the plain version")
            if q is words:
                check(torch.equal(vals + tab.offset[cmap.long()][None], sym),
                      f"rans_decode {label}: does not give back the symbols")
        log(f"rans {label}: {tuple(sym.shape)} {int(totals.sum())} words, "
            "encode (full and short capacity) and decode (whole and cut "
            "queues) bit-identical to the plain versions")

    label, sym, cmap, tab = cases[0]
    t = cmap.shape[0]
    cap = 2 * s + t * s
    words, totals = rans_kernel.encode_interleaved_cuda(
        sym, cmap, tab.freq, tab.start, tab.offset, cap)
    lut = rans_kernel.pack_dec_lut(tab.freq, tab.start, tab.slot)
    n_words = int(totals.sum())
    enc_ms = cuda_ms(torch, lambda: rans_kernel.encode_interleaved_cuda(
        sym, cmap, tab.freq, tab.start, tab.offset, cap), 20)
    enc_plain = cuda_ms(torch, lambda: rans_kernel.rans_encode_plain(
        sym, cmap, tab.freq, tab.start, tab.offset, cap), 3)
    table_bytes = 4 * (2 * tab.freq.numel() + tab.offset.numel())
    # about a dozen integer operations per symbol and step
    bms, by = bound_ms(4 * (sym.numel() + cmap.numel() + n_words + b)
                       + table_bytes, 12 * sym.numel(), PEAK_I32_S)
    out["rans_encode"] = dict(max_abs_err=0.0, ms=enc_ms, plain_ms=enc_plain,
                              bound_ms=bms, bound_by=by,
                              shape=list(sym.shape))
    dec_ms = cuda_ms(torch, lambda: rans_kernel.decode_interleaved_cuda(
        words, cmap, lut, t), 20)
    dec_plain = cuda_ms(torch, lambda: rans_kernel.rans_decode_plain(
        words, cmap, lut, t), 3)
    bms, by = bound_ms(4 * (n_words + cmap.numel() + lut.numel()
                            + sym.numel()), 12 * sym.numel(), PEAK_I32_S)
    out["rans_decode"] = dict(max_abs_err=0.0, ms=dec_ms, plain_ms=dec_plain,
                              bound_ms=bms, bound_by=by,
                              shape=list(sym.shape))
    for name, rec in out.items():
        log(f"{name} {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
    return out


# -- phase 3 -----------------------------------------------------------------


def plain_reconstruct(torch, model, core, tiles_u8):
    """The serving round trip through the plain versions only, on the card:
    (symbols (B, C, lh, lw), u8 reconstruction (B, H, W, 3))."""
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

    with torch.no_grad():
        x = torch.from_numpy(tiles_u8).cuda().float() / 255.0
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
        sym = torch.round(x - core._med).to(torch.int32)
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
        y = dec.permute(0, 2, 3, 1).float() + core._med
        for name in model.decoder.names:
            unit = getattr(model.decoder, name)
            y = unit.deconv_up(y)
            if unit.act == "GDN":
                y = gdn(y, unit.gdn_up, True)
            else:
                check(unit.act is None, f"{name}: activation {unit.act}")
        rec = torch.clamp(y * 255.0, 0, 255).to(torch.uint8)
    return sym, rec.cpu().numpy()


def phase_end_to_end(torch, model, core, tiles):
    from cnn_autoencoder_tpu_torch.ops.kernels import (kernel_wrappers,
                                                       reset_launch_counts)
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import (
        ConvolutionalAutoencoderTurbo, is_turbo_frame)

    imgs = np.stack([image(512, 512, seed) for seed in range(tiles)])
    mpix = imgs.shape[0] * 512 * 512 / 1e6

    # warm-up pass (cuDNN plans, allocator), then the counted, timed pass
    core.decode_tiles(core.encode_tiles(imgs))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    frames = core.encode_tiles(imgs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = core.decode_tiles(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {fn.kernel_name: fn.launches for fn in kernel_wrappers()}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

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
    bpp = 8.0 * sum(len(f) for f in frames) / (imgs.shape[0] * 512 * 512)
    log(f"end to end: {tiles} tiles of 512^2, all turbo, symbols lossless; "
        f"PSNR {psnr:.3f} dB, {bpp:.4f} bpp; encode {mpix / (t1 - t0):.3f} "
        f"MP/s ({(t1 - t0) * 1e3:.1f} ms), decode {mpix / (t2 - t1):.3f} "
        f"MP/s ({(t2 - t1) * 1e3:.1f} ms)")

    sym_p, rec_p = plain_reconstruct(torch, model, core, imgs)
    flips = float((sym_p != sym_enc).float().mean())
    diff = np.abs(rec_p.astype(np.int32) - rec)
    frac = float(np.mean(diff != 0))
    log(f"plain versions on the card: symbol flips {flips:.3e}, u8 pixels "
        f"differing {frac:.3e}, max difference {int(diff.max())}")
    check(flips <= 1e-4, f"symbol flips {flips:.3e} > 1e-4")
    check(frac < 5e-3 and int(diff.max()) <= 1,
          "plain and kernel reconstructions differ beyond 0.5% / 1 level")

    # the codec object a zarr store holds, on one tile
    codec = ConvolutionalAutoencoderTurbo(CHECKPOINT, num_streams=1024)
    buf = codec.encode(imgs[0])
    check(buf == frames[0], "codec.encode differs from encode_tiles")
    # cuDNN may pick another convolution algorithm for a batch of one, so
    # the reconstruction is held to the u8 tolerance, not bit equality
    diff = np.abs(codec.decode(buf).astype(np.int32) - rec[0])
    check(np.mean(diff != 0) < 5e-3 and int(diff.max()) <= 1,
          "codec.decode differs from decode_tiles beyond 0.5% / 1 level")
    profile_round_trip(torch, core, imgs)
    return launches


def profile_round_trip(torch, core, imgs):
    """Device time by operation over one more encode_tiles + decode_tiles,
    and the share of the wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        core.decode_tiles(core.encode_tiles(imgs))
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
    log(f"profile: wall {wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
        f"({100 * busy / wall:.1f}%)")
    for us, count, key in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")


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
    launches = phase_end_to_end(torch, model, core, TILES)

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
