#!/usr/bin/env python3
"""Time the forms of the port's stride-2 transposed convolution on a CUDA
card, at the flagship decoder's deconvs for 16 tiles of 512^2.

    python3 scripts/torch_deconv_forms.py      # from the root of a checkout

Each of ``up_0`` (48 -> 128 at 64^2), ``up_1`` (128 -> 128 at 128^2) and
``up_2`` (128 -> 3 at 256^2), with the flagship's weights and seeded
inputs, in float32 and bf16, through:

* ``port``: ``ConvTranspose2dTorch`` itself;
* ``phase products`` and ``one product``: the port's two forms
  (``ops/convops.py``), one product per output parity phase of a window
  of shifted rows against its taps stacked, in the rows' type with float32
  sums, and one float32 product (bf16 operands upcast) against all nine
  taps followed by the phases' sums over shifted slices;
  ``ConvTranspose2dTorch`` takes the first where 9 Cout > 4 Cin;
* ``nine taps``: one float32 product per tap (``torch.addmm`` chains over
  shifted rows of the padded grid, the bias the first addend of each
  phase);
* ``one product, bf16 mm`` (bf16 only): the one-product form with the
  product on the bf16 tensor cores and float32 output
  (``torch.mm(..., out_dtype=torch.float32)``, which has no gradient);
* cuDNN's ``F.conv_transpose2d`` at its default algorithms and with
  ``torch.backends.cudnn.deterministic`` (timings only).

Prints, per layer and form, the CUDA-event mean ms, whether three runs are
bit-equal, and the largest difference from the port's form; then the sum
of the three layers per form.
"""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHECKPOINT = os.path.join(ROOT, "benchmarks", "bench_flagship.msgpack")
TILES = 16
REPS = 20


def cuda_ms(torch, fn, reps=REPS):
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


def nine_taps(torch, x, weight, bias):
    """The nine-product form: with the rows of x padded by a row and a
    column of zeros, x[i, j + dj] and x[i + di, j] are the rows 1 and
    W + 1 further on, so every term is one addmm over a slice of them."""
    import torch.nn.functional as F
    from cnn_autoencoder_tpu_torch.utils.device import full_f32
    b, h, w, cin = x.shape
    cout = weight.shape[1]
    rows = F.pad(x, (0, 0, 0, 1, 0, 1)).reshape(-1, cin).float()
    rows = F.pad(rows, (0, 0, 0, w + 2))
    m = b * (h + 1) * (w + 1)
    wf = weight.float()
    bias = (torch.zeros(cout, device=x.device) if bias is None
            else bias.float())

    def phase(*terms):
        acc = bias.expand(m, cout)
        with full_f32():
            for ky, kx, off in terms:
                acc = torch.addmm(acc, rows[off:off + m], wf[:, :, ky, kx])
        return acc.view(b, h + 1, w + 1, cout)[:, :h, :w]

    s = w + 1
    ee = phase((1, 1, 0))
    eo = phase((1, 2, 0), (1, 0, 1))
    oe = phase((2, 1, 0), (0, 1, s))
    oo = phase((2, 2, 0), (2, 0, 1), (0, 2, s), (0, 0, s + 1))
    out = torch.stack([torch.stack([ee, eo], 3), torch.stack([oe, oo], 3)],
                      2).reshape(b, 2 * h, 2 * w, cout)
    return out.to(x.dtype)


def one_product_bf16_mm(torch, x, weight, bias):
    """The one-product form with a bf16 product and float32 output."""
    import torch.nn.functional as F
    from cnn_autoencoder_tpu_torch.utils.device import full_f32
    b, h, w, cin = x.shape
    cout = weight.shape[1]
    rows = F.pad(x, (0, 0, 0, 1, 0, 1)).reshape(-1, cin)
    taps = weight.permute(0, 2, 3, 1).reshape(cin, 9 * cout)
    with full_f32():
        prod = torch.mm(rows, taps, out_dtype=torch.float32)
    prod = prod.view(b, h + 1, w + 1, 3, 3, cout)

    def tap(ky, kx, di, dj):
        return prod[:, di:di + h, dj:dj + w, ky, kx]

    ee = tap(1, 1, 0, 0)
    eo = tap(1, 2, 0, 0) + tap(1, 0, 0, 1)
    oe = tap(2, 1, 0, 0) + tap(0, 1, 1, 0)
    oo = tap(2, 2, 0, 0) + tap(2, 0, 0, 1) + tap(0, 2, 1, 0) + tap(0, 0, 1, 1)
    out = torch.stack([torch.stack([ee, eo], 3), torch.stack([oe, oo], 3)],
                      2).reshape(b, 2 * h, 2 * w, cout)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_deconv_forms: no CUDA device", file=sys.stderr)
        return 2
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.ops.convops import (
        _conv_operands, _deconv2x_one_product, _deconv2x_phase_products)
    from cnn_autoencoder_tpu_torch.utils.device import full_f32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), f"torch {torch.__version__}", flush=True)
    model = autoencoder_from_state_dict(CHECKPOINT, device="cuda").eval()
    rng = np.random.RandomState(0)
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, name in enumerate(model.decoder.names):
            mod = getattr(model.decoder, name).deconv_up
            cin = mod.weight.shape[0]
            side = 64 * 2 ** i
            x = torch.from_numpy(rng.randn(TILES, side, side, cin)
                                 .astype(np.float32) * 0.5).cuda().to(dtype)
            weight, bias = _conv_operands(x, mod.weight.detach(), mod.bias)

            def cudnn():
                with full_f32():
                    return F.conv_transpose2d(
                        x.permute(0, 3, 1, 2), weight, bias, stride=2,
                        padding=1, output_padding=1).permute(0, 2, 3, 1)

            def cudnn_det():
                torch.backends.cudnn.deterministic = True
                try:
                    return cudnn()
                finally:
                    torch.backends.cudnn.deterministic = False

            def port_form(fn):
                def run():
                    with full_f32():
                        return fn(x, weight, bias)
                return run

            forms = {
                "port": lambda: mod(x),
                "phase products": port_form(_deconv2x_phase_products),
                "one product": port_form(_deconv2x_one_product),
                "nine taps": lambda: nine_taps(torch, x, weight, bias)}
            if dtype == torch.bfloat16:
                forms["one product, bf16 mm"] = lambda: one_product_bf16_mm(
                    torch, x, weight, bias)
            forms["cudnn default"] = cudnn
            forms["cudnn deterministic"] = cudnn_det
            with torch.no_grad():
                ref = mod(x).float()
                for form, fn in forms.items():
                    try:
                        outs = [fn() for _ in range(3)]
                    except (RuntimeError, TypeError) as exc:
                        print(f"{name} {str(dtype)[6:]} {form}: "
                              f"unavailable ({exc})", flush=True)
                        continue
                    same = all(torch.equal(outs[0], o) for o in outs[1:])
                    diff = float((outs[0].float() - ref).abs().max())
                    ms = cuda_ms(torch, fn)
                    key = (str(dtype)[6:], form)
                    totals[key] = totals.get(key, 0.0) + ms
                    print(f"{name} {tuple(x.shape)} -> "
                          f"{tuple(outs[0].shape)} {str(dtype)[6:]} {form}: "
                          f"{ms:.4f} ms, three runs bit-equal {same}, max "
                          f"|diff| from the port's {diff:.3e}", flush=True)
                    del outs
            del x
            torch.cuda.empty_cache()
    for (dt, form), ms in totals.items():
        print(f"three deconvs {dt} {form}: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
