"""Inputs made from ``--seed``, on the device, in a few large calls: the
synthetic histology slide and a configuration's initial weights.  The
benchmark hands the same tensors to the program and to the reference.

``slide`` is the formula of the JAX package's ``bench.py:127``
(``synth_histology``, copied in the port as ``tools/rd_sweep.py``): a
(h / 64 + 2, w / 64 + 2, 3) grid of uniform values, bilinearly
interpolated every 64 pixels, times 120 plus 110, plus Gaussian stain
noise of 6, clipped and truncated to uint8.  It draws from a
``torch.Generator`` on the device instead of numpy's, so a 7168 x 6144
slide takes milliseconds: the same distribution, not the same bytes.

``init_tree`` draws a configuration's weights in the checkpoint format
(``reference/cae.py``) with the initialisers of the model (the port's
``models/factory.py:build_model``): convolutions and transposed
convolutions xavier-uniform with gain sqrt(2 / 1.01) (fans 9 Cin and
9 Cout), GDN ``beta`` 1 and ``gamma`` 0.1 I stored reparameterized, the
bottleneck's constant matrices, biases U(-0.5, 0.5), zero factors and
quantiles (-10, 0, 10); every uniform draw is one slice of one call.
"""

import math
from typing import Dict, List, Tuple

import torch

from . import roofline

PEDESTAL = 2.0 ** -36
GAIN = math.sqrt(2.0 / 1.01)
INIT_SCALE = 10.0


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def slide(h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(h, w, 3) uint8 synthetic histology on ``device``."""
    small = torch.rand((h // 64 + 2, w // 64 + 2, 3), generator=gen,
                       device=device, dtype=torch.float64)
    iy = torch.arange(h, device=device, dtype=torch.float64) / 64.0
    ix = torch.arange(w, device=device, dtype=torch.float64) / 64.0
    y0, x0 = iy.long(), ix.long()
    fy = (iy - y0)[:, None, None]
    fx = (ix - x0)[None, :, None]
    a = small[y0][:, x0]
    b = small[y0][:, x0 + 1]
    c = small[y0 + 1][:, x0]
    d = small[y0 + 1][:, x0 + 1]
    img = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
           + c * fy * (1 - fx) + d * fy * fx)
    noise = torch.randn((h, w, 3), generator=gen, device=device,
                        dtype=torch.float32)
    img = img.float() * 120 + 110 + noise * 6
    return torch.clamp(img, 0, 255).to(torch.uint8)


def tiles(img: torch.Tensor, side: int) -> torch.Tensor:
    """(H, W, 3) -> (H / side * W / side, side, side, 3), row-major."""
    h, w, c = img.shape
    t = img.reshape(h // side, side, w // side, side, c).permute(0, 2, 1, 3,
                                                                 4)
    return t.reshape(-1, side, side, c).contiguous()


def _layout(config) -> List[Tuple[str, str, tuple, object]]:
    """(module path, leaf, shape, init) for every leaf, in a fixed order;
    init is ("xavier", a), ("const", value), ("uniform",) or ("gdn", c)."""
    res = bool(config.get("use_residual"))
    enc, dec = roofline.stages(config)
    out = []

    def conv(path, cin, cout):
        a = GAIN * math.sqrt(6.0 / (9 * cin + 9 * cout))
        out.append((path, "kernel", (3, 3, cin, cout), ("xavier", a)))

    def gdn(path, c):
        out.append((path, "beta", (c,), ("const", math.sqrt(1.0 + PEDESTAL))))
        out.append((path, "gamma", (c, c), ("gdn", c)))

    for i, (cin, cout, act) in enumerate(enc):
        u = f"encoder/down_{i}"
        if res:
            conv(u + "/res_conv1", cin, cin)
            if act:
                gdn(u + "/gdn_res", cin)
        conv(u + "/conv_down", cin, cout)
        if act:
            gdn(u + "/gdn_down", cout)
    for i, (cin, cout, act) in enumerate(dec):
        u = f"decoder/up_{i}"
        if res:
            conv(u + "/res_deconv1", cin, cin)
            if act:
                gdn(u + "/gdn_res", cin)
        conv(u + "/deconv_up", cin, cout)
        if act:
            gdn(u + "/gdn_up", cout)
    k = int(config.get("K", 4))
    r = int(config.get("r", 3))
    ext = (1,) + (r,) * k + (1,)
    scale = INIT_SCALE ** (1.0 / (k + 1))
    cb = config["channels_bn"]
    for i in range(k + 1):
        v = math.log(math.expm1(1.0 / scale / ext[i + 1]))
        out.append(("fact_ent", f"matrix_{i}", (cb, ext[i + 1], ext[i]),
                    ("const", v)))
        out.append(("fact_ent", f"bias_{i}", (cb, ext[i + 1], 1),
                    ("uniform",)))
        if i < k:
            out.append(("fact_ent", f"factor_{i}", (cb, ext[i + 1], 1),
                        ("const", 0.0)))
    out.append(("fact_ent", "quantiles", (cb, 1, 3), ("quantiles",)))
    return out


def init_tree(config, gen: torch.Generator, device) -> Dict:
    """The configuration's initial weights as a checkpoint's trees
    (``{"encoder": {"params": {...}}, ...}``, float32 tensors on
    ``device``), drawn by one ``torch.rand`` call."""
    layout = _layout(config)
    sizes = [math.prod(shape) for _, _, shape, init in layout
             if init[0] in ("xavier", "uniform")]
    draw = torch.rand(sum(sizes), generator=gen, device=device)
    tree: Dict = {}
    at = 0
    for path, leaf, shape, init in layout:
        if init[0] in ("xavier", "uniform"):
            n = math.prod(shape)
            u = draw[at:at + n].reshape(shape)
            at += n
            half = init[1] if init[0] == "xavier" else 0.5
            value = (u * 2 - 1) * half
        elif init[0] == "const":
            value = torch.full(shape, init[1], device=device)
        elif init[0] == "gdn":
            eye = 0.1 * torch.eye(init[1], device=device)
            value = torch.sqrt(torch.clamp_min(eye + PEDESTAL, PEDESTAL))
        else:
            value = torch.tensor([-INIT_SCALE, 0.0, INIT_SCALE],
                                 device=device).expand(shape).clone()
        module, *rest = path.split("/")
        node = tree.setdefault(module, {}).setdefault("params", {})
        for part in rest:
            node = node.setdefault(part, {})
        node[leaf] = value.float()
    return tree
