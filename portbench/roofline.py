"""Operations and bytes of the functions the benchmark's rooflines and MFU
count, from a configuration's shapes, and the published peaks of one
NVIDIA H100 (SXM, dense, 700 W).  Frozen: it counts the work of each
function, never the passes of an implementation, so a kernel's roofline
reads the same work whatever implements it.

Operations are two a multiply-add: convolutions by output position,
transposed convolutions by input position, GDN's pool (``gamma @ x^2``)
by row; elementwise work is not counted.  A float32 function's bound uses
the TF32 peak: no float32-accurate product runs faster than one TF32
pass.  Bytes count every input read once and every output written once.
A bound is the larger of operations over the peak and bytes over the
memory bandwidth.
"""

from typing import List, Tuple

PEAK_FLOPS = {"float32": 495e12, "tf32": 495e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def conv_flops(out_positions: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * out_positions * cin * cout * k * k


def deconv_flops(in_positions: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * in_positions * cin * cout * k * k


def gdn_flops(rows: int, c: int) -> int:
    return 2 * rows * c * c


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time of a function: the larger of its operations over the
    peak for its type and its bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# -- kernels -----------------------------------------------------------------

def k1(rows: int, c: int) -> Tuple[int, int]:
    """(operations, bytes) of GDN or IGDN over (rows, c) float32."""
    return gdn_flops(rows, c), F32 * (2 * rows * c + c * c + c)


def k4(batch: int, h: int, w: int, cin: int, cout: int,
       want_y: bool = False) -> Tuple[int, int]:
    """(operations, bytes) of the fused reflect-pad, 3x3 stride-2 conv and
    GDN: (batch, h, w, cin) -> (batch, h / 2, w / 2, cout) float32, and
    the conv's output y beside it with ``want_y``."""
    rows = batch * (h // 2) * (w // 2)
    ops = conv_flops(rows, cin, cout) + gdn_flops(rows, cout)
    outs = 2 if want_y else 1
    nbytes = F32 * (batch * h * w * cin + outs * rows * cout
                    + 9 * cin * cout + cout * cout + cout)
    return ops, nbytes


def k6(n_symbols: int, payload_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of the rANS encode (state pass and compaction):
    int32 symbols in, the frames' words out."""
    return 0, F32 * n_symbols + payload_bytes


def k5(n_symbols: int, payload_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of the rANS decode: words in, int32 symbols
    out."""
    return 0, payload_bytes + F32 * n_symbols


# -- the whole model ----------------------------------------------------------

def stages(config) -> Tuple[List, List]:
    """(encoder, decoder) stages of a configuration as (cin, cout, whether
    a GDN follows)."""
    c0, cn = config["channels_org"], config["channels_net"]
    cb, lv = config["channels_bn"], config["compression_level"]
    enc = [(c0 if i == 0 else cn, cb if i == lv - 1 else cn, i < lv - 1)
           for i in range(lv)]
    dec = [(cb if i == 0 else cn, c0 if i == lv - 1 else cn, i < lv - 1)
           for i in range(lv)]
    return enc, dec


def analysis_layers(config, h: int, w: int) -> List[Tuple[str, int]]:
    """(layer, operations) of the analysis transform of one (h, w) image,
    in order."""
    enc, _ = stages(config)
    res = bool(config.get("use_residual"))
    out = []
    for i, (cin, cout, act) in enumerate(enc):
        pos = h * w
        if res:
            out.append((f"down_{i}/res_conv1", conv_flops(pos, cin, cin)))
            if act:
                out.append((f"down_{i}/gdn_res", gdn_flops(pos, cin)))
        h, w = -(-h // 2), -(-w // 2)
        out.append((f"down_{i}/conv_down", conv_flops(h * w, cin, cout)))
        if act:
            out.append((f"down_{i}/gdn_down", gdn_flops(h * w, cout)))
    return out


def synthesis_layers(config, h: int, w: int) -> List[Tuple[str, int]]:
    """(layer, operations) of the synthesis of one (h, w) latent."""
    _, dec = stages(config)
    res = bool(config.get("use_residual"))
    out = []
    for i, (cin, cout, act) in enumerate(dec):
        if res:
            out.append((f"up_{i}/res_deconv1", deconv_flops(h * w, cin, cin)))
            if act:
                out.append((f"up_{i}/gdn_res", gdn_flops(h * w, cin)))
        out.append((f"up_{i}/deconv_up", deconv_flops(h * w, cin, cout)))
        h, w = 2 * h, 2 * w
        if act:
            out.append((f"up_{i}/gdn_up", gdn_flops(h * w, cout)))
    return out


def encode_flops(config, h: int, w: int) -> int:
    """Operations of encoding one (h, w) tile."""
    return sum(f for _, f in analysis_layers(config, h, w))


def decode_flops(config, h: int, w: int) -> int:
    """Operations of decoding one tile to (h, w)."""
    side = 1 << config["compression_level"]
    return sum(f for _, f in synthesis_layers(config, h // side, w // side))


def train_flops(config, h: int, w: int) -> int:
    """Operations of one training image of (h, w): the forward, and a
    backward of twice the forward but for the first layer's gradient with
    respect to the input, which nothing needs."""
    layers = analysis_layers(config, h, w)
    fwd = encode_flops(config, h, w) + decode_flops(config, h, w)
    return 3 * fwd - layers[0][1]


def share(bound_total_s: float, time_s: float) -> float:
    """A roofline or peak share in %."""
    return 100.0 * bound_total_s / time_s

