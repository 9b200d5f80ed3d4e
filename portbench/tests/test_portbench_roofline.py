"""``roofline.py``'s counts against hand counts at the flagship's shapes,
the readers on calls at their shapes, and the trace reductions on
synthetic events."""

import pytest

from portbench import readers, roofline
from portbench.trace import Trace

FLAGSHIP = {"channels_org": 3, "channels_net": 128, "channels_bn": 48,
            "compression_level": 3}
RESIDUAL = dict(FLAGSHIP, use_residual=True)


def test_k4_counts_the_function():
    ops, nbytes = roofline.k4(16, 256, 256, 128, 128)
    rows = 16 * 128 * 128
    assert ops == 2 * rows * 128 * 128 * 9 + 2 * rows * 128 * 128
    assert round(ops / 1e9, 1) == 85.9
    assert nbytes == 4 * (16 * 256 * 256 * 128 + rows * 128
                          + 9 * 128 * 128 + 128 * 128 + 128)
    _, with_y = roofline.k4(16, 256, 256, 128, 128, want_y=True)
    assert with_y - nbytes == 4 * rows * 128
    # bytes bound it: 671 MB at 3.35 TB/s against 85.9 G at 495 T/s
    assert roofline.bound_s(ops, nbytes) == nbytes / 3.35e12


def test_k1_k5_k6_counts():
    assert roofline.k1(16 * 256 * 256, 128) == (
        2 * 16 * 65536 * 128 * 128, 4 * (2 * 16 * 65536 * 128 + 128 * 129))
    assert roofline.k6(1000, 300) == (0, 4300)
    assert roofline.k5(1000, 300) == (0, 4300)


def test_model_counts():
    # encode of 512^2: 0.453 + 2.147 + 4.832 + 0.537 + 0.453 GFLOP
    enc = roofline.encode_flops(FLAGSHIP, 512, 512)
    assert enc == (2 * 256 ** 2 * 3 * 128 * 9 + 2 * 256 ** 2 * 128 ** 2
                   + 2 * 128 ** 2 * 128 * 128 * 9 + 2 * 128 ** 2 * 128 ** 2
                   + 2 * 64 ** 2 * 128 * 48 * 9)
    assert round(enc / 0.262144 / 1e9, 1) == 32.1
    assert roofline.decode_flops(FLAGSHIP, 512, 512) == enc
    first = 2 * 128 ** 2 * 3 * 128 * 9
    assert roofline.train_flops(FLAGSHIP, 256, 256) == \
        3 * 2 * roofline.encode_flops(FLAGSHIP, 256, 256) - first
    res = roofline.encode_flops(RESIDUAL, 256, 256)
    assert res - roofline.encode_flops(FLAGSHIP, 256, 256) == (
        2 * 256 ** 2 * 3 * 3 * 9 + 2 * 256 ** 2 * 9
        + 2 * 128 ** 2 * 128 * 128 * 9 + 2 * 128 ** 2 * 128 ** 2
        + 2 * 64 ** 2 * 128 * 128 * 9)


def _trace():
    device = [("void gdn_tc_kernel<float>(...)", 0.0, 100.0),
              ("void gdn_tc_kernel<float>(...)", 50.0, 250.0),
              ("Memcpy HtoD (Pageable -> Device)", 400.0, 500.0),
              ("void conv_gdn_mma_kernel<float>(...)", 900.0, 1000.0)]
    host = [("portbench.encode_tiles", 0.0, 1000.0),
            ("aten::copy_", 600.0, 700.0)]
    spans = {"portbench.call.0": 100.0, "portbench.call.1": 200.0,
             "portbench.call.2": 100.0, "portbench.deconv": 3000.0}
    calls = [("portbench.call.0", ("gdn_fwd",), [(4096, 128), (128, 128)]),
             ("portbench.call.1", ("gdn_fwd",), [(8192, 128), (128, 128)]),
             ("portbench.call.2", ("conv_gdn_fwd",),
              [(2, 64, 64, 128), (3, 3, 128, 48), (48, 48), (48,)])]
    return Trace(device, host, spans, 1e-3, calls)


def test_trace_reductions():
    t = _trace()
    assert t.busy_s() == pytest.approx(450e-6)
    assert readers.idle(t) == pytest.approx(55.0)
    assert t.launches() == 3
    assert t.span_s("portbench.deconv") == pytest.approx(3e-3)
    assert t.span_s("portbench.nothing") == 0.0
    b = t.breakdown()
    assert b["device_ops"][0] == ["void gdn_tc_kernel<float>(...)",
                                  pytest.approx(300e-6)]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(400e-6)]
    assert [c[1] for c in t.kernel_calls("gdn_fwd")] == [
        pytest.approx(100e-6), pytest.approx(200e-6)]


def test_readers_count_each_call_at_its_shapes():
    t = _trace()
    # K1: the rows each call was given, over the two calls' 300 us
    k1 = roofline.bound_s(*roofline.k1(4096, 128)) + roofline.bound_s(
        *roofline.k1(8192, 128))
    assert readers.call_share(t, "gdn_fwd", lambda sh: roofline.bound_s(
        *roofline.k1(*sh[0]))) == pytest.approx(100 * k1 / 300e-6)
    assert readers.call_share(t, "rans_decode", lambda sh: 1.0) is None
    # K4 reads Cout from the kernel's shape
    import importlib.util
    import os
    from conftest import ROOT
    path = os.path.join(ROOT, "portbench", "metrics",
                        "K4_roofline.encode.py")
    spec = importlib.util.spec_from_file_location("k4_encode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    k4 = roofline.bound_s(*roofline.k4(2, 64, 64, 128, 48))
    assert mod.read(t, {}) == pytest.approx(100 * k4 / 100e-6)
    # work counted by the traffic: 3 units of 50 us over K1's 300 us
    assert readers.work_share(t, ("gdn_fwd",), 3, 50e-6) == \
        pytest.approx(50.0)
    assert readers.work_share(t, ("rans_decode",), 3, 1.0) is None


class _Event:
    def __init__(self, name, kind, start, dur, tid=0, ident=0, link=0):
        self._v = (name, kind, start, dur, tid, ident, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1].startswith(
            ("kernel", "gpu")) else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[1].endswith("user_annotation")

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def test_reduce_gives_device_time_to_the_ranges_that_launched_it():
    from portbench.trace import reduce
    ev = _Event
    events = [
        # thread 1: a request holding a deconv that launches through mm
        ev("portbench.decode_tiles", "user_annotation", 0, 10_000, 1, 1),
        ev("portbench.deconv", "cpu_op", 1_000, 3_000, 1, 2),
        ev("aten::mm", "cpu_op", 1_500, 1_000, 1, 3),
        # thread 2, overlapping in time: its own launch, no deconv
        ev("portbench.decode_tiles", "user_annotation", 500, 5_000, 2, 10),
        ev("aten::copy_", "cpu_op", 1_600, 500, 2, 11),
        ev("cudaLaunchKernel", "cuda_runtime", 1_600, 10, 2, 3),
        ev("sgemm", "kernel", 2_000, 4_000, link=3),
        ev("Memcpy DtoH", "gpu_memcpy", 6_000, 2_000, link=11),
        ev("portbench.deconv", "gpu_user_annotation", 2_000, 4_000, link=2),
        ev("k_unlinked", "kernel", 9_000, 1_000, link=0),
    ]
    got = reduce(events, 1.0)
    assert [e[0] for e in got.device] == ["sgemm", "Memcpy DtoH",
                                          "k_unlinked"]
    assert "cudaLaunchKernel" not in [h[0] for h in got.host]
    assert got.span_s("portbench.deconv") == pytest.approx(4e-6)
    assert got.span_s("portbench.decode_tiles") == pytest.approx(6e-6)


def test_probe_records_each_call_with_its_kernel_name(monkeypatch):
    import types

    from portbench.trace import CALL, Probe

    mod = types.ModuleType("fake_kernels")

    def k1_cuda(x, inverse=False):
        # as a wrapper counts: by its module's global name
        mod.k1_cuda.launches += 1
        return x

    def k1_outer_cuda(x):
        return mod.k1_cuda(x)

    for fn in (k1_cuda, k1_outer_cuda):
        fn.__module__ = mod.__name__
        setattr(mod, fn.__name__, fn)
    k1_cuda.launches, k1_cuda.kernel_name = 0, "gdn_fwd"
    monkeypatch.setattr(Probe, "_modules", staticmethod(lambda: [mod]))
    monkeypatch.setattr(Probe, "_counts", staticmethod(
        lambda: {"gdn_fwd": mod.k1_cuda.launches}))
    import torch
    probe = Probe()
    probe.attach()
    mod.k1_cuda(torch.zeros(5, 3))
    mod.k1_outer_cuda(torch.zeros(7, 3))
    probe.detach()
    assert mod.k1_cuda is k1_cuda and k1_cuda.launches == 2
    assert [(c[1], c[2]) for c in probe.calls] == [
        (("gdn_fwd",), [(5, 3)]), (("gdn_fwd",), [(7, 3)])]
    assert all(c[0].startswith(CALL) for c in probe.calls)
