"""The port's link probes (``coding/link_probe.py``) against the JAX
package's: ``auto`` off where there is no link to save (a CPU device here,
the CPU backend there), the forced modes and the threshold switch read the
same in both, the probes measure and cache, and ``auto`` on the card
without one raises instead of turning the transports off."""

import numpy as np
import pytest
import torch

from cnn_autoencoder_tpu.coding import link_probe as jlp
from cnn_autoencoder_tpu_torch.coding import link_probe as lp

SWITCHES = ("CAE_TPU_PACKED_FETCH", "CAE_TPU_CODED_UPLOAD",
            "CAE_TPU_PACKED_THRESHOLD_MBPS")


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    saved = dict(lp._cache)
    lp._cache.update(t=0.0, d2h=float("inf"), h2d=float("inf"))
    yield
    lp._cache.update(saved)


def _gates(mod, **kw):
    return mod.coded_fetch_enabled(**kw), mod.coded_upload_enabled(**kw)


@pytest.mark.parametrize("fetch,upload", [(None, None), ("1", "1"),
                                          ("0", "0"), ("1", "0"),
                                          ("auto", "1")])
def test_switches_read_as_in_jax(monkeypatch, fetch, upload):
    """Unset or ``auto``: off on the CPU in both packages; ``0`` and ``1``
    force either direction on its own."""
    for name, value in (("CAE_TPU_PACKED_FETCH", fetch),
                        ("CAE_TPU_CODED_UPLOAD", upload)):
        if value is not None:
            monkeypatch.setenv(name, value)
    port = _gates(lp, device="cpu")
    assert port == _gates(jlp)
    assert port == (fetch == "1", upload == "1")


def test_auto_on_the_card_without_one_raises(monkeypatch):
    """``device=None`` means the card: ``auto`` probes it, and without a
    card that raises (no silent CPU fallback); a forced switch needs no
    probe."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lp.coded_fetch_enabled()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lp.coded_upload_enabled()
    monkeypatch.setenv("CAE_TPU_PACKED_FETCH", "1")
    assert lp.coded_fetch_enabled() is True


def test_auto_compares_the_probed_rate_with_the_threshold(monkeypatch):
    """On a device with a link, ``auto`` codes a direction whose cached
    rate is under its threshold (190 MB/s d2h, 160 h2d, as in JAX)."""
    monkeypatch.setattr(lp, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    lp._cache.update(t=float("inf"), d2h=150.0, h2d=170.0)
    assert _gates(lp) == (True, False)
    monkeypatch.setenv("CAE_TPU_PACKED_THRESHOLD_MBPS", "100")
    assert _gates(lp) == (False, False)


def test_probe_measures_and_caches():
    d2h, h2d = lp.probe_link_mbps(force=True, mb=1, device="cpu")
    assert np.isfinite(d2h) and d2h > 0
    assert np.isfinite(h2d) and h2d > 0
    # within the minute an unforced call returns the cached pair
    assert lp.probe_link_mbps(device="cpu") == (d2h, h2d)


def test_probe_force_refreshes_cache():
    lp._cache.update(t=float("inf"), d2h=123.0, h2d=456.0)
    assert lp.probe_link_mbps(device="cpu") == (123.0, 456.0)
    lp.probe_link_mbps(force=True, mb=1, device="cpu")
    assert lp._cache["t"] != float("inf")


def test_threshold_env_override(monkeypatch):
    monkeypatch.setenv("CAE_TPU_PACKED_THRESHOLD_MBPS", "42.5")
    assert lp._threshold("d2h") == jlp._threshold("d2h") == 42.5
    assert lp._threshold("h2d") == jlp._threshold("h2d") == 42.5
    monkeypatch.delenv("CAE_TPU_PACKED_THRESHOLD_MBPS")
    assert lp._DEFAULT_MBPS == jlp._DEFAULT_MBPS
    assert lp._threshold("d2h") == lp._DEFAULT_MBPS["d2h"]
    assert lp._threshold("h2d") == lp._DEFAULT_MBPS["h2d"]


def test_duplex_probe_runs_on_cpu():
    """Both threads run at the barrier and return finite positive rates
    (memory copies on the CPU)."""
    d2h, h2d = lp.probe_link_duplex_mbps(mb=2, device="cpu")
    assert d2h > 0 and h2d > 0
    assert np.isfinite(d2h) and np.isfinite(h2d)
