"""PMF -> quantized CDF conversion for range coding (numpy).

A frozen copy, for the reference, of the quantization that defines the
tables of cae_tpu frames (``cnn_autoencoder_tpu_torch/coding/cdf.py``):
round the PMF
to ``2**precision``, renormalize by integer scaling, partial-sum, force the
total to ``2**precision``, then repair zero-frequency symbols by stealing
from the smallest stealable neighbor range.  Identical arithmetic, so the
reference's tables are the frames' tables element for element.
"""

import numpy as np


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Quantize a PMF.

    Returns an int32 CDF array of length ``len(pmf) + 1`` with ``cdf[0] == 0``
    and ``cdf[-1] == 2**precision``; every symbol has frequency >= 1.
    """
    pmf = np.asarray(pmf, np.float64)
    if np.any(pmf < 0) or not np.all(np.isfinite(pmf)):
        raise ValueError("Invalid pmf: negative or non-finite values")

    n = pmf.shape[0]
    cdf = np.zeros(n + 1, np.uint64)
    # round half away from zero (C++ std::round); pmf >= 0 so == floor(x+0.5)
    cdf[1:] = np.floor(pmf * (1 << precision) + 0.5).astype(np.uint64)

    total = int(cdf.sum())
    if total == 0:
        raise ValueError("Invalid pmf: total mass is zero")
    cdf = ((int(1) << precision) * cdf.astype(object)) // total
    cdf = np.cumsum(cdf).astype(np.int64)
    cdf[-1] = 1 << precision

    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            # steal one unit from the smallest range > 1
            best_freq = None
            best_steal = -1
            for j in range(n):
                freq = cdf[j + 1] - cdf[j]
                if freq > 1 and (best_freq is None or freq < best_freq):
                    best_freq = freq
                    best_steal = j
            if best_steal == -1:
                raise ValueError("Cannot repair zero-frequency symbol")
            if best_steal < i:
                cdf[best_steal + 1:i + 1] -= 1
            else:
                cdf[i + 1:best_steal + 1] += 1

    if cdf[0] != 0 or cdf[-1] != (1 << precision) or \
            np.any(np.diff(cdf) < 1):
        raise ValueError("quantized CDF failed its invariants")
    return cdf.astype(np.int32)
