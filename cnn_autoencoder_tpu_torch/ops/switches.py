"""The JAX package's ``CAE_TPU_*`` switches that change what the model
computes, read at call time from the environment as the JAX package reads
them (its modules read them when a layer is traced).

Each is ported: the layers compute the function it selects.  The switches
that do not change the function are not read: ``CAE_TPU_GDN_ROW_TILE``
(the result does not depend on the tile) and
``CAE_TPU_DISABLE_NATIVE_RANS`` (the same bytes).
"""

import os


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def pallas_interpret() -> bool:
    """``CAE_TPU_PALLAS_INTERPRET=1``: the JAX package runs its Pallas
    kernels in its interpreter, which turns them on (below)."""
    return _env("CAE_TPU_PALLAS_INTERPRET", "0") == "1"


def pallas() -> bool:
    """The JAX package's opt-in Pallas functions (its ``pallas_enabled``):
    the fused down stage's float32 sums and pool in the bf16 mode, its
    HIGHEST conv at every precision, and the GDN's recomputed backward in
    bf16 training.  ``CAE_TPU_PALLAS=1`` or ``CAE_TPU_PALLAS_INTERPRET=1``
    turns them on, ``CAE_TPU_PALLAS=0`` off whatever the other says."""
    flag = _env("CAE_TPU_PALLAS", "")
    return flag != "0" and (flag == "1" or pallas_interpret())


def gdn_train_kernel() -> bool:
    """The JAX package's GDN training kernels (its
    ``gdn_train_kernels_enabled``: ``CAE_TPU_GDN_TRAIN_KERNEL=1``, or any
    value but "0" under ``CAE_TPU_PALLAS_INTERPRET=1``).  They compute the
    default route's y, r and dx, but the bf16 GDN backward's dbeta as the
    sum of the bf16 dnb instead of the float32 dnorm."""
    flag = _env("CAE_TPU_GDN_TRAIN_KERNEL", "0")
    return flag != "0" and (flag == "1" or pallas_interpret())


def fused_conv() -> bool:
    """``CAE_TPU_FUSED_CONV=0`` under ``CAE_TPU_PALLAS=1`` gives the down
    stage the default route again (JAX ``fused_conv_gdn_enabled``)."""
    return _env("CAE_TPU_FUSED_CONV", "1") != "0"


def pallas_fused_conv() -> bool:
    """The JAX package's fused conv + GDN route is on."""
    return pallas() and fused_conv()


def native_conv_out() -> bool:
    """bf16 convs store their sums as bf16 before the bias is added
    (JAX ``_native_conv_out``); ``CAE_TPU_NATIVE_CONV_OUT=0`` keeps float32
    sums, the bias inside, and rounds once."""
    return _env("CAE_TPU_NATIVE_CONV_OUT", "1") != "0"


def border_conv() -> bool:
    """The bf16 mode's 3x3 stride-2 reflect convs take the border form
    (JAX ``CAE_TPU_BORDER_CONV``, "auto" or "1"); "0" keeps
    reflect + VALID.  On float32 rows the two differ only in the order of
    float32 sums, so the float32 modes do not read it."""
    return _env("CAE_TPU_BORDER_CONV", "auto").lower() != "0"


def polyphase_conv() -> bool:
    """``CAE_TPU_POLYPHASE_CONV=1``: the bf16 mode's 3x3 stride-2 reflect
    convs as four stride-1 convs on the parity phases (JAX
    ``conv_s2_reflect_polyphase``, ahead of the border form); float32 rows
    do not read it (it changes only the order of float32 sums)."""
    return _env("CAE_TPU_POLYPHASE_CONV", "0").lower() == "1"


def polyphase_deconv() -> bool:
    """``CAE_TPU_POLYPHASE_DECONV=1``: the 3x3 stride-2 deconvs sum in
    float32 with the bias and round once (JAX ``deconv2x_polyphase``)."""
    return _env("CAE_TPU_POLYPHASE_DECONV", "0") == "1"


def bf16_activations() -> bool:
    """``CAE_TPU_BF16_ACTIVATIONS=0``: float32 activations between the
    bf16 mode's layers in serving."""
    return _env("CAE_TPU_BF16_ACTIVATIONS", "1") != "0"


def gdn_fast() -> bool:
    """``CAE_TPU_GDN_FAST=0``: the float32-accurate norm pool on bf16
    rows."""
    return _env("CAE_TPU_GDN_FAST", "1") != "0"


def analytic_ent() -> str:
    """``CAE_TPU_ANALYTIC_ENT``: "0" autodiff of the likelihood chain, "1",
    "2" and "bf16" its analytic backwards (``models/entropy.py``)."""
    return _env("CAE_TPU_ANALYTIC_ENT", "0")
