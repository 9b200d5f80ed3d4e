"""PyTorch + CUDA port of ``cnn_autoencoder_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths so each counterpart is
easy to find, but it is written in PyTorch idiom (``nn.Module`` s and plain
functions on tensors) and imports nothing of JAX or of the JAX package.

It covers the serving round trip of the CAE in float32 (checkpoint reading,
the Analyzer/Synthesizer, the codecs), the RateMSE train step in float32 and
bf16, and every codec id of the JAX package's registry: ``cae`` and
``cae_bn`` on the host rANS coder (C++ under ``coding/csrc``, built with
``g++`` at first use), ``cae_tpu`` with device rANS (frames v4 and v3, and
host frames for the batches the device coder cannot take), the general byte
codecs and the PIL image codecs.  The kernels on those paths (GDN, fused
conv+GDN, rANS encode and decode) are CUDA C++ for ``sm_90a`` under
``csrc/``; each has a plain PyTorch version beside it that CPU tensors take.

Public entry points take ``device=None``, which means ``"cuda"``; without a
card that raises ``RuntimeError``.  Pass ``device="cpu"`` explicitly to run
the plain versions on the CPU.
"""

__version__ = "0.1.0"
