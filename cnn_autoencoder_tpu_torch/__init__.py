"""PyTorch + CUDA port of ``cnn_autoencoder_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths so each counterpart is
easy to find, but it is written in PyTorch idiom (``nn.Module`` s and plain
functions on tensors) and imports nothing of JAX or of the JAX package.

This slice covers the ``cae_tpu`` serving round trip of the CAE in float32:
checkpoint reading, the Analyzer/Synthesizer, device rANS coding of frame
v4, and the codec.  The four kernels on that path (GDN, fused conv+GDN,
rANS encode and decode) are CUDA C++ for ``sm_90a`` under ``csrc/``; each
has a plain PyTorch version beside it that CPU tensors take.

Public entry points take ``device=None``, which means ``"cuda"``; without a
card that raises ``RuntimeError``.  Pass ``device="cpu"`` explicitly to run
the plain versions on the CPU.
"""

__version__ = "0.1.0"
