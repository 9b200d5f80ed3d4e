"""Device selection and the float32 precision rule."""

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  There is no silent CPU fallback: without a
    CUDA device a request for one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """Run convolutions and matmuls in full float32.

    cuDNN computes float32 convolutions in TF32 by default (about three
    decimal digits), which would break parity with the JAX package's
    HIGHEST precision.  This turns TF32 off for the block and restores the
    previous settings after it."""
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
