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
    """Run convolutions and matmuls with full float32 products and sums.

    cuDNN computes float32 convolutions in TF32 by default (about three
    decimal digits), which would break parity with the JAX package's
    HIGHEST precision, and cuBLAS may reduce the partial sums of a bf16
    product in bf16.  This turns both off for the block and restores the
    previous settings after it."""
    matmul = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved
