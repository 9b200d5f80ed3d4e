"""Device selection and the float32 precision rule."""

import contextlib
import threading

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


# full_f32's state: one lock for the process, the number of blocks open in
# any thread, and the flags the first of them found
_F32_LOCK = threading.Lock()
_f32_open = 0
_f32_saved = None


def _f32_flags():
    matmul = torch.backends.cuda.matmul
    return (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
            matmul.allow_bf16_reduced_precision_reduction)


def _set_f32_flags(flags):
    matmul = torch.backends.cuda.matmul
    (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
     matmul.allow_bf16_reduced_precision_reduction) = flags


@contextlib.contextmanager
def full_f32():
    """Run convolutions and matmuls with full float32 products and sums.

    cuDNN computes float32 convolutions in TF32 by default (about three
    decimal digits), which would break parity with the JAX package's
    HIGHEST precision, and cuBLAS may reduce the partial sums of a bf16
    product in bf16.  This turns both off for the block.

    The three switches are process-wide, and the tile pipeline runs the
    model from several threads at once, so the blocks are counted under
    one lock: the first block to open (in any thread) saves the switches
    and turns them off, the last one to close restores them.  Every block
    runs with them off however the threads interleave, and blocks nest.
    While a block is open, code outside any block sees them off too."""
    global _f32_open, _f32_saved
    with _F32_LOCK:
        if _f32_open == 0:
            _f32_saved = _f32_flags()
            _set_f32_flags((False, False, False))
        _f32_open += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_open -= 1
            if _f32_open == 0:
                _set_f32_flags(_f32_saved)
                _f32_saved = None
