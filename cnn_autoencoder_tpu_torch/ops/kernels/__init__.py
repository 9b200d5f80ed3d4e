"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every kernel module holds, for one function: the plain PyTorch version, the
CUDA wrapper (which counts its launches in ``wrapper.launches``) and a
dispatcher that gives CPU tensors the plain version and CUDA tensors the
kernel.  There is no fallback between them: a CUDA tensor that the kernel
does not take raises.
"""


def kernel_wrappers():
    """The CUDA wrappers of every kernel, each with ``launches`` and
    ``kernel_name`` (K4's variants: one counter a kernel name)."""
    from .conv_gdn_kernel import SERVING, TRAIN
    from .gdn_kernel import (gdn_bf16_cuda, gdn_bf16_f32pool_cuda, gdn_cuda,
                             gdn_train_bwd_cuda, gdn_train_fwd_bf16_f32pool_cuda,
                             gdn_train_fwd_cuda, gdn_train_fwd_f32_cuda)
    from .rans_kernel import (compact_cuda, decode_interleaved_cuda,
                              encode_states_cuda)
    return (gdn_cuda, gdn_bf16_cuda, gdn_bf16_f32pool_cuda,
            gdn_train_fwd_cuda, gdn_train_fwd_f32_cuda,
            gdn_train_fwd_bf16_f32pool_cuda, gdn_train_bwd_cuda,
            *SERVING.values(), *TRAIN.values(), encode_states_cuda,
            compact_cuda, decode_interleaved_cuda)


def reset_launch_counts() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0
