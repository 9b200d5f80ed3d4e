"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/*.cu`` compiles to an object file (all ``nvcc`` processes start
together), and one more ``nvcc`` call links them into
``build/kernels/<hash>/libcae_torch_kernels.so`` beside the package, where
``<hash>`` is taken over the sources, so an edited source builds anew and
an unchanged one loads the cached library.  Nothing is built at import
time: ``load_library`` builds at the first kernel launch.  A missing
``nvcc`` or a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
LIB_NAME = "libcae_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C launchers: every pointer and the stream are c_void_p (a plain int would
# be passed as 32 bits and cut the address)
SIGNATURES = {
    "cae_gdn_fwd": [_P, _P, _P, _P, _L, _I, _I, _P],
    "cae_gdn_root_check": [ctypes.c_uint32, _L, _P, _P],
    "cae_gdn_fwd_bf16": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
    "cae_gdn_fwd_bf16_workspace": [_I],
    "cae_gdn_train_fwd": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "cae_gdn_train_fwd_workspace": [_I],
    "cae_gdn_train_fwd_f32": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
    "cae_gdn_train_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                          _P],
    "cae_gdn_train_bwd_workspace": [_I],
    "cae_gdn_train_bwd_partials": [_L, _I, _I],
    "cae_gdn_fwd_bf16_f32pool": [_P, _P, _P, _P, _L, _I, _I, _P],
    "cae_gdn_train_fwd_bf16_f32pool": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
    "cae_conv_gdn_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _P],
    "cae_conv_gdn_workspace": [_I, _I, _I, _I, _I, _I, _I],
    "cae_rans_encode_chunks": [_I, _I],
    "cae_rans_encode_states": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                               _P, _P, _P, _P],
    "cae_rans_compact": [_P, _P, _P, _P, _I, _I, _I, _P, _L, _P, _P],
    "cae_rans_decode": [_P, _I, _L, _P, _P, _I, _P, _P, _I, _I, _P],
}
# launchers that return something other than a cudaError_t (int)
RESTYPES = {"cae_conv_gdn_workspace": ctypes.c_int64,
            "cae_gdn_fwd_bf16_workspace": ctypes.c_int64,
            "cae_gdn_train_fwd_workspace": ctypes.c_int64,
            "cae_gdn_train_bwd_workspace": ctypes.c_int64,
            "cae_gdn_train_bwd_partials": ctypes.c_int64,
            "cae_rans_encode_chunks": ctypes.c_int64}

_lib = None
_LIB_LOCK = threading.Lock()  # one build and one load for the process
build_log = ""
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def cuda_tool(name: str = "nvcc") -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH or in
    ``$CUDA_HOME/bin``; raises if neither has it."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", name)
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        f"{name} not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "toolkit builds and inspects the kernels of cnn_autoencoder_tpu_torch")


def _run_all(cmds):
    """Start every command at once and wait for all; raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append((" ".join(cmd), out))
    if failed:
        msg = "\n".join(f"$ {c}\n{o}" for c, o in failed)
        raise RuntimeError(f"CUDA kernel build failed:\n{msg}")
    return "".join(logs)


def build(out_dir: Path) -> Path:
    """Compile the sources in parallel and link the shared library."""
    global build_log, build_seconds
    nvcc = cuda_tool()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    try:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (src.stem + ".o") for src in cus]
        common = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                               "-Xptxas", "-v", "-I", str(CSRC)]
        log = _run_all([[nvcc] + common + ["-c", str(src), "-o", str(obj)]
                        for src, obj in zip(cus, objs)])
        lib_tmp = tmp / LIB_NAME
        log += _run_all([[nvcc] + ARCH_FLAGS + ["-shared", "-o", str(lib_tmp)]
                         + [str(o) for o in objs]])
        lib = out_dir / LIB_NAME
        os.replace(lib_tmp, lib)  # atomic: a concurrent loader sees all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_log = log
    build_seconds = time.perf_counter() - t0
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use.  Threads that reach
    their first launch together (the tile pipeline's workers) wait for one
    build and one load."""
    global _lib
    if _lib is not None:
        return _lib
    with _LIB_LOCK:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _source_hash()
        path = out_dir / LIB_NAME
        if not path.exists():
            path = build(out_dir)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_handle(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
