"""Device meshes and the sharding rule: the port of the JAX package's
``parallel/mesh.py``.

A ``DeviceMesh`` is a list of ``torch.device``s and a shape ``{"data": d,
"model": m}``.  The JAX package hands such a mesh to GSPMD; the port runs
it by hand:

* serving: ``CAECodecCore`` and ``CAETurboCore`` (``storage/``) pad a tile
  batch to a multiple of ``data`` by repeating its last tile and run each
  contiguous shard on its mesh device, with every kernel launched per shard
  on that device's own rows (the JAX kernels' ``custom_partitioning``
  rules split rows the same way, with the parameters replicated);
* training runs one process a card (``parallel/distributed.py``,
  ``cli/train_cae.py``), so a training mesh only sizes the process group.

A mesh's devices may repeat (``["cpu"] * 8``, ``["cuda:0", "cuda:0"]``):
the port's counterpart of the JAX tests' spoofed 8-device CPU mesh, which
drives every sharding branch on one device.

The ``model`` axis (channel tensor parallelism, which GSPMD partitions
from ``infer_param_spec``'s specs) is not ported: ``infer_param_spec`` is,
as the rule alone, and a mesh with ``model > 1`` raises (``ROADMAP.md``
item 10b).
"""

import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

MODEL_AXIS_ERROR = ("the 'model' mesh axis (channel tensor parallelism) is "
                    "not ported; it is ROADMAP item 10b: use model=1")


class DeviceMesh(NamedTuple):
    """Devices in mesh order and the axis sizes, ``{"data": d, "model":
    m}``: ``devices[i]`` holds data shard ``i``."""
    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]


def _device(d) -> torch.device:
    """A concrete device: ``"cuda"`` without an index is the current card,
    so that two spellings of one card compare equal."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> List[torch.device]:
    """Every visible card; raises without one (no CPU fallback)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def check_model_axis(model: int) -> None:
    if int(model) != 1:
        raise ValueError(f"model={model}: {MODEL_AXIS_ERROR}")


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (data, model) mesh over ``devices`` (default: every visible card);
    ``data`` defaults to all of them.  ``model`` must be 1."""
    check_model_axis(model)
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    if data is None:
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(f"a mesh of data={data} x model={model} needs "
                         f"{data * model} devices, {n} given")
    return DeviceMesh(tuple(_device(d) for d in devices[:data * model]),
                      {"data": int(data), "model": int(model)})


def batch_spec(ndim: int) -> Tuple[Optional[str], ...]:
    """The leading axis over ``data``, the rest replicated (the JAX
    package's ``PartitionSpec("data", None, ...)`` as a tuple)."""
    return ("data",) + (None,) * (ndim - 1)


def serving_mesh() -> Optional[DeviceMesh]:
    """A data-only mesh over every visible card for serving, or None on
    one card or under ``CAE_TPU_SERVE_MESH=0``."""
    if os.environ.get("CAE_TPU_SERVE_MESH", "1") == "0":
        return None
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    return create_mesh(data=n, model=1)


def infer_param_spec(path: Sequence[Any], leaf, model_size: int
                     ) -> Tuple[Optional[str], ...]:
    """The sharding rule for one parameter of a JAX-layout tree
    (``utils/weights.py:state_to_jax``): channel-separable parameters
    shard their channel axis over ``model`` where it divides, everything
    else replicates (``()``).  ``path`` holds the tree's keys (strings, or
    objects with a ``key``).  With ``model_size`` 1 it is pure data
    parallelism."""
    if model_size <= 1 or not hasattr(leaf, "shape"):
        return ()
    shape = tuple(leaf.shape)
    names = [str(getattr(p, "key", p)) for p in path]
    name = names[-1] if names else ""

    if name == "kernel" and len(shape) == 4:
        # HWIO conv kernel: its output channels
        if shape[3] % model_size == 0 and shape[3] >= 2 * model_size:
            return (None, None, None, "model")
        return ()
    if name == "gamma" and len(shape) == 2:
        return ("model", None) if shape[0] % model_size == 0 else ()
    if any("fact_ent" in n for n in names) and len(shape) >= 1:
        # the bottleneck's parameters are (C, ...), channel-major
        if shape[0] % model_size == 0 and shape[0] >= model_size:
            return ("model",) + (None,) * (len(shape) - 1)
        return ()
    if len(shape) == 1 and shape[0] % model_size == 0 \
            and shape[0] >= 2 * model_size:
        return ("model",)
    return ()


def _pad_rows(x, rows: int):
    """``x`` with its last row repeated until it has ``rows`` rows."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    if torch.is_tensor(x):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


def split_batch(x, n: int, devices: Optional[Sequence] = None) -> List:
    """``x`` (numpy or tensor) padded to a multiple of ``n`` rows by
    repeating its last row, then cut into ``n`` contiguous shards of equal
    size; tensor shards move to ``devices[i]`` when given (numpy shards
    stay on the host for their shard's upload)."""
    per = -(-x.shape[0] // n)
    x = _pad_rows(x, per * n)
    parts = [x[i * per:(i + 1) * per] for i in range(n)]
    if devices is not None:
        parts = [p.to(d) if torch.is_tensor(p) else p
                 for p, d in zip(parts, devices)]
    return parts


def gather_batch(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Shards concatenated in mesh order on ``device`` (one shard as it
    is)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def replicate(mesh: DeviceMesh, module: torch.nn.Module
              ) -> List[torch.nn.Module]:
    """One copy of ``module`` for each mesh device, in mesh order: the
    module itself on its own device, a deep copy on every other; a device
    that repeats gets the same copy."""
    import copy
    own = next(module.parameters()).device
    by_device = {}
    out = []
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = (module if d == own
                            else copy.deepcopy(module).to(d))
        out.append(by_device[d])
    return out


def shard_batch(mesh: DeviceMesh, x) -> List:
    """``x``'s leading axis over the mesh's ``data`` axis: one contiguous
    shard a device, on it.  The batch must divide evenly (the JAX
    package's ``shard_batch`` asks the same of a global array)."""
    nd = mesh.shape["data"]
    if x.shape[0] % nd:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"data={nd}")
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return split_batch(x, nd, mesh.devices)
