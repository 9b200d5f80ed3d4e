"""Device meshes, the sharding rule and channel-sharded parameters: the
port of the JAX package's ``parallel/mesh.py``.

A ``DeviceMesh`` is a list of ``torch.device``s and a shape ``{"data": d,
"model": m}``, laid out as the JAX mesh's: ``devices[i * m + j]`` is data
index ``i``, model index ``j``.  The JAX package hands such a mesh to
GSPMD; the port runs it by hand:

* serving: ``CAECodecCore`` and ``CAETurboCore`` (``storage/``) pad a tile
  batch to a multiple of ``data`` by repeating its last tile and run each
  contiguous shard on ``data_devices(mesh)[i]``, the first device of its
  model group, with every kernel launched per shard on that device's own
  rows (the JAX kernels' ``custom_partitioning`` rules split rows the same
  way, with the parameters replicated; the JAX cores replicate over
  ``model``, so frames do not depend on it);
* training runs one process a mesh device (``parallel/distributed.py``,
  ``cli/train_cae.py``): the data axis splits the batch, and the model
  axis holds every leaf that ``infer_param_spec`` shards as the rank's
  slice (``shard_model``: the codec's, the heads' and the batch norms'
  running statistics, of every architecture), gathered in the forward
  where a layer needs it whole (``distributed.gather_model``).
  Convolutions with a sharded kernel compute the rank's output channels
  and gather them (``ops/convops.py``, ``models/layers.py``), GDN and the
  fused conv+GDN stage gather their parameters and launch their kernels
  on the rank's rows as one process does, the norms and dense layers
  gather what they hold as shards (``ops/batchnorm.py``,
  ``models/layers.py``), and the bottleneck works on the rank's channels
  (``models/entropy.py``).

A mesh's devices may repeat (``["cpu"] * 8``, ``["cuda:0", "cuda:0"]``):
the port's counterpart of the JAX tests' spoofed 8-device CPU mesh, which
drives every sharding branch on one device.  ``shard_state`` and
``gather_state`` carry a state dict to a model index's shard and back
through the JAX layout (``utils/weights.py:state_to_jax``), so that
``infer_param_spec`` decides each leaf as ``shard_variables`` does there.
"""

import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .distributed import ModelShard, all_gather_axis, named_shards


class DeviceMesh(NamedTuple):
    """Devices in mesh order and the axis sizes, ``{"data": d, "model":
    m}``: ``devices[i * m + j]`` is data index ``i``, model index ``j``."""
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


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (data, model) mesh over the first ``data * model`` of ``devices``
    (default: every visible card); ``data`` defaults to as many as fit."""
    if int(model) < 1:
        raise ValueError(f"model={model}: the model axis needs a size >= 1")
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    if data is None:
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(f"a mesh of data={data} x model={model} needs "
                         f"{data * model} devices, {n} given")
    return DeviceMesh(tuple(_device(d) for d in devices[:data * model]),
                      {"data": int(data), "model": int(model)})


def data_devices(mesh: DeviceMesh) -> Tuple[torch.device, ...]:
    """The first device of each model group, in data order: where a data
    shard runs when the model is replicated over ``model``."""
    return mesh.devices[::mesh.shape["model"]]


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
    """One copy of ``module`` for each data shard's device
    (``data_devices``), in data order: the module itself on its own
    device, a deep copy on every other; a device that repeats gets the
    same copy."""
    import copy
    own = next(module.parameters()).device
    by_device = {}
    out = []
    for d in data_devices(mesh):
        if d not in by_device:
            by_device[d] = (module if d == own
                            else copy.deepcopy(module).to(d))
        out.append(by_device[d])
    return out


def shard_batch(mesh: DeviceMesh, x) -> List:
    """``x``'s leading axis over the mesh's ``data`` axis: one contiguous
    shard a data index, on its device (``data_devices``).  The batch must divide evenly (the JAX
    package's ``shard_batch`` asks the same of a global array)."""
    nd = mesh.shape["data"]
    if x.shape[0] % nd:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"data={nd}")
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return split_batch(x, nd, data_devices(mesh))


# -- the model axis: parameters held as shards --------------------------------


def shard_state(state: Dict[str, torch.Tensor], config: Dict[str, Any],
                model_index: int, model_size: int) -> Dict[str, torch.Tensor]:
    """Model index ``model_index``'s shard of a ``CAEModel`` state dict
    (the heads' and the ``batch_stats`` leaves included), as
    ``shard_variables`` places it on that mesh device: through the JAX
    layout (``state_to_jax``), each leaf cut along the axis
    ``infer_param_spec`` names, and back (float32 tensors on the host).
    A grouped transposed convolution's cut kernel holds whole groups (its
    output channels divide over ``model_size`` as its groups do), so it
    comes back as the rows of those groups' inputs in the port's layout,
    a transposed convolution of 1/``model_size`` of the groups."""
    from ..utils.weights import deconv_groups, state_from_jax, state_to_jax
    groups = deconv_groups(config)
    shard_groups = {}

    def cut(path, leaf):
        if isinstance(leaf, dict):
            return {k: cut(path + (k,), v) for k, v in leaf.items()}
        spec = infer_param_spec(path, leaf, model_size)
        for axis, name in enumerate(spec):
            if name == "model":
                g = (groups.get(path[2]) if path[0] == "decoder"
                     and path[-1] == "kernel" and len(path) == 5
                     and path[3].startswith(("deconv", "res_deconv"))
                     else None)
                if g:
                    if g % model_size:
                        raise ValueError(
                            f"{'/'.join(path)}: a shard of {g} groups over "
                            f"model={model_size} would not hold whole "
                            "groups")
                    shard_groups[f"{path[2]}/{path[3]}"] = g // model_size
                per = leaf.shape[axis] // model_size
                return np.ascontiguousarray(np.take(leaf, np.arange(
                    model_index * per, (model_index + 1) * per), axis=axis))
        return leaf

    tree = cut((), state_to_jax(state, config))
    return state_from_jax(tree, config, shard_groups)


def shard_axes(state: Dict[str, torch.Tensor], config: Dict[str, Any],
               model_size: int) -> Dict[str, Optional[int]]:
    """{state key: its sharded axis in the port's layout, or None where it
    is replicated} at ``model_size``."""
    part = shard_state(state, config, 0, model_size)
    return {k: next((a for a, (n, f) in enumerate(zip(part[k].shape,
                                                      v.shape)) if n != f),
                    None) for k, v in state.items()}


def gather_state(shards: Sequence[Dict[str, torch.Tensor]],
                 axes: Dict[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The full state dict from every model index's shard, in index order
    (``axes``: ``shard_axes`` of the full state)."""
    return {k: shards[0][k] if a is None
            else torch.cat([s[k] for s in shards], dim=a)
            for k, a in axes.items()}


def shard_model(model: torch.nn.Module, group, model_index: int,
                model_size: int) -> torch.nn.Module:
    """Hold ``model``'s sharded leaves as this rank's slices, the heads'
    and the batch norms' running statistics among them: a parameter
    becomes a new ``nn.Parameter`` of 1/``model_size`` of the leaf (so an
    optimizer built after it keeps its state on the shard), a buffer a
    buffer of the slice (so no optimizer sees it), and its module records
    the ``ModelShard`` its layers gather by.  A no-op at ``model_size``
    1."""
    if model_size <= 1:
        return model
    state = model.state_dict()
    parts = shard_state(state, model.config, model_index, model_size)
    for key, axis in shard_axes(state, model.config, model_size).items():
        if axis is None:
            continue
        where, name = key.rsplit(".", 1)
        module = model.get_submodule(where)
        old = getattr(module, name)
        part = parts[key].to(old.device, old.dtype)
        if name in module._buffers:
            module.register_buffer(name, part)
        else:
            module.register_parameter(name, torch.nn.Parameter(
                part, requires_grad=old.requires_grad))
        module.model_shards = dict(getattr(module, "model_shards", {}), **{
            name: ModelShard(group, model_index, model_size, axis)})
    return model


def gather_model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full state dict, every shard gathered over its model
    group: a collective, which every rank of the group calls."""
    shards = named_shards(model)
    return {k: v if k not in shards else all_gather_axis(
        v, shards[k].group, shards[k].axis)
        for k, v in model.state_dict().items()}
