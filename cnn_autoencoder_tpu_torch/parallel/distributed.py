"""Multi-process start and the cross-process reductions: the port of the
JAX package's ``parallel/distributed.py``.

The torch idiom is one process a card in a ``torch.distributed`` process
group.  ``initialize_multihost`` forms or joins the default group from its
arguments or the environment: the JAX package's ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID``, else torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``; ``LOCAL_RANK`` picks the
rank's card.  The backend rule is explicit, with no fallback between
backends: NCCL where every rank has a card of its own, gloo on the CPU and
where ranks share a card (NCCL refuses two ranks on one device).  A
failure to form the group raises: nothing carries on single-process.

The reductions take a process group, or ``None`` for one process (then
they return their input): ``all_sum`` is differentiable, so a loss or a
batch statistic taken over the global batch sends its backward to every
rank's share of it.

A ``(data, model)`` mesh of ``d * m`` ranks puts rank ``r`` at data index
``r // m`` and model index ``r % m`` (the JAX mesh's ``devices[i * m +
j]``); ``mesh_groups`` forms this rank's data group (the ranks of its
model index, over which gradients and stats are averaged) and model group
(the ranks of its data index, over which channel-sharded parameters are
gathered).  The model axis's collectives keep one invariant: outside a
sharded op, activations and their gradients are the same on every rank of
a model group.  ``gather_model`` (all-gather forward, the rank's own slice
backward: the cotangent is the same on every rank, so nothing is summed),
``copy_to_model`` (identity forward, all-reduce backward: the rank's
cotangent of a replicated input is partial), and ``sum_model`` (all-reduce
forward, identity backward: a loss summed over the ranks' channels).  They
use only ``all_reduce`` and ``all_gather``, which gloo and NCCL both take;
bf16 tensors cross as their bytes in a gather and as float32 in a sum.
"""

import logging
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

LOGGER = logging.getLogger(__name__)


def rank_device(local_rank: Optional[int] = None) -> torch.device:
    """A rank's card: ``cuda:LOCAL_RANK`` (0 when unset)."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank)


def backend_for(device, shared: bool = False) -> str:
    """``nccl`` for a card of the rank's own, ``gloo`` on the CPU or where
    ranks share a card."""
    return "nccl" if torch.device(device).type == "cuda" and not shared \
        else "gloo"


def init_method(address: str) -> str:
    """``host:port`` as a TCP rendezvous; an address with a scheme
    (``tcp://``, ``file://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> bool:
    """Form or join the default process group (idempotent: a second call
    returns whether the group spans more than one process).  Returns
    False, and forms nothing, with no coordinator configured; True once
    the group is formed.  ``device`` is the rank's (default
    ``rank_device()``, selected as the current card); ``backend``
    defaults to ``backend_for(device)``."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    method = None
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and "WORLD_SIZE" in env \
                and "MASTER_ADDR" in env:
            # torchrun: its agent hosts the store that env:// joins
            coordinator_address, method = "%s:%s" % (
                env["MASTER_ADDR"], env.get("MASTER_PORT")), "env://"
    if num_processes is None:
        n = env.get("NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if n is None else int(n)
    if process_id is None:
        r = env.get("PROCESS_ID", env.get("RANK"))
        process_id = None if r is None else int(r)
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a multi-process start needs the coordinator's address, the "
            "number of processes and this process's id (got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r})")
    device = rank_device() if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or backend_for(device)
    dist.init_process_group(
        backend, init_method=method or init_method(coordinator_address),
        world_size=num_processes, rank=process_id)
    LOGGER.info("multi-process: rank %d of %d on %s over %s", process_id,
                num_processes, device, backend)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns file writes (logs, checkpoints,
    stores): rank 0, or the only process."""
    return process_index() == 0


def local_batch_slice(global_batch: int, model_size: int = 1) -> slice:
    """This process's contiguous share of a global batch: its data
    index's, over ``process_count() // model_size`` data shards."""
    per = global_batch // (process_count() // model_size)
    start = process_index() // model_size * per
    return slice(start, start + per)


def mesh_groups(data: int, model: int) -> Tuple:
    """(data group, model group) of this rank in a ``(data, model)`` mesh
    of every rank of the default group; a group of one rank is ``None``.
    Every rank forms every group, in the same order (``dist.new_group``
    is collective)."""
    if data * model != dist.get_world_size():
        raise ValueError(f"a mesh of data={data} x model={model} needs "
                         f"{data * model} ranks, {dist.get_world_size()} "
                         "in the group")
    if model == 1:
        return (dist.group.WORLD if data > 1 else None), None
    if data == 1:
        return None, dist.group.WORLD
    rank = dist.get_rank()
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    return data_groups[rank % model], model_groups[rank // model]


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's ranks, with a backward that sums the
    cotangents over them too; ``t`` itself for ``group=None``."""
    if group is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, group=group)


class ModelShard(NamedTuple):
    """A parameter or buffer held as a shard over a model group: the
    group, the rank's index in it, its size, and the sharded axis in the
    port's layout (``parallel/mesh.py:shard_model``)."""
    group: object
    index: int
    size: int
    axis: int

    def narrow(self, full: torch.Tensor, axis: Optional[int] = None
               ) -> torch.Tensor:
        """This rank's slice of the full tensor along ``axis`` (default:
        the parameter's)."""
        axis = self.axis if axis is None else axis
        per = full.shape[axis] // self.size
        return full.narrow(axis, self.index * per, per)


def param_shard(module: torch.nn.Module, name: str) -> Optional[ModelShard]:
    """The shard ``module``'s parameter or buffer ``name`` is held as, or
    None."""
    return (getattr(module, "model_shards", None) or {}).get(name)


def named_shards(module: torch.nn.Module) -> Dict[str, ModelShard]:
    """{qualified name: its shard} of ``module``'s parameters and buffers
    held as model-axis shards."""
    return {f"{where}.{name}" if where else name: s
            for where, m in module.named_modules()
            for name, s in (getattr(m, "model_shards", None) or {}).items()}


def full_param(module: torch.nn.Module, name: str):
    """``module``'s parameter or buffer ``name`` whole: gathered over its
    model group where it is held as a shard (differentiably where a
    gradient is wanted), else as it is."""
    t, s = getattr(module, name), param_shard(module, name)
    if s is None or t is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return gather_model(t, s.group, s.axis)
    return all_gather_axis(t, s.group, s.axis)


def column_parallel(module: torch.nn.Module, x: torch.Tensor, forward
                    ) -> torch.Tensor:
    """``forward(x)`` of a layer whose output channels are the last axis:
    where ``module.weight`` is held as a model-axis shard (its output
    channels, the bias with them), ``x`` (the same on every rank of the
    group) enters through ``copy_to_model``, ``forward`` computes the
    rank's channels, and ``gather_model`` concatenates them."""
    s = param_shard(module, "weight")
    if s is None:
        return forward(x)
    return gather_model(forward(copy_to_model(x, s.group)), s.group,
                        x.dim() - 1)


def all_gather_axis(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``axis`` in rank order,
    without a gradient (bf16 crosses as its bytes: the last axis's byte
    view doubles only that axis, so the concatenation is the same)."""
    words = t.contiguous()
    if words.dtype == torch.bfloat16:
        words = words.view(torch.uint8)
    parts = [torch.empty_like(words)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, words, group=group)
    return torch.cat(parts, dim=axis).view(t.dtype)


def _all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's ranks, bf16 summed in float32 and
    rounded once."""
    out = t.float().contiguous() if t.dtype == torch.bfloat16 \
        else t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _GatherModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group, axis):
        ctx.group, ctx.axis, ctx.per = group, axis, t.shape[axis]
        return all_gather_axis(t, group, axis)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, r * ctx.per, ctx.per), None, None


class _CopyToModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _SumModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_f32(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_model(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The model group's shards of a tensor concatenated along ``axis``;
    backward: the rank's own slice of the cotangent, which is the same on
    every rank of the group (nothing is summed)."""
    return _GatherModel.apply(t, group, axis)


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """``t``, the same on every rank, entering rank-local work (a channel
    slice, a column-parallel convolution); backward: the ranks' partial
    cotangents summed."""
    return _CopyToModel.apply(t, group)


def sum_model(t: torch.Tensor, group) -> torch.Tensor:
    """A per-rank partial (a loss over the rank's channels) summed over the
    group; backward: the cotangent as it is, since every rank's partial
    has its own parameters."""
    return _SumModel.apply(t, group)


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along axis 0 in rank order, without
    a gradient; ``t`` itself for ``group=None``."""
    return t if group is None else all_gather_axis(t, group, 0)
