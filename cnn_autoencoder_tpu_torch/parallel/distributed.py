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
"""

import logging
import os
from typing import Optional

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


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous share of a global batch."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's ranks, with a backward that sums the
    cotangents over them too; ``t`` itself for ``group=None``."""
    if group is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, group=group)


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along axis 0 in rank order, without
    a gradient; ``t`` itself for ``group=None``."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
