"""Training entry point: the port of the JAX package's ``cli/train_cae.py``.

Usage: ``python -m cnn_autoencoder_tpu_torch.cli.train_cae -ds Zarr ...``
with the JAX CLI's flags.  The host loop keeps the JAX CLI's control: a
train step per
batch, validation and ``last_`` / ``best_`` checkpoints every
``checkpoint_steps`` (and when training stops), warm-up and plateau
schedulers, early stopping, the energy penalties' sub-iterations on one
batch (PA / PB criteria: train steps on the same batch until the energy
criterion stops them or ``--sub-steps`` are done), and resume from a
checkpoint (``.msgpack`` or a reference ``.pth``), with its optimizer and
scheduler state under ``--resume-optimizers``.  Checkpoints are the JAX
package's files and load in either package.

The compute type is ``ops/convops.py``'s default precision
(``CAE_TPU_PRECISION``: "highest", "high" and "default" float32, the last
two with one-pass or bf16_3x convolution products, "bf16" bf16
activations); the dropout masks and the bottleneck's
training noise come from one ``torch.Generator`` on the device, seeded from
``-rs``.  The architecture flags (``-res``, ``-bn``, ``-do``, ``-act``, the
widths) reach the model; ``last_`` and ``best_`` checkpoints carry a
batch-norm model's running statistics (``batch_stats``).

The compressed-domain heads train through the same loop: ``-cmt ViT|ResNet|
InceptionV3`` with ``-ccp`` (the cut) or ``-smt UNet|JNet`` (with ``-snch``,
``-sbch``, ``-sech``) add the head to the model (a checkpoint without one
starts it from seed 0), a criterion with a class loss (``-cr RateMSECE``,
``RateMSEBCE``, ... ``WithAux`` / ``Weighted`` by name) takes the batches'
targets, ``-trm class_model`` or ``-trm seg_model`` trains the head alone on
the frozen codec, and the log line reports ``C=`` (the class error).
``num_classes`` comes from the dataset (``get_data``; ``-ncl`` for zarr).

Devices and processes (the JAX CLI's training mesh and multi-host start,
in PyTorch's idiom of one process a card): ``main(args, device=None,
devices=None)`` trains on ``devices`` (default: ``[device]`` when it is
given, else every visible card; ``None`` without a card raises, the tests
pass ``"cpu"``).  ``CAE_TPU_MODEL_PARALLEL=m`` (default 1) is the model
axis: data parallelism takes the largest divisor of both batch sizes that
fits ``len(devices) // m`` (JAX ``cli/train_cae.py:380-403``), and above
one rank in all ``main`` starts ``data * m`` ranks, one a device, with
``torch.multiprocessing`` (spawn) and a ``file://`` rendezvous in the log
directory, over NCCL when every rank has a card of its own and gloo on the
CPU or where ranks share a card (``parallel/distributed.py``), and waits
for them.  A process already started as a rank (the JAX package's
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``, or
torchrun's variables) joins its group instead, on ``cuda:LOCAL_RANK``;
the number of ranks must divide by ``m``, and both batch sizes by the
data axis's size.  Rank ``r`` is data index ``r // m``, model index ``r %
m`` (``distributed.mesh_groups``).  Every rank reads the same global
batches, keeps its data index's contiguous share (``local_batch_slice``;
a ragged batch is cut to a multiple of the data axis, with one log line)
and steps data-parallel over its data group (``training/loop.py``); under
``m > 1`` its model, whatever its architecture and head and whichever
modules train, holds the sharded parameters and batch norms' running
statistics as its model index's slices (``parallel/mesh.py:
shard_model``), and ``last_`` / ``best_`` hold them gathered, with the
same keys, shapes and layout as one process's (a resume reads them whole
and shards them).  Only rank 0 writes the log,
``last_`` / ``best_`` and the stats.  ``CAE_TPU_TRAIN_MESH=0`` trains on
the first device alone, whatever the model axis.
"""

import logging
import math
import os
import uuid
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..criteria.loss import setup_loss
from ..criteria.stopping import setup_stopping_criteria
from ..data.datautils import get_data
from ..models.factory import CAEModel, autoencoder_from_state_dict, build_model
from ..ops.convops import get_default_precision, set_default_precision
from ..ops.kernels import kernel_wrappers
from ..parallel.distributed import (backend_for, full_param,
                                    initialize_multihost, local_batch_slice,
                                    mesh_groups, rank_device, world_size)
from ..parallel.mesh import (create_mesh, gather_model_state, shard_model,
                             visible_devices)
from ..training import checkpoint as ckpt
from ..training.loop import make_eval_step, make_train_step, valid
from ..training.optim import (load_optimizer_state_dict,
                              optimizer_state_dict, setup_optimizers)
from ..training.schedulers import SCHEDULER_ALGORITHMS
from ..utils import loggers
from ..utils.args import get_args, parse_typed_arguments
from ..utils.device import resolve_device
from ..utils.weights import state_to_jax

# the compute type of each default precision ("default" and "high" train
# float32 activations with their convolutions' products in both directions)
COMPUTE_DTYPES = {"highest": torch.float32, "default": torch.float32,
                  "high": torch.float32, "bf16": torch.bfloat16}


def setup_network(args, device=None) -> CAEModel:
    """Build the model from the args, or load it from ``args.checkpoint``
    with the args' non-None values over the checkpoint's config (JAX
    ``cli/train_cae.py:34``); in train mode on ``device``."""
    args_dict = dict(args if isinstance(args, dict) else vars(args))
    if args_dict.get("checkpoint"):
        state = ckpt.load_checkpoint(args_dict["checkpoint"])
        state.update({k: v for k, v in args_dict.items() if v is not None})
        args_dict = state

    args_dict["multiscale_analysis"] = "Multiscale" in args_dict.get(
        "criterion", "")

    if args_dict.get("checkpoint"):
        model = autoencoder_from_state_dict(args_dict, device=device)
    else:
        generator = torch.Generator().manual_seed(
            int(args_dict.get("seed", 0) or 0))
        model = build_model({k: v for k, v in args_dict.items()
                             if k != "checkpoint"}, generator=generator,
                            device=device)
    return model.train()


def setup_criteria(args, checkpoint=None):
    args_dict = dict(vars(args)) if not isinstance(args, dict) else dict(args)
    if "PB" in args_dict.get("criterion", ""):
        channel_e = 0
        if checkpoint is not None:
            state = ckpt.load_checkpoint(checkpoint)
            channel_e = int(state.get("channel_e", 0) or 0)
        args_dict["channel_e"] = channel_e
    stopping_criteria = setup_stopping_criteria(**args_dict)
    criterion = setup_loss(**args_dict)
    return criterion, stopping_criteria


def setup_optim(model: CAEModel, args):
    """Per-module optimizer slots, host-side schedulers and the learning
    rate dict: ``(optimizers, schedulers, lrs)``."""
    optim_algos = parse_typed_arguments(args.mod_optim_algo)
    mod_lr = parse_typed_arguments(args.mod_learning_rate)
    mod_wd = parse_typed_arguments(args.mod_weight_decay)
    mod_aux_lr = parse_typed_arguments(args.mod_aux_learning_rate)
    mod_aux_wd = parse_typed_arguments(args.mod_aux_weight_decay)
    mod_accum = parse_typed_arguments(args.mod_grad_accumulate)

    scheduler_algos = {}
    for mod_pars in (args.mod_scheduler_algo or []):
        mod = mod_pars[:mod_pars.find("=")]
        sched_spec = mod_pars[mod_pars.find("=") + 1:]
        sched_type = sched_spec.split(",")[0]
        if sched_type.lower() == "none":
            sched_type = None
        sched_args = parse_typed_arguments(sched_spec.split(",")[1:])
        scheduler_algos[mod] = (sched_type, sched_args)

    trainable = [m for m in args.trainable_modules if hasattr(model, m)]
    default_algo = getattr(args, "optim_algo", "Adam")
    algo_map = {k: optim_algos.get(k, default_algo) for k in trainable}

    optimizers = setup_optimizers(
        model, trainable, mod_optim_algo=algo_map,
        mod_weight_decay={k: mod_wd.get(k, args.weight_decay)
                          for k in trainable},
        mod_aux_weight_decay={k: mod_aux_wd.get(k, args.aux_weight_decay)
                              for k in trainable},
        mod_grad_accumulate={k: mod_accum.get(k, 1) for k in trainable})

    lrs: Dict[str, float] = {}
    for name in optimizers:
        base = name[:-4] if name.endswith("_aux") else name
        if name.endswith("_aux"):
            lrs[name] = float(mod_aux_lr.get(base, args.aux_learning_rate))
        else:
            lrs[name] = float(mod_lr.get(base, args.learning_rate))

    schedulers = {}
    for name in optimizers:
        base = name[:-4] if name.endswith("_aux") else name
        sched_type, sched_args = scheduler_algos.get(base, (None, None))
        if sched_type is not None:
            schedulers[name] = SCHEDULER_ALGORITHMS[sched_type](
                lrs, name, **(sched_args or {}))

    if args.early_warmup > 0:
        for name in list(optimizers):
            schedulers[name + "_warmup"] = SCHEDULER_ALGORITHMS["LinearLR"](
                lrs, name, start_factor=1.0 / args.early_warmup,
                end_factor=1.0, total_iters=args.early_warmup)

    return optimizers, schedulers, lrs


def resume_optimizer(optimizers, schedulers, checkpoint, model) -> None:
    """Restore the slots' and schedulers' state from a checkpoint that
    either package wrote (``optimizer_<slot>``, ``scheduler_<name>``)."""
    state = ckpt.load_checkpoint(checkpoint)
    for name, slot in optimizers.items():
        saved = state.get("optimizer_" + name)
        if saved is not None:
            load_optimizer_state_dict(slot, model, saved)
    for name, sched in schedulers.items():
        saved = state.get("scheduler_" + name)
        if saved:
            sched.load_state_dict(saved)


def _host(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A step's stats as host numpy values (bf16 ones widened)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in stats.items()}


def train(model, train_data, valid_data, criterion, stopping_criteria,
          optimizers, schedulers, lrs, args,
          compute_dtype: torch.dtype = torch.float32, group=None,
          on_step=None, model_group=None) -> Dict:
    """The host training loop (JAX ``cli/train_cae.py:150``) on the model's
    device, data-parallel over ``group`` when one is given (this rank
    feeds its data index's share of every global batch), with the model's
    parameters held as shards over ``model_group`` when one is given.  ``on_step(step, stats, grads,
    model)``, when given, runs after every train step (sub-steps
    included) with the host stats, the step's gradients and the updated
    model.  Returns
    ``{"completed": whether it ran to the end of its epochs, "on_step":
    on_step's return values in step order}``."""
    logger = logging.getLogger(args.mode + "_log")
    device = next(model.parameters()).device
    trainable = [m for m in args.trainable_modules if hasattr(model, m)]

    train_step = make_train_step(model, criterion, optimizers,
                                 enabled_modules=args.enabled_modules,
                                 trainable_modules=trainable,
                                 compute_dtype=compute_dtype, group=group,
                                 model_group=model_group)
    eval_step = make_eval_step(model, criterion,
                               enabled_modules=args.enabled_modules,
                               compute_dtype=compute_dtype, group=group,
                               model_group=model_group)
    generator = torch.Generator(device=device).manual_seed(
        int(args.seed or 0))
    n_ranks = world_size(group)
    model_size = world_size(model_group)
    ragged_logged = [False]
    observed = []

    def placed_batches(data):
        """Host batches -> float32 tensors on the device, and their targets
        (labels or label maps) as tensors there.  Over ranks, a batch not
        divisible by them is cut to a multiple (one log line), one that
        gives each rank nothing is dropped, and each rank keeps its
        share."""
        for x, t in data:
            if group is not None:
                keep = len(x) // n_ranks * n_ranks
                if keep < len(x) and not ragged_logged[0]:
                    ragged_logged[0] = True
                    logger.info("Ragged batch of %d (not divisible by %d "
                                "data shards): keeping %d"
                                % (len(x), n_ranks, keep))
                if keep == 0:
                    continue
                sl = local_batch_slice(keep, model_size)
                x = x[sl]
                t = None if t is None else t[sl]
            yield (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                device), None if t is None else
                torch.from_numpy(np.ascontiguousarray(t)).to(device))

    best_valid_loss = float("inf")
    train_loss_history, valid_loss_history = [], []
    channel_e_history = []
    extra_metrics = None
    rec_metrics = None
    keep_training = True
    completed = False
    step = 0

    while keep_training:
        sum_loss = 0.0
        epoch_start_step = step
        for i, (x, t) in enumerate(placed_batches(train_data)):
            step += 1

            if "penalty" in stopping_criteria:
                stopping_criteria["penalty"].reset()

            # sub-steps on one batch, each with fresh noise from the
            # generator (JAX cli/train_cae.py:236-262)
            sub_step = 0
            sub_step_loss = 0.0
            while True:
                sub_step += 1
                stats, grads = train_step(x, lrs, step, generator=generator,
                                          t=t)
                stats = _host(stats)
                if on_step is not None:
                    observed.append(on_step(step, stats, grads, model))
                sub_step_loss += float(stats["loss"])
                channel_e_history.append(int(stats.get("channel_e", -1)))

                if "penalty" in stopping_criteria:
                    stopping_criteria["penalty"].update(
                        iteration=sub_step, metric=float(stats["energy"]))
                    if not stopping_criteria["penalty"].check():
                        break
                else:
                    break

            sum_loss += sub_step_loss / sub_step

            if i % max(1, int(0.01 * len(train_data))) == 0:
                channel_e = int(np.median(channel_e_history)) \
                    if channel_e_history else -1
                lr_str = " ".join(f"{k}={v:.2e}" for k, v in lrs.items())
                # (gathered over the model group on every rank)
                quantiles = (full_param(model.fact_ent, "quantiles").detach()
                             .cpu().numpy() if hasattr(model, "fact_ent")
                             else None)
                log_str, curr_rec = loggers.log_info(
                    step, i + 1, len(train_data), stats,
                    quantiles=quantiles,
                    avg_loss=sum_loss / (i + 1), channel_e=channel_e,
                    step_type="Training", lr=lr_str)
                logger.debug(log_str)
                if rec_metrics is None:
                    rec_metrics = {m: [] for m in curr_rec}
                for m, v in curr_rec.items():
                    rec_metrics.setdefault(m, []).append(v)

            keep_training = stopping_criteria["early_stopping"].check()

            if (not keep_training
                    or (step >= args.early_warmup
                        and (step - args.early_warmup)
                        % args.checkpoint_steps == 0) and step > 1):
                train_loss = sum_loss / (i + 1)
                valid_loss, val_avg_metrics = valid(
                    eval_step, placed_batches(valid_data))

                for name, sched in schedulers.items():
                    if name.endswith("_warmup"):
                        continue
                    sched.step(valid_loss)

                train_loss_history.append(train_loss)
                valid_loss_history.append(valid_loss)

                trn_avg_metrics = {}
                if rec_metrics is not None:
                    for m, v in rec_metrics.items():
                        vals = [x for x in v
                                if isinstance(x, (int, float))]
                        if vals:
                            trn_avg_metrics["trn_" + m] = float(
                                np.nanmean(vals))

                channel_e = int(np.median(channel_e_history)) \
                    if channel_e_history else -1
                if extra_metrics is None:
                    extra_metrics = {"channel_e": []}
                extra_metrics["channel_e"].append(channel_e)
                for m, v in {**trn_avg_metrics, **val_avg_metrics}.items():
                    extra_metrics.setdefault(m, []).append(v)

                scheduler_states = {k: s.state_dict()
                                    for k, s in schedulers.items()}
                # (collectives under the model axis: every rank gathers,
                # rank 0 writes)
                best_valid_loss = loggers.checkpoint(
                    step, state_to_jax(gather_model_state(model),
                                       model.config),
                    {k: optimizer_state_dict(s, model)
                     for k, s in optimizers.items()},
                    scheduler_states, best_valid_loss, train_loss_history,
                    valid_loss_history, args,
                    extra_info={"channel_e": channel_e,
                                "extra_metrics": extra_metrics})
                channel_e_history = []
                rec_metrics = None

                logger.info(
                    "[Step {:06d} ({})] Training loss {:0.4f}, validation "
                    "loss {:.4f}, best validation loss {:.4f}".format(
                        step, "training" if keep_training else "stopping",
                        train_loss, valid_loss, best_valid_loss))

                stopping_criteria["early_stopping"].update(
                    iteration=step, metric=valid_loss)
            else:
                stopping_criteria["early_stopping"].update(iteration=step)

            if step <= args.early_warmup:
                for name, sched in schedulers.items():
                    if name.endswith("_warmup"):
                        sched.step()

            if not keep_training:
                logger.info("**** Stopping criteria met: interrupting "
                            "training ****")
                break
        else:
            if step == epoch_start_step:
                raise RuntimeError(
                    "no training batch survived this epoch: the loader "
                    "gave none, or its batch size is too small for %d "
                    "data shards (see the 'Ragged batch' log line)"
                    % n_ranks)
            continue
        break
    else:
        completed = True

    return {"completed": completed, "on_step": observed}


def data_parallel_size(args, n_devices: int) -> int:
    """The largest divisor of both batch sizes that fits ``n_devices``, so
    that no batch is cut (JAX ``cli/train_cae.py:396-403``)."""
    bs = int(getattr(args, "batch_size", 0) or 0)
    vbs = int(getattr(args, "val_batch_size", 0) or 0) or bs
    if not bs:
        return n_devices
    g = math.gcd(bs, vbs)
    return max(d for d in range(1, n_devices + 1) if g % d == 0)


def _check_rank_batches(args, n_ranks: int, model_size: int = 1) -> int:
    """Ranks started from outside: their count must divide by the model
    axis's size, and both batch sizes by the data axis's (the JAX CLI's
    multi-host rule).  Returns the data axis's size."""
    if n_ranks % model_size:
        raise ValueError("multi-process training over model=%d needs a "
                         "process count divisible by it (%d)"
                         % (model_size, n_ranks))
    data = n_ranks // model_size
    bs = int(getattr(args, "batch_size", 0) or 0)
    vbs = int(getattr(args, "val_batch_size", 0) or 0) or bs
    for name, b in (("batch size", bs), ("validation batch size", vbs)):
        if b % data:
            raise ValueError("multi-process training needs the global %s "
                             "(%d) divisible by the data-mesh size (%d)"
                             % (name, b, data))
    return data


def model_parallel_size() -> int:
    """``CAE_TPU_MODEL_PARALLEL``, the model axis's size (1 unset)."""
    m = int(os.environ.get("CAE_TPU_MODEL_PARALLEL", "1") or 1)
    if m < 1:
        raise ValueError(f"CAE_TPU_MODEL_PARALLEL={m}: the model axis "
                         "needs a size >= 1")
    return m


def main(args, device=None, devices=None, on_step=None) -> List[Dict]:
    """Train as the args say on ``devices`` (the module's docstring), one
    rank a device.  ``on_step`` (picklable, for ranks that are started
    here) is ``train``'s.  Returns one report a rank, in rank order:
    ``{"rank", "ranks", "device", "completed", "on_step", "launches"}``
    (``launches``: the rank's process's kernel launches by kernel)."""
    model = model_parallel_size()
    if initialize_multihost(device=device) or dist.is_initialized():
        data = _check_rank_batches(args, dist.get_world_size(), model)
        dev = rank_device() if device is None else resolve_device(device)
        return [_train_rank(args, dev, *mesh_groups(data, model),
                            on_step=on_step)]
    if devices is None:
        devices = [device] if device is not None else visible_devices()
    # the training mesh's devices: one spelling a card, so that ranks
    # sharing one are seen to
    devices = list(create_mesh(devices=devices).devices)
    if os.environ.get("CAE_TPU_TRAIN_MESH", "1") == "0":
        devices, model = devices[:1], 1
    if model > len(devices):
        raise ValueError(f"CAE_TPU_MODEL_PARALLEL={model} needs at least "
                         f"{model} devices, {len(devices)} given")
    data = data_parallel_size(args, len(devices) // model)
    n = data * model
    if n == 1:
        return [_train_rank(args, devices[0], None, on_step=on_step)]
    devices = devices[:n]
    shared = len(set(devices)) < n
    backend = backend_for(devices[0], shared)
    logging.getLogger(args.mode + "_log").info(
        "Training mesh: data=%d x model=%d over %s (%s)"
        % (data, model, [str(d) for d in devices], backend))
    return _spawn_ranks(args, devices, backend, on_step, model)


def _spawn_ranks(args, devices, backend: str, on_step,
                 model: int = 1) -> List[Dict]:
    """One spawned process a device, joined through a ``file://``
    rendezvous in the log directory; their reports in rank order.  A rank
    that raises stops the others and raises here."""
    import torch.multiprocessing as mp
    os.makedirs(args.log_dir, exist_ok=True)
    rendezvous = os.path.join(os.path.abspath(args.log_dir),
                              ".rendezvous_%s" % uuid.uuid4().hex)
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_worker, args=(len(devices), "file://" + rendezvous, args,
                            devices, backend, get_default_precision(),
                            on_step, queue, model),
        nprocs=len(devices), join=False, start_method="spawn")
    reports = []
    try:
        while not procs.join(timeout=0.5):
            while not queue.empty():
                reports.append(queue.get())
        while not queue.empty():
            reports.append(queue.get())
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
    return sorted(reports, key=lambda r: r["rank"])


def _rank_worker(rank: int, n: int, rendezvous: str, args, devices,
                 backend: str, precision: str, on_step, queue,
                 model: int = 1) -> None:
    """A spawned rank: join the group, form the mesh's groups, train,
    report, leave."""
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    set_default_precision(precision)
    dist.init_process_group(backend, init_method=rendezvous, world_size=n,
                            rank=rank)
    try:
        loggers.setup_logger(args)
        queue.put(_train_rank(args, device, *mesh_groups(n // model, model),
                              on_step=on_step))
    finally:
        dist.destroy_process_group()


def _train_rank(args, dev: torch.device, group, model_group=None,
                on_step=None) -> Dict:
    """One process's training on ``dev``: data-parallel over ``group``
    (None: one data index), its parameters sharded over ``model_group``
    (None: whole), or alone."""
    logger = logging.getLogger(args.mode + "_log")
    compute_dtype = COMPUTE_DTYPES[get_default_precision()]
    alone = group is None and model_group is None
    rank, n_ranks = (0, 1) if alone else (dist.get_rank(),
                                          dist.get_world_size())

    train_data, valid_data, num_classes = get_data(args, device=dev)
    args.num_classes = num_classes

    model = setup_network(args, device=dev)
    if model_group is not None:
        # read whole (a checkpoint's or the seed's), held as this rank's
        # slices before the optimizer makes its state
        shard_model(model, model_group, dist.get_rank(model_group),
                    world_size(model_group))
    criterion, stopping_criteria = setup_criteria(args,
                                                  checkpoint=args.checkpoint)
    optimizers, schedulers, lrs = setup_optim(model, args)

    if getattr(args, "resume_optimizer", None) and args.checkpoint:
        resume_optimizer(optimizers, schedulers, args.checkpoint, model)

    logger.info("Network modules: %s (trainable: %s)"
                % ([n for n, _ in model.named_children()],
                   args.trainable_modules))
    logger.info("Criterion: %s" % args.criterion)
    logger.info("Optimizers: %s" % {k: lrs[k] for k in optimizers})
    logger.info("Compute type: %s on %s" % (compute_dtype, dev))
    if not alone:
        logger.info("Rank %d of %d on %s over %s"
                    % (rank, n_ranks, dev, dist.get_backend()))

    result = train(model, train_data, valid_data, criterion,
                   stopping_criteria, optimizers, schedulers, lrs, args,
                   compute_dtype=compute_dtype, group=group, on_step=on_step,
                   model_group=model_group)
    # (a wrapper swapped for its plain version has no count)
    return dict(result, rank=rank, ranks=n_ranks, device=str(dev),
                launches={fn.kernel_name: fn.launches
                          for fn in kernel_wrappers()
                          if hasattr(fn, "kernel_name")})


def cli():
    """Console entry point: parse argv and train on every visible card
    (one rank a card), or as the rank the environment names."""
    args = get_args(task="autoencoder", mode="training")
    # before the logger: its file is rank 0's
    initialize_multihost()
    loggers.setup_logger(args)
    main(args)


if __name__ == "__main__":
    cli()
