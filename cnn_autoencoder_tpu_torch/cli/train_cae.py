"""Training entry point: the port of the JAX package's ``cli/train_cae.py``.

Usage: ``python -m cnn_autoencoder_tpu_torch.cli.train_cae -ds Zarr ...``
with the JAX CLI's flags.  One process trains on one card (``main``'s
``device``; ``None`` is the card and raises without one, the tests pass
``"cpu"``).  The host loop keeps the JAX CLI's control: a train step per
batch, validation and ``last_`` / ``best_`` checkpoints every
``checkpoint_steps`` (and when training stops), warm-up and plateau
schedulers, early stopping, and resume from a checkpoint, with its
optimizer and scheduler state under ``--resume-optimizers``.  Checkpoints
are the JAX package's files and load in either package.

The compute type is ``ops/convops.py``'s default precision ("highest":
float32, "bf16": bf16 activations); the bottleneck's training noise comes
from one ``torch.Generator`` on the device, seeded from ``-rs``.

Left out: the JAX CLI's mesh and multi-host branches (``ROADMAP.md`` §1 item
10), and the penalty criteria's sub-iterations, whose losses raise "not
ported" in ``criteria/loss.py`` (item 6).
"""

import logging
from typing import Dict

import numpy as np
import torch

from ..criteria.loss import setup_loss
from ..criteria.stopping import setup_stopping_criteria
from ..data.datautils import get_data
from ..models.factory import CAEModel, autoencoder_from_state_dict, build_model
from ..ops.convops import get_default_precision
from ..training import checkpoint as ckpt
from ..training.loop import make_eval_step, make_train_step, valid
from ..training.optim import (load_optimizer_state_dict,
                              optimizer_state_dict, setup_optimizers)
from ..training.schedulers import SCHEDULER_ALGORITHMS
from ..utils import loggers
from ..utils.args import get_args, parse_typed_arguments
from ..utils.device import resolve_device
from ..utils.weights import state_to_jax

# the compute type of each default precision the port runs
COMPUTE_DTYPES = {"highest": torch.float32, "bf16": torch.bfloat16}


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
          compute_dtype: torch.dtype = torch.float32) -> bool:
    """The host training loop (JAX ``cli/train_cae.py:150``) on the model's
    device; returns whether it ran to the end of its epochs."""
    logger = logging.getLogger(args.mode + "_log")
    device = next(model.parameters()).device
    trainable = [m for m in args.trainable_modules if hasattr(model, m)]

    train_step = make_train_step(model, criterion, optimizers,
                                 enabled_modules=args.enabled_modules,
                                 trainable_modules=trainable,
                                 compute_dtype=compute_dtype)
    eval_step = make_eval_step(model, criterion,
                               enabled_modules=args.enabled_modules,
                               compute_dtype=compute_dtype)
    generator = torch.Generator(device=device).manual_seed(
        int(args.seed or 0))

    def placed_batches(data):
        """Host batches -> float32 tensors on the device."""
        for x, t in data:
            yield torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                device), t

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
        for i, (x, _) in enumerate(placed_batches(train_data)):
            step += 1
            stats, _ = train_step(x, lrs, step, generator=generator)
            stats = _host(stats)
            sum_loss += float(stats["loss"])
            channel_e_history.append(int(stats.get("channel_e", -1)))

            if i % max(1, int(0.01 * len(train_data))) == 0:
                channel_e = int(np.median(channel_e_history)) \
                    if channel_e_history else -1
                lr_str = " ".join(f"{k}={v:.2e}" for k, v in lrs.items())
                log_str, curr_rec = loggers.log_info(
                    step, i + 1, len(train_data), stats,
                    quantiles=model.fact_ent.quantiles.detach().cpu().numpy()
                    if hasattr(model, "fact_ent") else None,
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
                best_valid_loss = loggers.checkpoint(
                    step, state_to_jax(model.state_dict()),
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
                raise RuntimeError("the training data gave no batch this "
                                   "epoch")
            continue
        break
    else:
        completed = True

    return completed


def main(args, device=None) -> None:
    """Train as the args say, on ``device`` (``None``: the card)."""
    logger = logging.getLogger(args.mode + "_log")
    dev = resolve_device(device)
    compute_dtype = COMPUTE_DTYPES[get_default_precision()]

    train_data, valid_data, num_classes = get_data(args, device=dev)
    args.num_classes = num_classes

    model = setup_network(args, device=dev)
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

    train(model, train_data, valid_data, criterion, stopping_criteria,
          optimizers, schedulers, lrs, args, compute_dtype=compute_dtype)


def cli():
    """Console entry point: parse argv and train on the card."""
    args = get_args(task="autoencoder", mode="training")
    loggers.setup_logger(args)
    main(args)


if __name__ == "__main__":
    cli()
