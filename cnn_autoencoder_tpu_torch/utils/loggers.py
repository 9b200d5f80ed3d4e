"""The CLIs' file logger, the training metric line and the checkpoints.

The port's copy of the JAX package's ``utils/loggers.py``: a logger named
``<mode>_log`` writing bare message lines to
``<log_dir>/<mode>_ver<VER>_<seed><log_identifier>.log`` (and to the console
with ``print_log``); ``log_info``'s one-line metric string; ``checkpoint``,
which writes ``last_...msgpack`` at every validation and ``best_...msgpack``
when the validation loss improves, each holding the args, the module
variables, the optimizer and scheduler states and the loss histories.  File
names, the state layout and the log string are the JAX package's.  In a
multi-process run only the primary process (rank 0,
``parallel/distributed.py:is_primary``) owns the files: the others keep a
logger without a file (and the console with ``print_log``), and their
checkpoint calls write nothing but return the same paths.
"""

import logging
import os
from typing import Any, Dict, Optional

import numpy as np

from ..parallel.distributed import is_primary
from ..training.checkpoint import save_checkpoint


def setup_logger(args) -> logging.Logger:
    args_dict = args if isinstance(args, dict) else vars(args)
    mode = args_dict.get("mode", "training")
    logger = logging.getLogger(mode + "_log")
    logger.setLevel(logging.DEBUG)
    logger.handlers = []

    if is_primary():
        log_dir = args_dict.get("log_dir", ".")
        log_fn = os.path.join(
            log_dir, "%s_ver%s_%s%s.log" % (
                mode, args_dict.get("version", ""), args_dict.get("seed", 0),
                args_dict.get("log_identifier", "")))
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(log_fn, mode="a")
        fh.setLevel(logging.DEBUG)
        logger.addHandler(fh)
    else:
        log_fn = "<secondary process: no log file>"

    if args_dict.get("print_log", False):
        ch = logging.StreamHandler()
        ch.setLevel(logging.DEBUG)
        logger.addHandler(ch)

    logger.info("Logging to %s" % log_fn)
    return logger


def save_state(name: str, state: Dict[str, Any], args) -> str:
    args_dict = args if isinstance(args, dict) else vars(args)
    fn = os.path.join(
        args_dict["log_dir"],
        "%s_ver%s_%s%s.msgpack" % (name, args_dict.get("version", ""),
                                   args_dict.get("seed", 0),
                                   args_dict.get("log_identifier", "")))
    if is_primary():
        save_checkpoint(fn, state)
        logging.getLogger("training_log").info("Saved model in %s" % fn)
    return fn


def checkpoint(step: int, variables: Dict[str, Any],
               opt_states: Dict[str, Any], scheduler_states: Dict[str, Any],
               best_valid_loss: float, train_loss_history, valid_loss_history,
               args, extra_info: Optional[Dict[str, Any]] = None) -> float:
    """Write ``last`` (always) and ``best`` (on improvement) checkpoints.

    The state is one flat dict: args, module variables (JAX trees),
    optimizer states (``training/optim.py:optimizer_state_dict``),
    scheduler states and histories, so a checkpoint is self-describing.
    """
    args_dict = dict(args if isinstance(args, dict) else vars(args))

    state = dict(args_dict)
    state["best_val"] = float(best_valid_loss)
    state["step"] = int(step)
    state["train_loss"] = [float(v) for v in train_loss_history]
    state["valid_loss"] = [float(v) for v in valid_loss_history]
    state["code_version"] = args_dict.get("version", "")
    if extra_info:
        state.update(extra_info)

    for k, v in variables.items():
        state[k] = v
    for k, v in opt_states.items():
        state["optimizer_" + k] = v
    for k, v in (scheduler_states or {}).items():
        state["scheduler_" + k] = v

    save_state("last", state, args)

    if valid_loss_history and valid_loss_history[-1] < best_valid_loss:
        best_valid_loss = float(valid_loss_history[-1])
        save_state("best", state, args)

    return best_valid_loss


def log_info(step, sub_step, len_data, stats: Dict[str, Any],
             quantiles: Optional[np.ndarray] = None,
             avg_loss: Optional[float] = None,
             channel_e: int = -1,
             step_type: str = "Training",
             lr: Optional[str] = None,
             progress_bar: bool = False):
    """Build the dense one-line metric string + recorded-metrics dict
    (``stats`` of host numpy values)."""
    stats = {k: np.asarray(v) for k, v in (stats or {}).items()}
    log_string = "[{:06d}]".format(step) if step is not None else ""
    if not progress_bar:
        if len_data is None:
            log_string += "[{:04d}] ".format(sub_step)
        else:
            log_string += "[{:04d}/{:04d}] ".format(sub_step, len_data)

    recorded: Dict[str, float] = {}
    if avg_loss is not None:
        log_string += "{} Loss {:.4f}".format(step_type, avg_loss)
        recorded["loss"] = float(avg_loss)

    if "dist" in stats:
        dist = np.atleast_1d(stats["dist"])
        log_string += " D=[{}]".format(",".join("%0.4f" % d for d in dist))
        recorded["D"] = [float(d) for d in dist]
        if "x_min" in stats:
            log_string += " Xo={:.2f},{:.2f},std={:.2f}".format(
                stats["x_min"], stats["x_max"], stats["x_std"])
        if "x_r_min" in stats:
            log_string += " Xr={:.2f},{:.2f},std={:.2f}".format(
                stats["x_r_min"], stats["x_r_max"], stats["x_r_std"])
            recorded["x_r_min"] = float(stats["x_r_min"])
            recorded["x_r_max"] = float(stats["x_r_max"])
            recorded["x_r_std"] = float(stats["x_r_std"])

    if "rate_loss" in stats:
        log_string += " R={:.2f}".format(stats["rate_loss"])
        recorded["R"] = float(stats["rate_loss"])
        if "y_min" in stats:
            log_string += " BN={:.2f},{:.2f} P={:.2f},{:.2f}".format(
                stats["y_min"], stats["y_max"], stats["p_y_min"],
                stats["p_y_max"])
            for k in ("y_min", "y_max", "p_y_min", "p_y_max"):
                recorded[k] = float(stats[k])

    if "entropy_loss" in stats:
        log_string += " A={:.3f}".format(stats["entropy_loss"])
        recorded["A"] = float(stats["entropy_loss"])
        if quantiles is not None:
            q = np.asarray(quantiles)
            q1, q2, q3 = (float(np.median(q[:, 0, i])) for i in range(3))
            log_string += " QP={:.2f},{:.2f},{:.2f}".format(q1, q2, q3)
            recorded.update({"q1": q1, "q2": q2, "q3": q3})

    if "energy" in stats:
        log_string += " E={:.3f}".format(stats["energy"])
        recorded["E"] = float(stats["energy"])

    if "class_error" in stats:
        log_string += " C={:.3f}".format(stats["class_error"])
        recorded["C"] = float(stats["class_error"])

    if channel_e >= 0:
        log_string += " Ch={}".format(int(channel_e))
        recorded["Ch"] = int(channel_e)

    if lr:
        log_string += " lr={}".format(lr)

    return log_string, recorded
