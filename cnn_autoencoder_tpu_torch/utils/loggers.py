"""The CLIs' file logger.

The port's copy of ``setup_logger`` from the JAX package's
``utils/loggers.py``: a logger named ``<mode>_log`` writing bare message
lines to ``<log_dir>/<mode>_ver<VER>_<seed><log_identifier>.log`` (and to
the console with ``print_log``), the file name and line format of the JAX
CLIs.  The port's CLIs run one process, which owns the file.  The JAX
module's ``save_state`` / ``checkpoint`` write optimizer and scheduler
states and loss histories, which the port's ``training/checkpoint.py:
save_checkpoint`` does not carry; they come with optimizer-state resume and
the training CLI, as does ``log_info`` (``ROADMAP.md`` §1 item 5).
"""

import logging
import os


def setup_logger(args) -> logging.Logger:
    args_dict = args if isinstance(args, dict) else vars(args)
    mode = args_dict.get("mode", "training")
    logger = logging.getLogger(mode + "_log")
    logger.setLevel(logging.DEBUG)
    logger.handlers = []

    log_dir = args_dict.get("log_dir", ".")
    log_fn = os.path.join(
        log_dir, "%s_ver%s_%s%s.log" % (mode, args_dict.get("version", ""),
                                        args_dict.get("seed", 0),
                                        args_dict.get("log_identifier", "")))
    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(log_fn, mode="a")
    fh.setLevel(logging.DEBUG)
    logger.addHandler(fh)

    if args_dict.get("print_log", False):
        ch = logging.StreamHandler()
        ch.setLevel(logging.DEBUG)
        logger.addHandler(ch)

    logger.info("Logging to %s" % log_fn)
    return logger
