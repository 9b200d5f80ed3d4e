"""Argument parser: task/mode filtering, JSON config defaults, typed args.

The port's copy of the JAX package's ``utils/args/parser.py``: flags carry
task/mode applicability; a JSON config file sets *defaults* so CLI flags
always override; ``seed < 0`` draws a random seed; per-module
hyperparameters use ``module=type:value`` strings.  ``-g/--gpu`` is accepted
as the JAX parser accepts it; the port's CLIs always run on the card.
"""

import argparse
import json
from typing import Dict

import numpy as np

from ...version import VER
from .tables import ALL_ARGS


def build_parser(task: str, mode: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        f"Arguments for running {task} in mode {mode}",
        conflict_handler="resolve")
    parser.add_argument("-c", "--config", dest="config_file", type=str,
                        help="A configuration .json file")
    parser.add_argument("-g", "--gpu", action="store_true", dest="use_gpu",
                        help="Accepted for parity with the JAX CLI; the "
                             "port's CLIs always run on the GPU")
    for tasks, modes, flags, dest, kwargs in ALL_ARGS:
        if (task in tasks or "all" in tasks) and \
                (mode in modes or "all" in modes):
            parser.add_argument(*flags, dest=dest, **kwargs)
    return parser


def override_config_file(parser: argparse.ArgumentParser, args_list=None):
    args = parser.parse_args(args_list)

    config_parser = argparse.ArgumentParser(parents=[parser], add_help=False)
    if getattr(args, "config_file", None) is not None:
        if ".json" not in args.config_file:
            raise ValueError("The configure file must be a .json file")
        with open(args.config_file) as f:
            config = json.load(f)
        config_parser.set_defaults(**config)

    args = config_parser.parse_args(args_list)

    if getattr(args, "seed", 0) is not None and args.seed < 0:
        args.seed = int(np.random.randint(1, 100000))
    np.random.seed(args.seed + 1)

    return args


def get_args(task: str, mode: str, parser_only: bool = False,
             args_list=None):
    parser = build_parser(task, mode)
    if parser_only:
        return parser
    args = override_config_file(parser, args_list)
    args.mode = mode
    args.task = task
    args.version = VER
    args.gpu = getattr(args, "use_gpu", False)
    return args


def parse_typed_arguments(args) -> Dict[str, object]:
    """Parse ``name=type:value`` strings."""
    if args is None:
        return {}
    if isinstance(args, (str, float, int)):
        # scalar values of some -m* flags carry no per-module settings
        return {}
    parsed = {}
    for arg in args:
        name, type_val = arg.split("=")
        if ":" in type_val:
            arg_type, arg_val = type_val.split(":")
        else:
            arg_type, arg_val = "str", type_val
        if arg_type == "int":
            parsed[name] = int(arg_val)
        elif arg_type == "float":
            parsed[name] = float(arg_val)
        elif arg_type.lower() == "none":
            parsed[name] = None
        else:
            parsed[name] = arg_val
    return parsed
