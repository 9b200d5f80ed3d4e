from .parser import (build_parser, get_args, override_config_file,
                     parse_typed_arguments)

__all__ = ["build_parser", "get_args", "override_config_file",
           "parse_typed_arguments"]
