"""Filename resolution for the CLIs.

The port's copy of ``get_filenames`` from the JAX package's
``data/datautils.py:23``: directories, explicit lists, ``.txt`` manifests
and paths that name their format, with train/val/test substring filtering.
The dataset loaders beside it in the JAX module come with the data layer
(``ROADMAP.md`` §1 item 5).
"""

import os
from functools import partial, reduce
from typing import List

import numpy as np


def get_filenames(source, source_format: str, data_mode: str) -> List[str]:
    if (isinstance(source, str) and source_format in source.lower()) \
            or isinstance(source, np.ndarray):
        return [source]

    if isinstance(source, list):
        source_mode = [fn for fn in source
                       if isinstance(fn, str) and data_mode in fn]
        if source_mode:
            source = source_mode
        return reduce(lambda l1, l2: l1 + l2,
                      map(partial(get_filenames, source_format=source_format,
                                  data_mode=data_mode), source), [])

    if isinstance(source, str) and source.lower().endswith("txt"):
        with open(source) as f:
            filenames = [line.strip("\n\r ") for line in f.readlines()]
        return get_filenames(filenames, source_format, data_mode)

    if isinstance(source, str) and os.path.isdir(source):
        entries = [os.path.join(source, fn)
                   for fn in sorted(os.listdir(source))
                   if source_format in fn.lower()]
        return reduce(lambda l1, l2: l1 + l2,
                      map(partial(get_filenames, source_format=source_format,
                                  data_mode=data_mode), entries), [])

    return []
