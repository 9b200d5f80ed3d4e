"""What the codec's traffic kinds share: the program's core on the trained
weights, the bank of tiles, the closed loop of client threads and the
sample of answers kept for the comparison.

The clients are threads of this one process, each sending its next request
when its last returns (a closed loop).  They live for the whole run: the
warm-up runs on the same threads as the window, so every thread's first
call, with its handles and workspaces, falls in set-up.
"""

import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

import numpy as np

from . import seeded
from .reference import cae, checkpoint, rans

HERE = os.path.dirname(os.path.abspath(__file__))


def weights_path(config) -> str:
    """The configuration's weights file, checked against its sha256."""
    path = os.path.join(HERE, config["weights"]["file"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["weights"]["sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, the configuration "
                         f"states {config['weights']['sha256']}")
    return path


def program_core(config, device):
    """The program's ``CAETurboCore`` on the configuration's weights, at
    the precision the process set before importing the program."""
    from cnn_autoencoder_tpu_torch.models.factory import \
        autoencoder_from_state_dict
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    model = autoencoder_from_state_dict(weights_path(config), device=device)
    return CAETurboCore(model, device=device)


def tile_bank(params, seed: int, device) -> np.ndarray:
    """(n, tile, tile, 3) uint8 host tiles: a ``slide_h`` x ``slide_w``
    synthetic slide drawn from ``seed`` on the device, cut row-major."""
    img = seeded.slide(params["slide_h"], params["slide_w"],
                       seeded.generator(seed, 0, device), device)
    return seeded.tiles(img, params["tile"]).cpu().numpy()


def release(state) -> None:
    """Free the program's side once the window has closed: the clients'
    threads and the core."""
    import torch
    state["loop"].close()
    state["core"] = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(config, device):
    """The reference's side of the configuration: the checkpoint as it
    reads it, its parameters on ``device`` and its frame tables."""
    tree = checkpoint.load(weights_path(config))
    p = cae.flat_params(tree, device)
    tables = rans.bake_tables(
        {k.split("/")[-1]: v.cpu().numpy() for k, v in p.items()
         if k.startswith("fact_ent/")}, int(tree.get("K", 4)))
    return tree, p, tables


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from the
    seed (thread-safe)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed % (1 << 63))
        self.items: List = []
        self.offered = 0
        self._lock = threading.Lock()

    def offer(self, item) -> None:
        with self._lock:
            self.offered += 1
            if len(self.items) < self.k:
                self.items.append(item)
            else:
                j = int(self.rng.integers(0, self.offered))
                if j < self.k:
                    self.items[j] = item


class ClosedLoop:
    """``clients`` threads, each calling ``request(batch)`` back to back
    over the bank's batches in turn."""

    def __init__(self, clients: int, n_batches: int):
        self.clients = clients
        self.n_batches = n_batches
        self.pool = ThreadPoolExecutor(max_workers=clients)

    def warm(self, request: Callable[[int], object], rounds: int = 2):
        """Every thread runs ``rounds`` requests (set-up)."""
        for r in range(rounds):
            barrier = threading.Barrier(self.clients)

            def one(i):
                barrier.wait()
                return request((i + r) % self.n_batches)

            for f in [self.pool.submit(one, i) for i in range(self.clients)]:
                f.result()

    def run(self, request: Callable[[int], object], seconds: float,
            keep: Callable[[int, object], None]) -> Dict:
        """The window: clients send until ``seconds`` have passed since the
        first request; each request started in it runs to its end.
        Returns the records (start, end, batch, ok) and the window: from
        the first request's start to the last one's end."""
        records: List = []
        errors: List[str] = []
        lock = threading.Lock()
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def client(i):
            k = 0
            while True:
                start = time.perf_counter()
                if start >= t_end:
                    return
                b = (i + k) % self.n_batches
                try:
                    out, ok = request(b), True
                except Exception as e:  # a failed request is counted
                    out, ok = None, False
                    with lock:
                        errors.append(repr(e))
                end = time.perf_counter()
                with lock:
                    records.append((start, end, b, ok))
                if ok:
                    keep(b, out)
                k += 1

        for f in [self.pool.submit(client, i) for i in range(self.clients)]:
            f.result()
        last = max(r[1] for r in records)
        return {"records": records, "errors": errors, "t0": t0,
                "window_s": last - t0}

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def ok_records(loop_out: Dict) -> List:
    return [r for r in loop_out["records"] if r[3]]


def counts(loop_out: Dict) -> Dict[str, int]:
    recs = loop_out["records"]
    return {"attempted": len(recs),
            "failed": sum(1 for r in recs if not r[3])}
