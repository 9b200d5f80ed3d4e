"""The comparison that decides ``correct``, driven through ``run.py`` on the
CPU at small sizes with the cells' own limits: every cell passes as the
program stands; the control (the reference in TF32 in the program's place)
fails one of its numbers; and each fault a cell can have, planted in the
program underneath the timed path, makes ``correct`` false.  The look for
a card is skipped (``run_cell(device="cpu")``), the rest of a run is the
benchmark's own."""

import os

import pytest

from portbench import faults, run

SERVING = {"tile": 64, "batch": 4, "slide_h": 128, "slide_w": 256,
           "clients": 2, "sample": 2, "chunk": 2}
TRAINING = {"patch": 64, "batch": 2, "bank_batches": 4, "slide_h": 128,
            "slide_w": 256}
CELLS = ["flagship.encode", "flagship.decode", "flagship.train",
         "residual.train"]
SEED = 2 ** 31 + 12345


def small(cell):
    return TRAINING if cell.endswith("train") else SERVING


def run_small(cell, seed=SEED):
    return run.run_cell(cell, seed, 0.5, False, device="cpu",
                        overrides=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell):
    got = run_small(cell)
    assert got["correct"], got["checks"]
    assert got["failed"] == 0 and got["attempted"] > 0
    assert list(got)[-1] == "checks"
    e2e, _ = run.cell_metrics(run.load_json(os.pardir, "BENCHMARK.json"),
                              cell)
    assert set(got["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in got["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, monkeypatch):
    import importlib
    kind = run.load_json("workloads", cell + ".json")["traffic"]
    traffic = importlib.import_module("portbench.traffic." + kind)
    check = traffic.check
    monkeypatch.setattr(traffic, "check",
                        lambda state, out: check(state, out, "tf32"))
    got = run_small(cell)
    assert not got["correct"], got["checks"]


FAULTS = [(cell, fault) for cell in CELLS
          for fault in faults.FAULTS[run.load_json(
              "workloads", cell + ".json")["traffic"]]]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_is_caught(cell, fault, monkeypatch):
    kind = run.load_json("workloads", cell + ".json")["traffic"]
    faults.plant(kind, fault, monkeypatch.setattr)
    got = run_small(cell)
    assert not got["correct"], (fault, got["checks"])
