"""Extract training statistics to CSV, from logs or checkpoints: the port
of the JAX package's ``scripts/dump_training_stats.py``.

    python -m cnn_autoencoder_tpu_torch.tools.dump_training_stats \
        -l train.log [-k last.msgpack] -o stats.csv

Parses the dense one-line metric strings the train CLI logs
(``utils/loggers.py:log_info``, the JAX package's format) and reads the
loss histories a checkpoint stores (``training/checkpoint.py``), writing
the JAX tool's tidy CSV files.
"""

import argparse
import os
import re

import numpy as np

from ..training.checkpoint import load_checkpoint

LINE_RE = re.compile(
    r"\[(?P<step>\d+)\]\[(?P<sub>\d+)(?:/(?P<total>\d+))?\]\s+"
    r"(?P<type>\w+) Loss (?P<loss>[-\d.]+)")
FIELD_RES = {
    "D": re.compile(r" D=\[(?P<val>[^\]]+)\]"),
    "R": re.compile(r" R=(?P<val>[-\d.]+)"),
    "A": re.compile(r" A=(?P<val>[-\d.]+)"),
    "E": re.compile(r" E=(?P<val>[-\d.]+)"),
    "Ch": re.compile(r" Ch=(?P<val>\d+)"),
    "QP": re.compile(r" QP=(?P<val>[-\d.,]+)"),
}


def parse_log(log_filename):
    rows = []
    with open(log_filename) as f:
        for line in f:
            m = LINE_RE.search(line)
            if not m:
                continue
            row = {"step": int(m.group("step")),
                   "sub_step": int(m.group("sub")),
                   "step_type": m.group("type"),
                   "loss": float(m.group("loss"))}
            for name, rex in FIELD_RES.items():
                fm = rex.search(line)
                if fm:
                    val = fm.group("val")
                    if "," in val:
                        for i, v in enumerate(val.split(",")):
                            row["%s%d" % (name, i)] = float(v)
                    else:
                        row[name] = float(val)
            rows.append(row)
    return rows


def save_rows_csv(rows, out_filename):
    if not rows:
        print("No metric lines found")
        return
    keys = sorted({k for r in rows for k in r},
                  key=lambda k: (k not in ("step", "sub_step", "step_type",
                                           "loss"), k))
    with open(out_filename, "w") as f:
        f.write(",".join(keys) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")
    print("Wrote %d rows to %s" % (len(rows), out_filename))


def save_checkpoint_stats(chk_filename, out_filename):
    state = load_checkpoint(chk_filename)
    train_loss = state.get("train_loss", [])
    valid_loss = state.get("valid_loss", [])
    extra = state.get("extra_metrics", {}) or {}
    n = max(len(train_loss), len(valid_loss),
            *(len(v) for v in extra.values() if hasattr(v, "__len__")),
            0)
    cols = {"train_loss": train_loss, "valid_loss": valid_loss}
    for k, v in extra.items():
        if hasattr(v, "__len__"):
            cols[k] = list(np.asarray(v).ravel())
    with open(out_filename, "w") as f:
        f.write("checkpoint_step," + ",".join(cols) + "\n")
        for i in range(n):
            f.write(str(i) + "," + ",".join(
                str(cols[k][i]) if i < len(cols[k]) else ""
                for k in cols) + "\n")
    print("Wrote %d checkpoint rows to %s" % (n, out_filename))


def main(argv=None):
    parser = argparse.ArgumentParser("Dump training stats to CSV")
    parser.add_argument("-l", "--log", type=str, dest="log_filename",
                        default=None, help="Training .log file to parse")
    parser.add_argument("-k", "--checkpoint", type=str, dest="chk_filename",
                        default=None,
                        help="Checkpoint with stored loss histories")
    parser.add_argument("-o", "--out-file", type=str, dest="out_filename",
                        required=True)
    args = parser.parse_args(argv)

    if args.log_filename:
        save_rows_csv(parse_log(args.log_filename), args.out_filename)
    if args.chk_filename:
        base, ext = os.path.splitext(args.out_filename)
        save_checkpoint_stats(args.chk_filename, base + "_checkpoint" + ext)


if __name__ == "__main__":
    main()
