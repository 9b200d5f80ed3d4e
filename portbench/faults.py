"""Faults a cell can have, planted in the program underneath the timed
path: the tests (``tests/test_portbench_correct.py``) see each turn
``correct`` false at small sizes, and ``calibrate.py --fault`` reads them
at a cell's own size.  ``plant(kind, fault, setattr)`` takes a
``setattr(owner, name, value)`` (pytest's ``monkeypatch.setattr``, or
``setattr`` itself in a process that runs nothing else afterwards)."""

import numpy as np

# the faults of each traffic kind
FAULTS = {"encode": ("answer_altered", "half_batch"),
          "decode": ("answer_altered", "half_batch"),
          "train": ("state_unchanged", "half_batch", "answer_altered")}


def _encode(setattr, half):
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    encode = CAETurboCore.encode_tiles

    def broken(self, tiles, *a, **k):
        if half:
            # half of the batch left out: its first half's frames twice
            h = len(tiles) // 2
            frames = encode(self, tiles[:h], *a, **k)
            return frames + frames
        frames = encode(self, tiles, *a, **k)
        raw = bytearray(frames[-1])
        raw[40] ^= 0x5A
        return frames[:-1] + [bytes(raw)]

    setattr(CAETurboCore, "encode_tiles", broken)


def _decode(setattr, half):
    from cnn_autoencoder_tpu_torch.storage.turbo_codec import CAETurboCore
    decode = CAETurboCore.decode_tiles

    def broken(self, frames, *a, **k):
        if half:
            h = len(frames) // 2
            px = decode(self, frames[:h], *a, **k)
            return np.concatenate([px, px])
        px = np.array(decode(self, frames, *a, **k))
        px[-1] = 255 - px[-1]
        return px

    setattr(CAETurboCore, "decode_tiles", broken)


def _train(setattr, fault):
    from cnn_autoencoder_tpu_torch.training import loop
    if fault == "state_unchanged":
        setattr(loop, "apply_module_updates", lambda *a, **k: None)
    elif fault == "half_batch":
        make = loop.make_train_step

        def broken(*a, **k):
            step = make(*a, **k)

            def half(x, lrs, i, noise=None, **kw):
                h = x.shape[0] // 2
                return step(x[:h], lrs, i, noise=noise[:h], **kw)
            return half

        setattr(loop, "make_train_step", broken)
    else:
        update = loop.apply_module_updates

        def altered(optimizers, grads, lrs, step):
            update(optimizers, grads, lrs, step)
            p = next(iter(optimizers["decoder"].params.values()))
            p.data.mul_(1.001)

        setattr(loop, "apply_module_updates", altered)


def plant(kind: str, fault: str, setattr) -> None:
    if fault not in FAULTS[kind]:
        raise ValueError(f"{kind} has no fault {fault!r}")
    if kind == "train":
        _train(setattr, fault)
    else:
        (_encode if kind == "encode" else _decode)(
            setattr, fault == "half_batch")
