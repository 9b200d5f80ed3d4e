"""The port's checkpoint reader and weight carrier against the JAX package."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from cnn_autoencoder_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from cnn_autoencoder_tpu.utils.torch_import import (
    conv_weight_to_hwio, deconv_weight_to_hwio_flipped)
from cnn_autoencoder_tpu_torch.models.factory import \
    autoencoder_from_state_dict
from cnn_autoencoder_tpu_torch.training.checkpoint import (load_checkpoint,
                                                           msgpack_restore)

FIXTURES = ["benchmarks/bench_flagship.msgpack",
            "benchmarks/bench_flagship_lam002.msgpack",
            "benchmarks/bench_flagship_lam05.msgpack"]


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("path", FIXTURES)
def test_reader_matches_flax(path):
    with open(path, "rb") as f:
        data = f.read()
    ref = serialization.msgpack_restore(data)
    got = msgpack_restore(data)
    _assert_same_tree(ref, got)
    assert json.loads(got["config"]) == json.loads(ref["config"])
    # and the flat state both loaders hand to their factories
    _assert_same_tree(jax_load_checkpoint(path), load_checkpoint(path))


def test_reader_covers_msgpack_types():
    """Every msgpack type the reader claims, written by flax itself."""
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1e300, 3.25],
        "flags": [True, False, None],
        "text": "x" * 40,
        "long_text": "y" * 70000,
        "nested": {"f16": np.arange(6, dtype=np.float16).reshape(2, 3),
                   "i64": np.arange(-3, 3, dtype=np.int64),
                   "u8": np.arange(200, dtype=np.uint8),
                   "scalar": np.float32(2.5)},
        "many": {str(i): i for i in range(20)},
        "list17": list(range(17)),
        "bf16": jnp.arange(4, dtype=jnp.bfloat16) * 0.5,
    }
    data = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(data)
    got = msgpack_restore(data)
    np.testing.assert_array_equal(got["bf16"],
                                  np.asarray(ref["bf16"], np.float32))
    del ref["bf16"], got["bf16"]
    assert got["nested"]["scalar"] == ref["nested"]["scalar"]
    assert got["nested"]["scalar"].dtype == np.float32
    del ref["nested"]["scalar"], got["nested"]["scalar"]
    _assert_same_tree(ref, got)


def test_reader_rejects_truncated_data():
    with open(FIXTURES[0], "rb") as f:
        data = f.read()
    with pytest.raises(ValueError):
        msgpack_restore(data[:len(data) // 2])


@pytest.mark.parametrize("path", FIXTURES)
def test_state_from_jax_reproduces_weights(path):
    """The port's weights map back onto the JAX kernels through the JAX
    package's own torch->JAX converters, for every module."""
    state = jax_load_checkpoint(path)
    model = autoencoder_from_state_dict(path, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    seen = set()
    for module in ("encoder", "decoder"):
        for unit, layers in state[module]["params"].items():
            for layer, params in layers.items():
                for name, ref in params.items():
                    key = (f"{module}.{unit}.{layer}."
                           f"{'weight' if name == 'kernel' else name}")
                    got = sd[key]
                    if name == "kernel":
                        conv = (deconv_weight_to_hwio_flipped
                                if layer.startswith("deconv")
                                else conv_weight_to_hwio)
                        got = conv(got)
                    np.testing.assert_array_equal(got, np.asarray(ref))
                    seen.add(key)
    for name, ref in state["fact_ent"]["params"].items():
        np.testing.assert_array_equal(sd[f"fact_ent.{name}"], ref)
        seen.add(f"fact_ent.{name}")
    assert seen == set(sd)
