"""The port's ``.msgpack`` reader against ``flax.serialization``: key for
key and bit for bit on checkpoints that the JAX package's
``train/checkpoint.save_model`` writes (narrow and full width, train form
and BN-folded), on the committed narrow fixture, and on a tree of every
msgpack type the reader covers; ``Predictor.from_checkpoint`` on a
``.msgpack`` gives the same probabilities as on the ``.pt`` that
``convert/torch_export.save_torch_checkpoint`` writes from the same
variables; malformed files raise with their reason.

Run as a script from the repository root to rewrite the committed fixture
(``tests/data/narrow_model.{msgpack,pt}``, ``narrow_label_map.json``)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_msgpack.py
"""

import json
import os
import struct

import jax
import numpy as np
import pytest

from flax import serialization

from speech_intent_recognizer_tpu.convert.torch_export import (
    save_torch_checkpoint)
from speech_intent_recognizer_tpu.models.cnn_gru import (
    CNNAudioGRU as FlaxCNNAudioGRU, fold_batchnorm, init_model)
from speech_intent_recognizer_tpu.train.checkpoint import save_model

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the narrowest model the card serves: K2 takes hidden sizes in multiples of
# 32, and the JAX export writes two GRU layers
FIXTURE_WIDTHS = dict(num_classes=4, conv_channels=(4, 8, 4), gru_hidden=32)


def _variables(seed, **widths):
    raw = init_model(FlaxCNNAudioGRU(**widths), jax.random.key(seed))
    params = jax.tree.map(np.array, raw["params"])
    stats = jax.tree.map(np.array, raw["batch_stats"])
    r = np.random.default_rng(seed)
    for name in stats:
        c = stats[name]["mean"].shape[0]
        stats[name] = {"mean": (0.1 * r.standard_normal(c)).astype(np.float32),
                       "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    return params, stats


def write_checkpoints(directory, stem, seed=0, **widths):
    """``{stem}.msgpack`` (JAX ``save_model``), its ``{stem}.pt`` twin
    (``save_torch_checkpoint``) and a label map; returns their paths."""
    params, stats = _variables(seed, **widths)
    paths = [os.path.join(directory, f"{stem}.msgpack"),
             os.path.join(directory, f"{stem}.pt"),
             os.path.join(directory, f"{stem.split('_')[0]}_label_map.json")]
    save_model(paths[0], {"params": params, "batch_stats": stats})
    save_torch_checkpoint(paths[1], params, stats)
    n = widths.get("num_classes", 31)
    with open(paths[2], "w") as f:
        json.dump({f"intent_{i}": i for i in range(n)}, f)
    return paths


def _assert_same_tree(got, want, where="/"):
    assert isinstance(got, dict) and isinstance(want, dict), where
    assert sorted(got) == sorted(want), where
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, dict):
            _assert_same_tree(a, b, f"{where}{k}/")
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, where + k
            assert a.tobytes() == b.tobytes(), where + k


@pytest.mark.parametrize("widths,fold", [
    (dict(num_classes=4, conv_channels=(8, 16, 16), gru_hidden=32), False),
    (dict(num_classes=4, conv_channels=(8, 16, 16), gru_hidden=32), True),
    (dict(num_classes=31), False)])
def test_reader_matches_flax(tmp_path, widths, fold):
    from speech_intent_recognizer_tpu_torch.convert.msgpack import (
        loads, read_variables)

    params, stats = _variables(1, **widths)
    if fold:
        params, stats = fold_batchnorm(params, stats), {}
    path = str(tmp_path / "m.msgpack")
    save_model(path, {"params": params, "batch_stats": stats})
    data = open(path, "rb").read()
    want = serialization.msgpack_restore(data)
    _assert_same_tree(loads(data), want)
    got_params, got_stats = read_variables(path)
    _assert_same_tree(got_params, want["params"])
    _assert_same_tree(got_stats, want["batch_stats"])


def test_every_covered_type_matches_flax():
    from speech_intent_recognizer_tpu_torch.convert.msgpack import loads

    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                     2 ** 40, -1, -32, -33, -128, -129, -40000, -2 ** 40],
            "floats": [0.5, -2.25, 1e300], "flags": [True, False, None],
            "text": "x" * 40, "long": "y" * 70000, "blob": b"\x00\x01" * 200,
            "arrays": {"f64": np.arange(6.0).reshape(2, 3),
                       "i32": np.arange(5, dtype=np.int32),
                       "u8": np.arange(3, dtype=np.uint8),
                       "scalar": np.asarray(np.float32(3.5)),
                       "empty": np.zeros((0, 4), np.float32)},
            "many": {f"k{i}": i for i in range(20)}}
    data = serialization.msgpack_serialize(tree)
    got, want = loads(data), serialization.msgpack_restore(data)
    assert got["ints"] == want["ints"] and got["floats"] == want["floats"]
    assert got["flags"] == want["flags"] and got["many"] == want["many"]
    assert got["text"] == want["text"] and got["long"] == want["long"]
    assert got["blob"] == want["blob"]
    _assert_same_tree(got["arrays"], want["arrays"])


def test_bfloat16_leaves_widen_exactly():
    import jax.numpy as jnp

    from speech_intent_recognizer_tpu_torch.convert.msgpack import loads

    x = jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16)
    got = loads(serialization.msgpack_serialize({"w": np.asarray(x)}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def _probs(pred, seed=3):
    r = np.random.default_rng(seed)
    buf = np.zeros((3, pred._buffer_width()), np.float32)
    lengths = [30000, 9000, 80000]
    for i, n in enumerate(lengths):
        buf[i, :n] = (0.3 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000)
                      + 0.05 * r.standard_normal(n))
    return pred.predict_waveform_batch(buf, np.asarray(lengths, np.int32))


@pytest.mark.parametrize("fold_bn", [True, False])
def test_predictor_from_msgpack_equals_pt(tmp_path, fold_bn):
    """The same variables through the two files: equal state dicts, equal
    probabilities (the models are the same numbers)."""
    from speech_intent_recognizer_tpu_torch.convert.checkpoint import (
        load_model_checkpoint)
    from speech_intent_recognizer_tpu_torch.infer.predict import Predictor

    msgpack_path, pt_path, labels = write_checkpoints(
        str(tmp_path), "narrow_model", seed=2,
        num_classes=5, conv_channels=(8, 16, 16), gru_hidden=32)
    a, b = load_model_checkpoint(msgpack_path), load_model_checkpoint(pt_path)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].equal(b[k]), k
    preds = [Predictor.from_checkpoint(p, labels, device="cpu",
                                       fold_bn=fold_bn)
             for p in (msgpack_path, pt_path)]
    assert preds[0].model.conv_channels == (8, 16, 16)
    assert preds[0].model.num_classes == 5
    got, want = _probs(preds[0]), _probs(preds[1])
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got, want)


def test_committed_fixture():
    """The narrow fixture that the card's smoke test serves: its .msgpack
    reads as flax reads it, and maps to its .pt twin's state dict."""
    from speech_intent_recognizer_tpu_torch.convert.checkpoint import (
        load_model_checkpoint)
    from speech_intent_recognizer_tpu_torch.convert.msgpack import loads

    path = os.path.join(DATA, "narrow_model.msgpack")
    data = open(path, "rb").read()
    _assert_same_tree(loads(data), serialization.msgpack_restore(data))
    a = load_model_checkpoint(path)
    b = load_model_checkpoint(os.path.join(DATA, "narrow_model.pt"))
    assert sorted(a) == sorted(b)
    assert all(a[k].equal(b[k]) for k in a)
    assert tuple(a["conv1.weight"].shape) == (4, 1, 3, 3)
    with open(os.path.join(DATA, "narrow_label_map.json")) as f:
        assert len(json.load(f)) == a["fc.weight"].shape[0] == 4


def _ext(code, payload):
    return bytes([0xC7, len(payload), code & 0xFF]) + payload


@pytest.mark.parametrize("case,match", [
    ("truncated", "truncated"),
    ("ext_type", "ext type 2 is not an ndarray"),
    ("top_list", "not a map holding 'params'"),
    ("no_params", "not a map holding 'params'"),
    ("extra_key", "unexpected top-level keys"),
    ("leaf", "params/conv1 is a int, not a map"),
    ("trailing", "bytes after the first value"),
    ("bad_byte", "is not a msgpack type"),
    ("short_array", "do not fill shape"),
    ("not_a_model", "not a CNNAudioGRU checkpoint")])
def test_malformed_files_raise_with_reason(tmp_path, case, match):
    from speech_intent_recognizer_tpu_torch.convert.checkpoint import (
        load_model_checkpoint)
    from speech_intent_recognizer_tpu_torch.convert.msgpack import (
        MsgpackError)

    good = serialization.msgpack_serialize(
        {"params": {"conv1": {"kernel": np.ones((3, 3, 1, 2), np.float32)}},
         "batch_stats": {}})
    data = {
        "truncated": good[:-7],
        "ext_type": serialization.msgpack_serialize({"params": {}})[:-1]
        + b"\x81\xa1w" + _ext(2, b"\x92\x01\x02"),
        "top_list": serialization.msgpack_serialize([1, 2]),
        "no_params": serialization.msgpack_serialize({"batch_stats": {}}),
        "extra_key": serialization.msgpack_serialize(
            {"params": {}, "opt_state": {}}),
        "leaf": serialization.msgpack_serialize({"params": {"conv1": 3}}),
        "trailing": good + b"\x00",
        "bad_byte": b"\xc1",
        "short_array": b"\x81\xa6params\x81\xa1w" + _ext(1, b"\x93\x92\x02"
                                                         b"\x02\xa7float32"
                                                         b"\xc4\x04"
                                                         + struct.pack(
                                                             "<f", 1.0)),
        "not_a_model": good,
    }[case]
    path = tmp_path / "bad.msgpack"
    path.write_bytes(data)
    with pytest.raises(MsgpackError, match=match):
        load_model_checkpoint(str(path))


if __name__ == "__main__":
    for p in write_checkpoints(DATA, "narrow_model", seed=0,
                               **FIXTURE_WIDTHS):
        print(p, os.path.getsize(p))
