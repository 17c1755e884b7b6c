"""The operation counts of ``work/`` against counts made by hand from the
published shapes, itemised."""

import pytest

from core.bench import Cell

M = 1e6


def layers(name, lengths, width):
    cell = Cell(name)
    prec = cell.config["precision"]["infer"]
    return cell.work().layers(cell.config, prec, lengths, width)


def test_cnn_gru_per_utterance():
    w = layers("cnn_gru.infer.b2048", [80000], 81920)
    conv = lambda cin, cout, m, t: 2 * 9 * cin * cout * m * t  # noqa: E731
    assert w["conv"]["flops"]["bf16"] == conv(32, 64, 32, 100) + conv(
        64, 128, 16, 50) == 2 * 117_964_800
    gru_in = 2 * 2 * 25 * 1024 * 768 + 2 * 2 * 25 * 512 * 768
    rec = 2 * 2 * 25 * 2 * 256 * 768
    assert gru_in == 117_964_800 and rec == 39_321_600
    assert w["gru"]["flops"]["bf16"] == gru_in + rec
    assert w["k1"]["flops"]["bf16"] == conv(1, 32, 64, 200) == 7_372_800
    # 157 valid frames: 2.5 n log2 n + window + |X|^2 + 2 * 1001 mel weights
    # + 64 dB each
    assert w["k1"]["flops"]["fp32"] == pytest.approx(
        157 * (25_600 + 1024 + 3 * 513 + 2 * 1001 + 64))
    total = sum(sum(v["flops"].values()) for v in w.values())
    assert total == pytest.approx(405.44 * M, rel=1e-3)
    # bytes at K1's boundary: the 81,920-sample waveform in, the pooled
    # bf16 conv1 output out
    assert w["k1"]["bytes"] == 81920 * 4 + 100 * 32 * 32 * 2


def test_wav2vec2_base_per_utterance():
    w = layers("w2v2_base.infer.b64", [80000], 80000)
    lens = [15999, 7999, 3999, 1999, 999, 499, 249]
    enc = 2 * 10 * 512 * lens[0] + sum(
        2 * k * 512 * 512 * n for k, n in zip([3, 3, 3, 3, 2, 2], lens[1:]))
    assert w["encoder"]["flops"]["fp32"] == enc
    assert enc == pytest.approx(24.535e9, rel=1e-4)
    t, h, f = 249, 768, 3072
    layer = 8 * t * h * h + 4 * t * t * h + 4 * t * h * f
    pos = 2 * h * 48 * 128 * t
    assert w["transformer"]["flops"]["fp32"] == pos + 12 * layer
    assert pos == pytest.approx(2.35e9, rel=1e-2)
    assert 12 * layer == pytest.approx(44.58e9, rel=1e-3)
    assert w["projection"]["flops"]["fp32"] == 2 * t * 512 * h
    total = sum(sum(v["flops"].values()) for v in w.values())
    assert total == pytest.approx(71.66e9, rel=1e-3)
