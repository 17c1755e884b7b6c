"""Each plain reference against the program's CPU path at a small size,
float32 on both sides."""

import numpy as np
import torch

from core import compare, program, traffic, weights
from core.bench import Cell
from tiny_cells import SMALL_W2V


def test_cnn_gru_reference_matches_the_program():
    from speech_intent_recognizer_tpu_torch.config import AudioConfig
    from speech_intent_recognizer_tpu_torch.models.cnn_gru import CNNAudioGRU
    from speech_intent_recognizer_tpu_torch.ops.frontend import (
        log_mel_frontend_plain, make_frontend_params)

    cell = Cell("cnn_gru.infer.b2048")
    cfg, ref = cell.config, cell.reference()
    state = weights.make_state(ref.weight_spec(cfg),
                               traffic.device_generator(5, "cpu"), "cpu")
    model = CNNAudioGRU(cfg["num_classes"])
    model.load_state_dict(state)
    model.eval()
    (wf, ln), = traffic.batch_pool(5, 1, 3, 81920, 0.8, 5.0, "cpu")
    ln[0] = 700  # a row shorter than the centre pad's reflection
    params = make_frontend_params(AudioConfig(), "cpu")
    with torch.no_grad():
        feats = log_mel_frontend_plain(wf, ln, params)
        np.testing.assert_allclose(
            ref.log_mel(wf, ln, cfg).numpy(), feats.numpy(), atol=2e-4)
        want = torch.softmax(model(feats).double(), -1).numpy()
    got = ref.probabilities(state, cfg, wf, ln, compare.CASTS["fp32"])
    assert compare.logp_gap(got, want) < 1e-5


def test_wav2vec2_reference_matches_the_program():
    cell = Cell("w2v2_base.infer.b64")
    cfg, ref = dict(cell.config, **SMALL_W2V), cell.reference()
    state = weights.make_state(ref.weight_spec(cfg),
                               traffic.device_generator(6, "cpu"), "cpu")
    pred = program.BUILD["wav2vec2"](cfg, state, "cpu")
    (wf, ln), = traffic.batch_pool(6, 1, 3, 16000, 0.3, 1.0, "cpu")
    want = pred.predict_waveform_batch(wf, ln)
    got = ref.probabilities(state, cfg, wf, ln, compare.CASTS["fp32"])
    assert compare.logp_gap(got, want) < 1e-5


def test_casts_round_as_their_formats():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0, -0.1])
    tf = compare.CASTS["tf32"](x)
    assert tf[0] == 1.0 and tf[1] == 1.0 + 2 ** -10 and tf[2] == 3.0
    assert abs(tf[3] + 0.1) < 0.1 * 2 ** -10
    f8 = compare.CASTS["fp8"](torch.tensor([448.0, 1.0, 1.06]))
    assert f8.tolist() == [448.0, 1.0, 1.0]
