#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA H100.

Drives the port's paths at the full width of the reference model
(3.26 M-param CNNAudioGRU, seeded random weights) through the seven
hand-written CUDA kernels, and checks everything it measures:

* serving: ``Predictor.from_checkpoint`` -> ``predict_waveform_batch``,
  batch inference from waveform to intent probabilities (K1, K5, K2:
  conv2 + conv3 in one kernel where K5's contract holds), held to the
  fp64 golden front-end and to the same predictor on the CPU;
* training from precomputed features: the precompute, train and evaluate
  CLIs on a seeded synthetic tone corpus (K3 in the precompute, K2 and its
  backward K2T in training), then the trained model served;
* serving off the reference geometry (hop 256, 400 frames): the unfused
  predictor, whose front-end frames the signal and runs K4;
* the pipeline orchestrator ``cli.run_pipeline`` with waveform-resident
  training and waveform augmentation (K3 inside every train step and eval
  batch and in the test split's precompute, K2 and K2T);
* streaming and serving: ``StreamingRecognizer`` sessions (K4 on the tail
  frames at each end of speech, and on every block of frames in the
  featurizer's ``device`` mode; the fp32 classifier with K2 twice), the
  ``BatchFinalizer`` and ``IntentServer``, on the model that training
  produced; and a ``.msgpack`` checkpoint read without flax or msgpack;
* serving artifacts of that model (``infer/export.py``): the production
  programs of the default and the unfused predictor (each kernel a ``sir``
  op node), the portable program and the streaming finalize, each loaded
  in a process of its own;
* the wav2vec family, the TTS corpus, data and tensor parallelism;
* the kernels' resources as built and their times alone, beside their
  plain versions, the library calls they replace and their bounds.

Each kernel is held against its plain version once here, at the shape
its main path gives it; the sweeps over builds, batches and lengths, and
the launches of each form of the serving path, are
``tests/test_torch_cuda.py``'s checks on the card (``python -m pytest
--noconftest tests/test_torch_cuda.py``); the end-to-end rates are the
benchmark's cells (``perfbench/``, whose signals, peaks and operation
counts this script imports).

Phases:

1. build the kernels from ``speech_intent_recognizer_tpu_torch/csrc`` and,
   alongside, ``native/build.sh`` (libsirdsp, the streaming featurizer's
   native mode) when the checkout has no build, and print what K1, K3, K4,
   K5, the tensor-core K2 and K2T and the fp32 cluster K2 and K2T take as
   built:
   registers, spilled bytes, shared memory, threads and resident blocks per
   SM, for the cluster kernels also the cluster size and resident clusters
   per card;
2. each kernel once against its plain version at the shape its main path
   gives it, at the bars of its card tests: K1 -> K5 on the B=256 batch
   with the seeded checkpoint's folded weights, K2 at B=256 (bf16, T=25)
   through the main path's entry on the GEMM's (B, T, 6H) and through the
   training path's contract entry, K2T at B=1024 (bf16, T=25), K3 on
   B=256 precompute rows, K4 on B=256 rows of hop-256 frames, K6 at
   conv2's output (B=256); K7 in phase 6;
4. serving end to end: the main path once at B=256 (K1 once, K5 once, K2
   twice, nothing else; probabilities finite, rows summing to 1), then the parity gates of the reference
   ``bench.py``: plain front-end vs the fp64 golden (< 0.05), fused
   probabilities vs golden features through the plain unfused folded
   model (< 0.02, equal argmax), and the main run's rows vs the same
   predictor on the CPU;
5. the ``test_model`` CLI on a WAV file;
6. K7 (the training conv epilogue, forward and backward) at the train
   step's three conv outputs (B = 1024): what its four kernels take on the
   card, both passes against their plain versions, and its passes timed beside the torch chain they replace and the
   plain versions;
7. off the reference geometry (hop 256 / 400 frames): the front-end
   through K4 against the fp64 golden, and the unfused predictor at B=256
   (K4 once, K2 twice, nothing else) against the CPU predictor;
9. timings with CUDA events, each next to the card's name and power limit:
   K1 and K2 (every build); K4 (also at 512 and 2048 points), K5, K6, their
   plain versions and the library calls they stand beside; K1, K2, K4, K5,
   cuDNN's GRU layer (bf16 and fp16), cuDNN's conv2 + conv3 pair and that
   pair with K6 after each conv as the median of five timed blocks with the
   least and the most;
13. one fp32 training step (two batches) on the card against the CPU;
14. timings of K3, K2T and the bf16 train step with CUDA events; cuDNN's
    bf16 GRU backward beside K2T (a one-wide input, the backward alone on
    a kept graph); the fp32 K2T at B = 16 / 64 / 256 / 1024 (its kernel
    alone and through ``gru_layer_backward``, the CUDA-core kernel the same
    two ways, cuDNN's fp32 backward with TF32 off, the plain version,
    bounds); the fp32 train step at B = 16 / 64 (host clock) with the
    cluster K2T and with the CUDA-core K2T forced, three rounds of A B B A
    (every step's two K2T launches counted by kernel);
15. training end to end through the CLIs (precompute -> train -> evaluate
    -> serve the best model), with the launch counters reset just before
    and read just after each CLI (K3 in the precompute, K2 and K2T in
    training), and the precompute rate;
16. streaming on the trained model: every WAV of the test split, followed
    by room noise, through its own ``StreamingRecognizer`` session in each
    featurizer mode (host, native, device), the counters reset before and
    read after each (K4 once at the finalize, in device mode also once per
    block of frames; K2 twice, both the fp32 cluster kernel, counted under
    its own key; nothing else), labels equal to
    ``predict_file``'s, accuracy >= 0.9, the finalize's operands on the card
    within 1e-5 of the CPU; 16 files replayed as ``cli.stream --audio`` does
    (``FileAudioSource``: digital zeros after each; ``run_live``), counters
    as above, results within 1e-5 of the same replay on the CPU; 16
    sessions ending in one tick through one ``BatchFinalizer`` flush (K4 1,
    K2 2, rows within 1e-5 of their single finalize); ``IntentServer`` on a
    Unix socket with 16 concurrent client sessions, each asking for a
    partial hypothesis mid-utterance, partials and results equal to the
    direct recognizer's; the committed narrow ``.msgpack`` fixture served
    like its ``.pt`` twin; and timings: end of speech -> result p50 / p90,
    the feed of one chunk per mode, the finalize of 1 and of 16 queued
    sessions (host clock), K4 at 4 / 16 / 64 frames (the tails of 1, 4
    and 16 sessions) and the fp32 K2 at B = 1 / 16 / 256 / 2048 beside
    the CUDA-core kernel and cuDNN's fp32 layer with TF32 off and on (CUDA
    events); then end of speech in each mode and the finalize of 1 and of
    16 again, with the fp32 cluster K2 and with the CUDA-core K2 forced, in
    turns (every run's two K2 launches counted by kernel);
17. ``cli.run_pipeline`` on the tone corpus in waveform mode with waveform
    augmentation, bf16, full width (preprocess validating every WAV, int16
    waveform caches, training with K3 in every step, evaluate), the
    counters reset just before and read just after (K3 once a train step,
    eval batch and precompute batch; K2T twice a step; K2 twice a step, an
    eval batch and an evaluate-stage batch; K7 3 times a step forward and
    3 backward; nothing else), train loss
    falling, val accuracy >= 0.9, the report's accuracy that of
    ``evaluate_dataset``; a fp32 waveform train step card vs CPU (phase
    13's bars); and the bf16 waveform step at B = 256 / 1024 (CUDA events
    and host clock, medians of five blocks) beside the feature-cache step,
    with its augmentation and its K3 timed alone;
18. serving artifacts of phase 15's model (``infer.export``): the
    production flavour of the default configuration pinned at B = 8, 256
    and 2048 and of the unfused fp32 predictor at 8, the portable flavour
    and the streaming artifact, each loaded by its own process (all at
    once) that counts what a program call launches (default K1 1, K5 1,
    K2 2; unfused K3 1, K2 2; the streaming finalize K4 1, K2 2; the
    portable nothing) and lists the port's modules it imported (none of
    models, predictor, training, data; the portable no kernel op either);
    production rows bit-equal to the live predictor on the same program
    batches at B = 8, 200 (routed to 256), 256 and 2300 (chunked); the
    portable within 1e-2 of the live bf16 path's log-probabilities with
    equal argmax on the gate rows; the streaming artifact's labels equal to
    the live recognizer's over the test split; the production and portable
    artifacts at B = 256 / 2048 beside the live ``Predictor`` (medians of
    five blocks, CUDA events and host clock, A B C C B A); the live B=256
    step and the B=1 end of speech through the ops and with each op swapped
    for its kernel's launch body (the route before the ops), in alternating
    rounds; the host cost of a wrapper's call, its op's and the kernel's
    launch body alone (K4 on 4 frames, the fp32 K2 at B=1, K1 at B=8).
19. the wav2vec family at wav2vec2-base width: card vs CPU (forward and
    one fine-tune step, fp32), bf16 vs fp32 on the card,
    ``cli.train_wav2vec --small`` -> ``test_model`` -> ``evaluate`` on the
    tone corpus, its artifacts in their own processes, and the timings of
    inference and of the fine-tune step (CUDA events and host clock)
    beside their bounds;
20. the hermetic TTS corpus and what runs on it: a.
    ``cli.generate_tts_samples --engine synthetic`` on the 38-row sheet,
    every WAV decoded by ``load_audio``; b. ``examples.make_ab_corpus
    --profile harder --variants 8`` (304 WAVs + golden features) and
    ``examples.synthetic_e2e``'s ``cli.run_pipeline`` on a 60 / 20 / 20
    split (a full-width bf16 model; K3 once a precompute batch, K2T 2 a
    step, K2 2 a step, eval batch and evaluate-stage batch, K7 3 a step
    forward and 3 backward); c.
    ``cli.test_tts_samples`` with that model over the 38 TTS WAVs on the
    card (K1 38, K5 38, K2 76, nothing else) and with ``--device cpu``: equal
    labels, confidences within phase 4's bar, the accuracy printed; d. a
    librosa-mode predictor (plain front-end: no K1, K3 or K4) on the card
    against the CPU and against the fp64 golden features; e. one
    ``Wav2VecTrainer`` epoch (small config) through ``device_prefetch``
    against synchronous copies, losses and weights bit-equal; f.
    ``utils.trace`` around one B=256 ``predict_waveform_batch`` names
    K1's and K2's kernels and the annotated region; g.
    ``utils.diagnostics``' smoke test and 2 s stress test (TFLOP/s beside
    the card's name and power limit); h. accuracy control (a)'s recipe
    (``examples.convergence_ab.train_port``: fp32, B=16) for one epoch on
    b's features, every K2T launch the fp32 cluster backward.
21. data-parallel training, evaluation and serving (``parallel/``; on
    phase 15's corpus and model): a. ``cli.train`` with the
    config's ``parallel`` section (a ``file://`` coordinator, world 1,
    NCCL) against the same run without, fp32, feature and waveform mode,
    two epochs of one step on 64 rows: launches counted (K2 2 a step and
    eval batch, K2T 2 a step, both the fp32 cluster backward, in waveform
    mode K3 1 a step and eval batch), losses at phase 13's bar, after
    each step BatchNorm's running statistics at phase 13's bar and at most
    1e-4 of the weights more than lr / 2 apart (a changed gradient sign
    under Adam); the bf16 feature
    step at B=256 and the waveform step at B=512 / 1024 with the DP
    machinery at world 1 against the one-process step (three blocks of A
    B B A, both sides' conv epilogues the torch chain, K7 counted 0), and
    the augmentation's draws at B=512 / 1024; b.
    ``parallel.dryrun.dryrun_multichip(2, "cuda")``: two processes on the
    one card over gloo, every part's line printed, each step held to the
    one-process step at B=2x64 by the dry run's bars, each process's
    launches (feature K2 2, K2T 2; waveform K3 1, K2 2, K2T 2, each K2T
    the fp32 cluster backward; its serving mesh K1 2, K5 2, K2 4); c.
    ``Predictor(mesh=)`` over [dev, dev] on 37 rows of the test split (K1
    2, K5 2, K2 4) against the meshless rows at phase 4's bar.
22. tensor parallelism (the ``model`` axis of ``parallel/``; runs after
    21): ``parallel.dryrun.dryrun_multichip(2, "cuda", model_axis=2)``
    (dp1 x tp2) and ``dryrun_multichip(4, "cuda", model_axis=2)`` (dp2 x
    tp2), the processes sharing the one card over gloo, fp32, TF32 off:
    the reference CNN-GRU's feature and waveform steps and evaluations,
    one wav2vec2-base step (seeded, 4 rows of 1 s a process) and the
    checkpoint round trip, each held to the one-process step on the
    global batch by the dry run's bars (every process's parameters equal,
    the checkpoint bit-equal); each process's launches (feature K2 2, K2T
    2; waveform K3 1, K2 2, K2T 2, each K2T the fp32 cluster backward; the
    serving mesh K1 and 2 K2 a data shard) and its bytes of split leaves
    and of their Adam moments, half the whole model's.  A correctness run
    on a shared card, not a multi-GPU rate.

The ``kernels`` line gives each kernel's largest error against its
plain version (``max_abs_err``: phase 2's, K2's through the main path's
``gru_layer_btc`` and ``contract_max_abs_err`` through the training
path's ``gru_layer``; K7's dy, phase 6's) and its launches on its path
(``launches``: K1, K2, K5 and K6 on phase 4's main path, K3 and K2T
in phase 15's training, K4 in phase 7's; K2 and K4 ``stream_launches``:
over the test split in each featurizer mode, in
the batched finalize of 16 and in the file replay of 16, and K2
``stream_launches_cluster``, how many of those were the fp32 cluster
kernel; K2, K3 and K2T ``waveform_launches``, phase 17's; every kernel
``artifact_launches``, phase 18's per program call; K2, K3 and K2T
``synthetic_launches``, phase 20b's; K1 and K2 ``tts_launches``, phase
20c's; K1, K2, K3 and K2T ``distributed_launches``, phase 21's; K1, K2,
K3 and K2T ``tensor_parallel_launches``, phase 22's, each process's; K2T
``control_a_launches``, phase 20h's, and ``fp32``: the fp32 cluster
backward's launches on phases 20h, 21 and 22, times, bounds and library
call at B = 16 / 64 / 256 / 1024 and the fp32 train step with it and with
the CUDA-core K2T), its time, the plain version's, the least time the
card could take for the same work (``bound_ms``:
``perfbench/core/peaks.least_seconds``, bytes over 3.35 TB/s or
operations over the peak of their type, 67 TFLOP/s fp32 and 989 TFLOP/s
bf16, whichever is larger; the front-end's operations
``perfbench/work/cnn_gru_fsc.frontend_flops_per_frame`` a frame) and,
where one library call computes the same function, that call's time (K3,
K4: ``torch.fft.rfft`` + matmul on the frames).

Every failed check raises.  Needs one card; exits non-zero without CUDA.
The last line of standard output is the JSON device record.

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from speech_intent_recognizer_tpu_torch.config import AudioConfig
from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.data import native
from speech_intent_recognizer_tpu_torch.data.audio_io import (
    load_audio, save_wav)
from speech_intent_recognizer_tpu_torch.data.labelmap import save_label_map
from speech_intent_recognizer_tpu_torch.examples.make_ab_corpus import (
    SENTENCES as SHEET)
from speech_intent_recognizer_tpu_torch.infer import streaming
from speech_intent_recognizer_tpu_torch.infer.mic import (
    FileAudioSource, run_live)
from speech_intent_recognizer_tpu_torch.infer.predict import (
    Predictor, Wav2VecPredictor)
from speech_intent_recognizer_tpu_torch.infer.server import (
    IntentServer, encode_chunk)
from speech_intent_recognizer_tpu_torch.infer.streaming import (
    BatchFinalizer, PendingResult, StreamingRecognizer, fused_finalize)
from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
    CONV23_BUFFERS, CNNAudioGRU, conv1_external_params, conv23_params,
    fold_batchnorm)
from speech_intent_recognizer_tpu_torch.models.wav2vec import (
    Wav2Vec2Config, Wav2VecIntent, feature_extractor_params)
from speech_intent_recognizer_tpu_torch.models.wav2vec_backbone import (
    feat_extract_output_lengths)
from speech_intent_recognizer_tpu_torch.ops import frontend_kernels as fk
from speech_intent_recognizer_tpu_torch.ops import frontend_numpy as golden
from speech_intent_recognizer_tpu_torch.ops import conv23 as conv23_ops
from speech_intent_recognizer_tpu_torch.ops.conv23 import (
    _conv23_plain, conv23, conv23_operands)
from speech_intent_recognizer_tpu_torch.ops.frontend import (
    _frames, log_mel_frontend, log_mel_frontend_plain, make_frontend_params,
    padded_samples)
from speech_intent_recognizer_tpu_torch.ops import gru as gru_ops
from speech_intent_recognizer_tpu_torch.ops.gru import (
    CLUSTER_ROWS, CLUSTER_ROWS_BACKWARD, MMA_ROWS, MMA_ROWS_BACKWARD,
    TILE_ROWS, Plan,
    _gru_layer_backward_plain, _gru_layer_btc_plain, _gru_layer_plain,
    gru_layer,
    gru_layer_backward, gru_layer_btc, k2_strides, picked_plan, tile_rows)
from speech_intent_recognizer_tpu_torch.ops import bn_pool
from speech_intent_recognizer_tpu_torch.ops import pool_epilogue as pool_ops
from speech_intent_recognizer_tpu_torch.ops.pool_epilogue import (
    _bias_relu_pool2_plain, bias_relu_pool2)
from speech_intent_recognizer_tpu_torch.train.wav2vec_trainer import (
    Wav2VecTrainer, create_wav2vec_optimizer)
from speech_intent_recognizer_tpu_torch.utils.device import (
    gpu_label, require_cuda)
from perfbench.core import peaks
from perfbench.core.traffic import room_noise, speech_like
from perfbench.work.cnn_gru_fsc import frontend_flops_per_frame

CHECK_LENGTHS = [8000, 16000, 39999, 40000, 52117, 79999, 80000, 1025, 512, 2]
GATE_LENGTHS = [8000, 16000, 39999, 40000, 52117, 79999, 80000, 1025]
K1_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/frontend_conv1.cu"
K1_REPLACES = "speech_intent_recognizer_tpu/ops/frontend_pallas.py:651"
K2_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/gru_layer.cu"
K2_REPLACES = "speech_intent_recognizer_tpu/ops/gru_pallas.py:55"
K3_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/frontend.cu"
K3_REPLACES = "speech_intent_recognizer_tpu/ops/frontend_pallas.py:458"
K2T_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/gru_layer_bwd.cu"
K2T_REPLACES = "speech_intent_recognizer_tpu/ops/gru_pallas.py:168"
K4_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/mel_db.cu"
K4_REPLACES = "speech_intent_recognizer_tpu/ops/frontend_pallas.py:44"
K5_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/conv23.cu"
K5_REPLACES = "speech_intent_recognizer_tpu/ops/conv23_pallas.py:72"
K6_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/pool_epilogue.cu"
K6_REPLACES = "speech_intent_recognizer_tpu/ops/pool_epilogue_pallas.py:66"
K7_SOURCE = "speech_intent_recognizer_tpu_torch/csrc/bn_relu_pool.cu"
# K7 replaces no Pallas kernel: the JAX package leaves its training
# epilogue (BatchNorm, ReLU, max-pool) to XLA
K7_REPLACES = None
# K7: the train step's three conv outputs (C, H, W), at the train cell's
# batch
K7_STAGES = ((32, 64, 200), (64, 32, 100), (128, 16, 50))
K7_BATCH = 1024
# fp32 operations of one frame of the log-mel front-end at the reference's
# n_fft and mels (hop 256 frames the same way): windowed real FFT, powers,
# mel sums, dB
FRONTEND_FRAME_FLOPS = frontend_flops_per_frame(
    {"n_fft": 1024, "n_mels": 64, "sample_rate": 16000})
# the off-reference geometry served through K4: hop 256, 400 frames
HOP256 = dict(hop_length=256, mel_spec_length=400)
# precompute's buffers are max_samples wide, not padded_samples
PRECOMPUTE_WIDTH = 80000
# cached features (K3, int16 fetch) vs the plain front-end: the bar JAX
# holds K3 to against XLA (tests/test_pallas_frontend.py:62)
K3_BAR = 2e-3
# the bars of tests/test_torch_cuda.py: K1's share of outputs more than one
# bf16 step from the plain version's; K4's rtol / atol; K5's of the plain's
# largest output; K2T's gradients (bf16: plus one bf16 step)
K1_FAR_SHARE = 1e-4
K4_RTOL, K4_ATOL = 1e-4, 1e-4
K5_BAR = 2e-2
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
K2T_BATCH = 1024  # the train cell's batch
# train step, card vs CPU (fp32, TF32 off): loss relative, gradients per
# tensor as above, BatchNorm running statistics absolute
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL, STEP_BN_ATOL = (
    1e-4, 1e-3, 1e-5, 1e-5)
# the synthetic tone corpus of the training phase
TONE_CLASSES = 8
CORPUS = {"train": 1024, "valid": 256, "test": 256}
TRAIN_EPOCHS = 6
TRAIN_BATCH = 64
PRECOMPUTE_BATCH = 128
VAL_ACC_BAR = 0.9
# phase 17: run_pipeline with waveform augmentation on the same corpus; the
# waveform train step timed at these batches
PIPELINE_EPOCHS = TRAIN_EPOCHS
WAVE_STEP_BATCHES = (256, 1024)
ARGMAX_SHARE_BAR = 0.99
MAIN_BATCH = 256
TIMING_BATCHES = (256, 2048)
# bench.py's gate on probabilities, and a tighter bar on log-probabilities
# (logits up to a per-row constant): the seeded model's probabilities are
# near uniform, so a probability bar alone barely sees a wrong logit
PROB_GATE = 0.02
LOGP_BAR = 1e-2
# the streaming phase: the featurizer modes, the streamed accuracy bar on the
# tone test split, the finalize on the card vs the same operands through the
# port on the CPU (probabilities; TF32 is off for matmuls and cuDNN, set in
# main(), as for check_hop256's unfused fp32 predictor; the bar of
# tests/test_torch_cuda.py's finalize test), batched rows vs their single
# finalize and the server vs the direct recognizer
STREAM_MODES = ("host", "native", "device")
STREAM_ACC_BAR = 0.9
STREAM_CPU_BAR = 1e-5
STREAM_ROW_BAR = 1e-5
STREAM_SESSIONS = 16
STREAM_CHUNK = 1024
# what follows each streamed utterance: 1.5 s of a microphone's silence,
# room noise at -60 dBFS (perfbench's ``room_noise``: Gaussian, std 0.001,
# mean |x| 0.0008, under the VAD's 0.01 threshold).  Digital zeros would
# make -100 dB frames, which the tone model never saw in training and which
# pull the per-utterance normalization far off (PERF.md §6, streaming)
TRAILING_S = 1.5
LATENCY_UTTERANCES = 30
# K4 and the fp32 K2 at the streaming path's sizes: tail frames of 1, 4 and
# 16 utterances; one session and a batched flush of 16; the fp32 K2 also at
# the evaluation's batches, beside the CUDA-core kernel and cuDNN
STREAM_K4_FRAMES = (4, 16, 64)
FP32_K2_BATCHES = (1, 16, 256, 2048)
# the fp32 K2T timed at these batches (T = 25): control (a)'s B=16, the dry
# runs' 64 a process, and two larger; the fp32 train step with either K2T
# at 16 and 64, in rounds of A B B A of this many steps a block
FP32_K2T_BATCHES = (16, 64, 256, 1024)
FP32_STEP_ITERS, FP32_STEP_ROUNDS = 10, 3
# each server session asks for a partial hypothesis after this chunk
PARTIAL_AT = 8
# phase 18: serving artifacts of phase 15's model.  The programs of each
# configuration and the rows asked of them (the default: pinned, routed to
# 256, chunked as 2048 + 252), the launches one program call makes, the
# batches timed
EXPORT_CONFIGS = {"default": (8, 256, 2048), "unfused": (8,)}
EXPORT_REQUESTS = {"default": (8, 200, 256, 2300), "unfused": (8,)}
EXPORT_LAUNCHES = {"default": {"K1": 1, "K5": 1, "K2": 2},
                   "unfused": {"K3": 1, "K2": 2}}
EXPORT_TIMED = (256, 2048)
DISPATCH_ROUNDS = 6
# phase 19: the wav2vec family at the width of facebook/wav2vec2-base
# (models/wav2vec.Wav2Vec2Config's defaults), seeded weights, 31 classes.
# Card vs CPU in fp32 (TF32 off, set in main()): one 1 s row and one of 300
# samples (feature length <= 0); forward within 1e-4 of each tensor's
# largest magnitude, one fine-tune step at phase 13's bars, the parameters
# after it within two AdamW steps (2 lr: a gradient within fp32 noise of 0
# moves its weight by +-lr on each side) with at most W2V_FAR_SHARE of them
# beyond 1e-3 lr (8.1e-4 in the first run on the H100: the share of
# gradients within fp32 noise of zero).  bf16 against fp32 on the card, logits within
# W2V_BF16_BAR of their largest magnitude (the JAX package's bf16 path is
# 0.3 % from its fp32 at the tiny config, tests/test_torch_wav2vec.py)
W2V_CLASSES = 31
W2V_SEED = 19
W2V_CPU_LENGTHS = (16000, 300)
W2V_FWD_BAR = 1e-4
W2V_LR = 1e-4
W2V_FAR_SHARE = 1e-3
W2V_BF16_BAR = 2e-2
W2V_BF16_ROWS = 8
# the timed cells: inference at B=64 x 3 s, the fine-tune step at B=8 x 5 s
# (the reference recipe) and B=16 x 3 s
W2V_INFER = (64, 48000)
W2V_STEPS = ((8, 80000), (16, 48000))
# cli.train_wav2vec --small on phase 15's corpus; the artifacts of its
# model, pinned at these batches, asked for 8 rows and 20 (routed to 32)
W2V_TRAIN_EPOCHS = 2
W2V_TRAIN_BATCH = 8
W2V_WARMUP = 8
W2V_EXPORT_SIZES = (8, 32)
W2V_EXPORT_REQUESTS = (8, 20)
ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "narrow_model")
# phase 20: the sentence sheet (38 sentences, 19 intents) of the TTS corpus
# and of the synthetic A/B corpus (make_ab_corpus --profile harder at
# SYNTH_VARIANTS variants a sentence), synthetic_e2e's epochs on it; the
# librosa front-end vs the fp64 golden at JAX's bar
# (tests/test_frontend.py:246); the files of the prefetch epoch; the
# stress test's seconds
SYNTH_VARIANTS = 8
SYNTH_CLASSES = 19
SYNTH_EPOCHS = 10
LIBROSA_RTOL, LIBROSA_ATOL = 2e-3, 3e-3
PREFETCH_FILES = 32
STRESS_S = 2.0
FIXTURE_LABELS = os.path.join(ROOT, "tests", "data", "narrow_label_map.json")


# phase 21: data-parallel training, evaluation and serving (``parallel/``).
# 21a: cli.train with and without a coordinator (world 1, NCCL, a file://
# store) on the first DP_TRAIN / DP_VAL rows of phase 15's corpus, fp32,
# DP_EPOCHS epochs of one step and one eval batch each, in feature and in
# waveform mode; after each step BatchNorm's running statistics within
# STEP_BN_ATOL and at most DP_FLIP_SHARE of the weights more than lr / 2
# apart.  Adam's first step moves a weight by lr * g / (|g| + eps): two
# runs whose gradients agree in sign agree to far below lr, and a weight
# whose gradient changed sign moves 2 lr apart.  Only a gradient within
# fp32 noise of zero changes sign between two right runs; a wrong
# gradient turns a large share.  The DP machinery's cost at world 1 on
# the bf16 steps: DP_ABBA blocks of A B B A (one process, world 1, world
# 1, one process), each window DP_TIMED's iterations, both sides' conv
# epilogues through the torch chain; 21c: the serving
# mesh [cuda:0, cuda:0] on DP_SERVE_ROWS rows
DP_TRAIN, DP_VAL, DP_EPOCHS, DP_LR = TRAIN_BATCH, 64, 2, 1e-3
DP_FLIP_SHARE = 1e-4
DP_TIMED = (("feature", 256, 20), ("waveform", 1024, 6),
            ("waveform", 512, 10))
DP_ABBA = 3
DP_SERVE_ROWS = 37

# Phase 18's loader: one process per artifact, importing only what loading
# it needs.  argv: artifact directory, kind (production, portable,
# streaming), the inputs (.npz), where to write the outputs; prints the
# launches it counted, the load time and the port's modules it imported as
# its last line.
ARTIFACT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from speech_intent_recognizer_tpu_torch.infer import export
art, kind, data, out = sys.argv[1:5]
pkg = "speech_intent_recognizer_tpu_torch"
WRAPPERS = {"K1": ("ops.frontend_kernels", "frontend_conv1"),
            "K2": ("ops.gru", "gru_layer_btc"),  # no grad: the GEMM's layout
            "K3": ("ops.frontend_kernels", "frontend"),
            "K4": ("ops.frontend_kernels", "mel_db"),
            "K5": ("ops.conv23", "conv23"),
            "K6": ("ops.pool_epilogue", "bias_relu_pool2")}


def launched(run):
    found = {k: getattr(sys.modules[pkg + "." + m], f)
             for k, (m, f) in WRAPPERS.items() if pkg + "." + m in sys.modules}
    for w in found.values():
        w.launches = 0
    torch.cuda.synchronize()
    result = run()
    torch.cuda.synchronize()
    return result, {k: w.launches for k, w in found.items() if w.launches}


t0 = time.perf_counter()
d = np.load(data)
report = {"kind": kind, "launches": {}}
if kind == "streaming":
    from speech_intent_recognizer_tpu_torch.infer.streaming import (
        StreamingRecognizer)
    sp = export.StreamingArtifactPredictor.load(art)
    report["load_s"] = time.perf_counter() - t0

    def run():
        results, start = [], 0
        for end in d["ends"]:
            rec = StreamingRecognizer(sp, featurizer_mode="host")
            for chunk in d["chunks"][start:end]:
                r = rec.feed(chunk)
                if r is not None:
                    break
            results.append(r)
            start = end
        return results

    results, report["launches"]["split"] = launched(run)
    report["labels"] = [r["predicted_label"] for r in results]
    np.savez(out, confidence=np.asarray([r["confidence"] for r in results]))
else:
    srv = export.ServingModel.load(art)
    report["load_s"] = time.perf_counter() - t0
    rows, lengths, outs = d["rows"], d["lengths"], {}
    for n in (int(x) for x in d["requests"]):
        reps = -(-n // len(rows))
        wf = np.concatenate([rows] * reps)[:n]
        ln = np.concatenate([lengths] * reps)[:n]
        outs[f"b{n}"], report["launches"][str(n)] = launched(
            lambda: srv.predict_waveform_batch(wf, ln))
    np.savez(out, **outs)
report["modules"] = sorted(
    m for m in sys.modules if m.startswith(pkg + ".")
    or m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(json.dumps(report))
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def batch(lengths, width, seed):
    buf = np.zeros((len(lengths), width), np.float32)
    for i, n in enumerate(lengths):
        buf[i, :n] = speech_like(np.random.default_rng(seed + i), n)
    return buf, np.asarray(lengths, np.int32)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_blocks(fn, iters: int, blocks: int = 5, warmup: int = 10
                   ) -> tuple:
    """(least, median, most) of ``blocks`` timed runs of ``iters`` calls
    each, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = sorted(cuda_ms(fn, iters, warmup=0) for _ in range(blocks))
    return times[0], times[len(times) // 2], times[-1]


def timed(timings: dict, spreads: dict, key: str, fn, iters: int) -> None:
    """Median of five timed blocks into ``timings[key]``, the (least,
    median, most) into ``spreads[key]``."""
    spreads[key] = cuda_ms_blocks(fn, iters)
    timings[key] = spreads[key][1]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"ok: {what}")


def check_probs(got: np.ndarray, want: np.ndarray, what: str) -> None:
    err = float(np.abs(got - want).max())
    logp_err = float(np.abs(np.log(np.maximum(got, 1e-30))
                            - np.log(np.maximum(want, 1e-30))).max())
    argmax_ok = bool((got.argmax(-1) == want.argmax(-1)).all())
    check(err < PROB_GATE and argmax_ok and logp_err <= LOGP_BAR,
          f"{what}: prob err {err:.3e} < {PROB_GATE}, argmax equal, "
          f"log-prob err {logp_err:.3e} <= {LOGP_BAR}")


def k2_inputs(b: int, dtype, dev, seed: int, steps: int = 25):
    """Seeded K2 operands: inputs N(0, 1), recurrent weights 0.05 N(0, 1),
    n-gate bias 0.1 N(0, 1)."""
    r = np.random.default_rng(seed)
    gx = torch.from_numpy(r.standard_normal((2, steps, b, 768))
                          .astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((r.standard_normal((2, 256, 768)) * 0.05)
                         .astype(np.float32)).to(dev, dtype)
    bn = torch.from_numpy((r.standard_normal((2, 1, 256)) * 0.1)
                          .astype(np.float32)).to(dev)
    return gx, w, bn


def gru_variants(dtype, backward: bool = False) -> list:
    """Every ``rows=`` argument that launches a different kernel build for
    this operand type: what the card picks (None), each tensor-core tile
    height (bf16 only), each fp32 cluster-kernel height (fp32 only, the
    backward's with ``backward``), each CUDA-core tile height."""
    heights = MMA_ROWS_BACKWARD if backward else MMA_ROWS
    mma = [Plan("mma", r) for r in heights] if dtype == torch.bfloat16 else []
    cluster = ([Plan("cluster", r) for r in (
        CLUSTER_ROWS_BACKWARD if backward else CLUSTER_ROWS)]
               if dtype == torch.float32 else [])
    return [None, *mma, *cluster, *TILE_ROWS]


def plan_name(rows, b: int, dtype, dev, backward: bool = False) -> str:
    if rows is None:
        p = picked_plan(b, 256, dtype, dev, backward)
        return f"{p.kernel} {p.rows}-row tiles (picked)"
    p = rows if isinstance(rows, Plan) else Plan("simt", rows)
    return f"{p.kernel} {p.rows}-row tiles"


def plan_key(rows) -> str:
    """The timing key of a forced build: ``mma_rows64``, ``simt_rows4``."""
    p = rows if isinstance(rows, Plan) else Plan("simt", rows)
    return f"{p.kernel}_rows{p.rows}"


def seeded_checkpoint(directory: str) -> tuple:
    """Full-width reference-layout model from torch.Generator seed 0, with
    non-trivial BatchNorm statistics so folding is exercised."""
    g = torch.Generator().manual_seed(0)
    model = CNNAudioGRU(num_classes=31)
    model.reset_parameters(g)
    with torch.no_grad():
        for i in (1, 2, 3):
            bn = getattr(model, f"bn{i}")
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.uniform_(-0.1, 0.1, generator=g)
            bn.running_mean.uniform_(-0.1, 0.1, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
    model_path = os.path.join(directory, "best_model.pt")
    torch.save(model.state_dict(), model_path)
    label_path = os.path.join(directory, "label_map.json")
    save_label_map({f"intent_{i:02d}": i for i in range(31)}, label_path)
    return model_path, label_path, model.state_dict()


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def within_scaled(got, want, rtol, atol) -> bool:
    """max|got - want| <= atol + rtol * max|want|, over the tensor: the bar
    for a gradient that sums many terms (a weight gradient over T*B or
    B*H*W positions), whose small elements are differences of large
    partial sums that another summation order moves by rtol * max|want|."""
    return max_err(got, want) <= atol + rtol * float(want.float().abs().max())


def k2t_inputs(b: int, dtype, dev, seed: int, steps: int = 25):
    gx, w, bn = k2_inputs(b, dtype, dev, seed, steps)
    r = np.random.default_rng(seed + 1)
    dys = torch.from_numpy(r.standard_normal((2, steps, b, 256))
                           .astype(np.float32)).to(dev, dtype)
    return gx, w, bn, _gru_layer_plain(gx, w, bn), dys


def check_train_step(dev, waves=None) -> None:
    """Phase 13: one training step (two batches of 16) of the full-width
    model in fp32 with dropout 0 and augmentation off, on the card and on
    the CPU from the same seeded weights and batches.  BatchNorm's running
    statistics are compared after step 1, which sets them from the same
    weights on both sides; after step 2 they are only logged: Adam's first
    update is about lr * sign(g), so a gradient within fp32 noise of zero
    can move its weight by 2 * lr on one side only.

    With ``waves`` ((32, L) int16 rows and their int32 lengths; phase 17)
    the step is the waveform-resident one: on the card ``Trainer._inputs``
    gathers the rows and featurizes them with K3, and the CPU step takes
    those features, so both steps see the same inputs.  Each side's own
    front-end is held apart on step 1: K3 vs the CPU's plain front-end on
    these rows within K3_BAR, the losses within STEP_LOSS_RTOL; the
    gradient difference with own front-ends is logged, not held: features
    ~6e-6 apart flip the max-pool / ReLU routing of near-tied values on
    stationary tones and move conv2's gradient to 1.86x its bar
    (PERF.md section 6, waveform training), a sensitivity of the model's
    gradient, not an error of a kernel."""
    import copy

    import torch.nn.functional as F

    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.train.loop import (
        Trainer, cross_entropy)
    from speech_intent_recognizer_tpu_torch.train.state import (
        create_optimizer)

    what = "train step" if waves is None else "waveform train step"
    cpu_model = CNNAudioGRU(num_classes=31, dropout=0.0)
    cpu_model.reset_parameters(torch.Generator().manual_seed(11))
    r = np.random.default_rng(12)
    feats = torch.from_numpy(r.standard_normal((32, 64, 200))
                             .astype(np.float32))
    labels = torch.from_numpy(r.integers(0, 31, 32))
    runs = {}
    init = copy.deepcopy(cpu_model)
    order = [("cpu", cpu_model), (dev, copy.deepcopy(cpu_model).to(dev))]
    if waves is not None:
        order.reverse()  # the card first: the CPU step takes its features
    card_x = []
    for d, model in order:
        opt = create_optimizer(model.parameters(), lr=1e-3,
                               weight_decay=1e-4, grad_clip=1.0)
        if waves is not None:
            trainer = Trainer(model, Config.from_dict({}), optimizer=opt,
                              from_waveforms=True)
            w16, ln = waves[0].to(d), waves[1].to(d)
        model.train()
        losses, grads, stats = [], None, []
        for step in range(2):
            rows = torch.arange(16 * step, 16 * (step + 1), device=d)
            if waves is None:
                x = feats[rows.cpu()].to(d)
            elif d == "cpu":
                x = card_x[step].cpu()
            else:
                x = trainer._inputs(w16, ln, rows)
                card_x.append(x)
            y = labels[16 * step:16 * (step + 1)].to(d)
            loss = cross_entropy(model(x), F.one_hot(y, 31).float(),
                                 torch.ones(16, device=d))
            opt.zero_grad()
            loss.backward()
            if step == 0:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()}
            stats.append({n: b.detach().cpu().clone()
                          for n, b in model.named_buffers()
                          if "running" in n})
            opt.step()
            losses.append(float(loss.detach()))
        runs[str(d)] = (losses, grads, stats)
    (l_cpu, g_cpu, s_cpu), (l_dev, g_dev, s_dev) = runs["cpu"], runs[str(dev)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    on_card_features = "" if waves is None else " (the CPU on its features)"
    check(loss_err <= STEP_LOSS_RTOL,
          f"{what} card vs CPU{on_card_features}: losses {l_dev} vs "
          f"{l_cpu}, relative "
          f"err {loss_err:.2e} <= {STEP_LOSS_RTOL}")
    worst = max(g_cpu, key=lambda n: max_err(g_dev[n], g_cpu[n])
                / (STEP_GRAD_ATOL + STEP_GRAD_RTOL
                   * float(g_cpu[n].abs().max())))
    check(all(within_scaled(g_dev[n], g_cpu[n], STEP_GRAD_RTOL,
                            STEP_GRAD_ATOL) for n in g_cpu),
          f"{what} card vs CPU: all {len(g_cpu)} step-1 gradients "
          f"within rtol {STEP_GRAD_RTOL} / atol {STEP_GRAD_ATOL} of scale "
          f"(closest to the bar: {worst}, err "
          f"{max_err(g_dev[worst], g_cpu[worst]):.2e}, scale "
          f"{float(g_cpu[worst].abs().max()):.3g})")
    bn_err = [max(max_err(s_dev[k][n], s_cpu[k][n]) for n in s_cpu[k])
              for k in range(2)]
    check(bn_err[0] <= STEP_BN_ATOL,
          f"{what} card vs CPU: BatchNorm running stats after step 1 "
          f"max |err| {bn_err[0]:.2e} <= {STEP_BN_ATOL} (after step 2: "
          f"{bn_err[1]:.2e}, not held)")
    if waves is None:
        return
    # step 1 on the CPU with its own (plain) front-end
    own = Trainer(init, Config.from_dict({}), from_waveforms=True)
    init.train()
    x_plain = own._inputs(waves[0], waves[1], torch.arange(16))
    loss = cross_entropy(init(x_plain), F.one_hot(labels[:16], 31).float(),
                         torch.ones(16))
    loss.backward()
    g_own = {n: p.grad for n, p in init.named_parameters()}
    ratio = {n: max_err(g_dev[n], g_own[n])
             / (STEP_GRAD_ATOL + STEP_GRAD_RTOL * float(g_own[n].abs().max()))
             for n in g_own}
    worst = max(ratio, key=ratio.get)
    k3_err = max_err(card_x[0].cpu(), x_plain)
    own_err = abs(l_dev[0] - float(loss)) / abs(float(loss))
    check(k3_err <= K3_BAR and own_err <= STEP_LOSS_RTOL,
          f"{what}, each side's own front-end: K3 vs plain on the step's "
          f"rows max |err| {k3_err:.2e} <= {K3_BAR}, step-1 loss relative "
          f"err {own_err:.2e} <= {STEP_LOSS_RTOL}; step-1 gradients logged, "
          f"not held: largest err / bar {ratio[worst]:.3f} ({worst})")


def tone_corpus(directory: str, seed: int = 7):
    """Seeded synthetic corpus: TONE_CLASSES classes, each a tone at its
    own frequency (random phase and level) plus noise, 1-5 s; CSV
    manifests and a label map."""
    rng = np.random.default_rng(seed)
    freqs = 250.0 * 1.5 ** np.arange(TONE_CLASSES)
    labels = [f"tone_{k}" for k in range(TONE_CLASSES)]
    csvs = {}
    for split, n in CORPUS.items():
        rows = []
        for i in range(n):
            k = i % TONE_CLASSES
            m = int(rng.integers(16000, 80001))
            t = np.arange(m) / 16000.0
            x = (rng.uniform(0.15, 0.4) * np.sin(
                2 * np.pi * freqs[k] * t + rng.uniform(0, 2 * np.pi))
                + 0.05 * rng.standard_normal(m))
            path = os.path.join(directory, split, f"{i:05d}.wav")
            save_wav(path, x.astype(np.float32), 16000)
            rows.append(f"{path},{labels[k]}\n")
        csvs[split] = os.path.join(directory, f"{split}.csv")
        with open(csvs[split], "w") as f:
            f.write("path,label\n")
            f.writelines(rows)
    label_map = os.path.join(directory, "label_map.json")
    save_label_map({name: i for i, name in enumerate(labels)}, label_map)
    return csvs, label_map


def decode_split(csv_path: str, width: int):
    """A split's WAVs as a zero-padded (N, width) buffer + lengths."""
    from speech_intent_recognizer_tpu_torch.data.audio_io import load_audio
    from speech_intent_recognizer_tpu_torch.data.manifest import (
        read_manifest)

    paths = read_manifest(csv_path).paths
    buf = np.zeros((len(paths), width), np.float32)
    lengths = np.zeros(len(paths), np.int32)
    for i, path in enumerate(paths):
        x, _ = load_audio(path, target_sample_rate=16000)
        lengths[i] = n = min(len(x), 80000)
        buf[i, :n] = x[:n]
    return buf, lengths


def train_end_to_end(tmp: str, dev) -> dict:
    """Phase 15: precompute -> train -> evaluate through the CLIs at full
    width with bf16 compute, then serve the best model.  Returns the
    launches of each path and the precompute rate."""
    from speech_intent_recognizer_tpu_torch.cli import evaluate as cli_eval
    from speech_intent_recognizer_tpu_torch.cli import (
        precompute_features as cli_pre)
    from speech_intent_recognizer_tpu_torch.cli import train as cli_train
    from speech_intent_recognizer_tpu_torch.data import cache as cache_mod

    csvs, label_map = tone_corpus(os.path.join(tmp, "corpus"))
    cache_dir = os.path.join(tmp, "cache")
    save_path = os.path.join(tmp, "checkpoints")
    cfg_path = os.path.join(tmp, "train.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"data:\n  cache_dir: {cache_dir}\n"
                f"  precompute_batch_size: {PRECOMPUTE_BATCH}\n"
                f"model:\n  num_labels: {TONE_CLASSES}\n"
                f"train:\n  epochs: {TRAIN_EPOCHS}\n"
                f"  batch_size: {TRAIN_BATCH}\n  lr: 0.001\n"
                f"  early_stop_patience: {TRAIN_EPOCHS}\n  bf16: true\n"
                f"  save_path: {save_path}\n")
    n_total = sum(CORPUS.values())

    # precompute: K3 once per batch of each split
    torch.cuda.synchronize()
    fk.frontend.launches = 0
    t0 = time.perf_counter()
    cli_pre.main(["--train_csv", csvs["train"], "--valid_csv", csvs["valid"],
                  "--test_csv", csvs["test"], "--output_dir", cache_dir,
                  "--label_map", label_map, "--config", cfg_path,
                  "--device", str(dev)])
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t0
    k3_launches = fk.frontend.launches
    want = sum(-(-n // PRECOMPUTE_BATCH) for n in CORPUS.values())
    check(k3_launches == want,
          f"precompute launched K3 {k3_launches}x (want {want} = sum of "
          f"ceil(N / {PRECOMPUTE_BATCH}) over the splits)")
    feats, _labels, _meta = cache_mod.load_cache(
        cache_mod.cache_path_for(csvs["test"], cache_dir))
    buf, ln = decode_split(csvs["test"], PRECOMPUTE_WIDTH)
    sample = slice(0, 16)
    plain = log_mel_frontend_plain(
        torch.from_numpy(buf[sample]), torch.from_numpy(ln[sample]),
        make_frontend_params()).numpy()
    feat_err = float(np.abs(feats[sample] - plain).max())
    check(feat_err <= K3_BAR + 1.5e-4,
          f"cached features (K3, int16 fetch) vs the plain front-end on the "
          f"CPU, 16 test utterances: max |err| {feat_err:.3e} <= "
          f"{K3_BAR} + 1.5e-4")

    # training: 2 K2 and 2 K2T launches per train step; K2 twice per eval
    # batch besides
    torch.cuda.synchronize()
    reset_counters()
    result = cli_train.main(["--config", cfg_path, "--train_csv",
                             csvs["train"], "--val_csv", csvs["valid"],
                             "--label_map", label_map, "--device", str(dev)])
    k2_launches, k2t_launches = counters()["K2"], gru_layer_backward.launches
    steps = result.epochs_run * -(-CORPUS["train"] // TRAIN_BATCH)
    eval_batches = result.epochs_run * -(-CORPUS["valid"] // (2 * TRAIN_BATCH))
    check(k2t_launches == 2 * steps and k2_launches == 2 * steps
          + 2 * eval_batches,
          f"training launched K2T {k2t_launches}x and K2 {k2_launches}x over "
          f"{steps} steps and {eval_batches} eval batches (2 each per step, "
          f"K2 2 per eval batch)")
    losses = [h["train_loss"] for h in result.history]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train loss finite and falling: {[round(x, 4) for x in losses]}")
    check(result.best_val_acc >= VAL_ACC_BAR,
          f"val accuracy {result.best_val_acc:.4f} >= {VAL_ACC_BAR} within "
          f"{result.epochs_run} epochs (history "
          f"{[round(h['val_acc'], 4) for h in result.history]})")

    # evaluation CLI: report written, its accuracy that of evaluate_dataset
    best = os.path.join(save_path, "best_model.pt")
    results_dir = os.path.join(tmp, "evaluation_results")
    ev = cli_eval.main(["--config", cfg_path, "--test_csv", csvs["test"],
                        "--label_map", label_map, "--model_path", best,
                        "--results_dir", results_dir, "--device", str(dev)])
    with open(os.path.join(results_dir, "classification_report.txt")) as f:
        head = f.readline().strip()
    check(head == f"Test Accuracy: {ev['accuracy']:.4f}",
          f"classification_report.txt says {head!r}; evaluate_dataset "
          f"{ev['accuracy']:.4f}")

    # the best model served (fused K1 + K5 + K2) vs its unfused eval forward
    pred = Predictor.from_checkpoint(best, label_map, device=dev)
    check(pred._conv1 is not None, "trained model served on the fused path")
    sbuf, sln = decode_split(csvs["test"], padded_samples(80000))
    probs = pred.predict_waveform_batch(sbuf, sln)
    model = CNNAudioGRU(num_classes=TONE_CLASSES,
                        compute_dtype=torch.bfloat16)
    model.load_state_dict(torch.load(best, weights_only=True))
    model.to(dev).eval()
    with torch.inference_mode():
        wf = torch.from_numpy(sbuf).to(dev)
        logits = model(fk.frontend(wf, torch.from_numpy(sln).to(dev),
                                   make_frontend_params(device=dev)))
        want = torch.log_softmax(logits.float(), -1).cpu().numpy()
    logp_err = float(np.abs(np.log(np.maximum(probs, 1e-30)) - want).max())
    share = float((probs.argmax(-1) == want.argmax(-1)).mean())
    check(logp_err <= LOGP_BAR and share >= ARGMAX_SHARE_BAR,
          f"best model served (fused K1 + K5 + K2) vs its unfused eval "
          f"forward on {len(sln)} test WAVs: log-prob err {logp_err:.3e} "
          f"<= {LOGP_BAR}, argmax equal on {share:.4f} >= {ARGMAX_SHARE_BAR}")
    return {"k3_launches": k3_launches, "k2t_launches": k2t_launches,
            "precompute_utt_s": n_total / precompute_s,
            "epochs": result.epochs_run, "val_acc": result.best_val_acc,
            "test_acc": ev["accuracy"], "best": best,
            "label_map": label_map, "test_csv": csvs["test"], "csvs": csvs}


def train_step_timer(dev, b: int, mesh=None, bf16: bool = True):
    """One bf16 (or, with ``bf16`` false, fp32) train step (forward,
    backward, Adam) of the full-width model at batch b from device-resident
    features, as a callable; with ``mesh`` (phase 21) the data-parallel
    step over it."""
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.train.loop import Trainer

    cfg = Config.from_dict({"bf16": bf16, "batch_size": b})
    model = CNNAudioGRU(num_classes=31, compute_dtype=torch.bfloat16
                        if bf16 else torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(b))
    trainer = Trainer(model.to(dev), cfg, mesh=mesh)
    feats = torch.randn((b, 64, 200), device=dev)
    labels = torch.randint(0, 31, (b,), device=dev)
    perm = torch.arange(b, device=dev)[None]
    weights = torch.ones((1, b), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return lambda: trainer.train_epoch(feats, labels, perm, weights, gen)


def wave_step_timer(dev, b: int, mesh=None):
    """One bf16 waveform-resident train step (gather int16 rows, waveform
    augmentation, K3, SpecAugment, forward, backward, Adam) of the
    full-width model at batch b, as a callable; the waves are a 220 Hz tone
    plus noise, lengths uniform in [1, 80000], zero beyond them.  With
    ``mesh`` (phase 21) the data-parallel step over it."""
    from speech_intent_recognizer_tpu_torch.config import Config
    from speech_intent_recognizer_tpu_torch.train.loop import Trainer

    cfg = Config.from_dict({"bf16": True, "batch_size": b,
                            "train_on_waveforms": True,
                            "use_waveform_augment": True})
    model = CNNAudioGRU(num_classes=31, compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(b))
    trainer = Trainer(model.to(dev), cfg, from_waveforms=True, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(b)
    t = torch.arange(PRECOMPUTE_WIDTH, device=dev) / 16000.0
    x = (0.25 * torch.sin(2 * np.pi * 220.0 * t)
         + 0.05 * torch.randn((b, PRECOMPUTE_WIDTH), device=dev,
                              generator=gen))
    lengths = torch.randint(1, PRECOMPUTE_WIDTH + 1, (b,), device=dev,
                            generator=gen, dtype=torch.int32)
    keep = torch.arange(PRECOMPUTE_WIDTH, device=dev)[None] < lengths[:, None]
    waves = torch.where(keep, torch.round(x * 32767.0), 0.0).to(torch.int16)
    labels = torch.randint(0, 31, (b,), device=dev, generator=gen)
    perm = torch.arange(b, device=dev)[None]
    weights = torch.ones((1, b), device=dev)
    return (lambda: trainer.train_epoch(waves, labels, perm, weights, gen,
                                        lengths=lengths)), trainer, waves, \
        lengths


def host_ms_blocks(fn, iters: int, blocks: int = 5, warmup: int = 3
                   ) -> tuple:
    """(least, median, most) host-clock ms per call of ``blocks`` runs of
    ``iters`` calls, each run ended by a synchronize."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    times.sort()
    return times[0], times[len(times) // 2], times[-1]


def pipeline_config(tmp: str, csvs: dict) -> tuple:
    """Phase 17's config: the tone corpus, waveform mode with waveform
    augmentation, bf16, phase 15's recipe; -> (path, output directory)."""
    out = os.path.join(tmp, "pipeline")
    path = os.path.join(tmp, "pipeline.yaml")
    with open(path, "w") as f:
        f.write(f"data:\n  train_csv: {csvs['train']}\n"
                f"  valid_csv: {csvs['valid']}\n"
                f"  test_csv: {csvs['test']}\n"
                f"  output_dir: {out}/processed\n"
                f"  label_map_path: {out}/processed/label_map.json\n"
                f"  cache_dir: {out}/cache\n"
                f"  precompute_batch_size: {PRECOMPUTE_BATCH}\n"
                f"  train_on_waveforms: true\n"
                f"  use_waveform_augment: true\n"
                f"model:\n  num_labels: {TONE_CLASSES}\n"
                f"train:\n  epochs: {PIPELINE_EPOCHS}\n"
                f"  batch_size: {TRAIN_BATCH}\n  lr: 0.001\n"
                f"  early_stop_patience: {PIPELINE_EPOCHS}\n  bf16: true\n"
                f"  save_path: {out}/ckpt\n")
    return path, out


def check_pipeline(dev, tmp: str, run: dict, timings, spreads) -> dict:
    """Phase 17: ``cli.run_pipeline`` on phase 15's tone corpus in waveform
    mode with waveform augmentation (preprocess validating every WAV ->
    int16 waveform caches + the test split's features -> training with K3
    in every step -> evaluate), the counters reset just before and read
    just after; then a fp32 waveform train step card vs CPU on the cache's
    rows, and the step's timings."""
    from speech_intent_recognizer_tpu_torch.cli import run_pipeline
    from speech_intent_recognizer_tpu_torch.config import load_config
    from speech_intent_recognizer_tpu_torch.data import cache as cache_mod
    from speech_intent_recognizer_tpu_torch.data.labelmap import (
        load_label_map)
    from speech_intent_recognizer_tpu_torch.data.manifest import (
        read_manifest)
    from speech_intent_recognizer_tpu_torch.evaluation.evaluate import (
        evaluate_dataset)
    from speech_intent_recognizer_tpu_torch.ops.augment import (
        augment_waveforms)

    cfg_path, out = pipeline_config(tmp, run["csvs"])
    stages = {}
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    ok = run_pipeline.run_pipeline(cfg_path, stage_times=stages,
                                   device=str(dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    check(ok, f"run_pipeline (waveform mode, augmentation on) finished in "
          f"{seconds:.1f} s: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in stages.items()))
    cfg = load_config(cfg_path)
    n = {split: len(read_manifest(f"{out}/processed/{split}_data.csv"))
         for split in ("train", "valid", "test")}
    check(n == CORPUS, f"preprocess validated every WAV: kept {n}")
    with open(f"{out}/ckpt/training_history.json") as f:
        history = json.load(f)
    epochs = history["epochs_run"]
    eval_bs = TRAIN_BATCH * cfg.train.eval_batch_multiplier
    steps = epochs * -(-n["train"] // TRAIN_BATCH)
    eval_batches = epochs * -(-n["valid"] // eval_bs)
    test_batches = -(-n["test"] // eval_bs)
    precompute = -(-n["test"] // PRECOMPUTE_BATCH)
    check_counts(launches, {
        "K3": steps + eval_batches + precompute, "K2T": 2 * steps,
        "K2": 2 * (steps + eval_batches + test_batches),
        "K7": 3 * steps, "K7T": 3 * steps},
        f"run_pipeline, {steps} waveform train steps, {eval_batches} eval "
        f"batches, {test_batches} evaluate-stage batches, {precompute} "
        f"precompute batches,")
    losses = [h["train_loss"] for h in history["history"]]
    accs = [h["val_acc"] for h in history["history"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"waveform training loss finite and falling: "
          f"{[round(x, 4) for x in losses]}")
    check(history["best_val_acc"] >= VAL_ACC_BAR,
          f"waveform training with augmentation: val accuracy "
          f"{history['best_val_acc']:.4f} >= {VAL_ACC_BAR} within {epochs} "
          f"epochs (history {[round(a, 4) for a in accs]})")

    # the report's accuracy is evaluate_dataset's on the same model
    label_map = load_label_map(f"{out}/processed/label_map.json")
    model = CNNAudioGRU(num_classes=TONE_CLASSES)
    model.load_state_dict(torch.load(f"{out}/ckpt/best_model.pt",
                                     weights_only=True))
    feats, labels, _ = cache_mod.load_cache(
        f"{out}/cache/test_data_features.npz")
    ev = evaluate_dataset(model.to(dev), torch.from_numpy(feats).to(dev),
                          labels, label_map, batch_size=eval_bs)
    with open(f"{out}/ckpt/evaluation_results/"
              "classification_report.txt") as f:
        head = f.readline().strip()
    check(head == f"Test Accuracy: {ev['accuracy']:.4f}",
          f"run_pipeline's report says {head!r}; evaluate_dataset "
          f"{ev['accuracy']:.4f}")

    waves, lengths, _, _ = cache_mod.load_waveform_cache(
        f"{out}/cache/train_data_waveforms.npz")
    check_train_step(dev, (torch.from_numpy(waves[:32]),
                           torch.from_numpy(lengths[:32])))

    # timings: the bf16 waveform step against the feature-cache step at the
    # same batch; its split into the augmentation and K3
    fe = make_frontend_params(device=dev)
    for b in WAVE_STEP_BATCHES:
        iters = 5 if b <= 256 else 3
        step, trainer, w, lt = wave_step_timer(dev, b)
        rows = torch.arange(b, device=dev)
        aug_gen = torch.Generator(device=dev).manual_seed(0)

        def augment_only():
            return augment_waveforms(w[rows].float() * (1.0 / 32768.0),
                                     lt[rows], aug_gen)

        xb, lb = augment_only()
        for key, fn in ((f"wave_step_bf16_b{b}", step),
                        (f"wave_step_augment_b{b}", augment_only),
                        (f"wave_step_k3_b{b}",
                         lambda: fk.frontend(xb, lb.clamp(min=1), fe)),
                        (f"feature_step_bf16_b{b}",
                         train_step_timer(dev, b))):
            timed(timings, spreads, key, fn, iters)
            if "_step_bf16" in key:
                spreads[f"{key}_host"] = host_ms_blocks(fn, iters)
                timings[f"{key}_host"] = spreads[f"{key}_host"][1]
        del step, trainer, w, lt, xb, lb
    return {"launches": launches, "seconds": seconds, "stages": stages,
            "epochs": epochs,
            "val_acc": history["best_val_acc"], "test_acc": ev["accuracy"]}


class RecordingRecognizer(StreamingRecognizer):
    """A streaming session that keeps the operands of its last finalize,
    so that they can be run again: on the CPU, or alone at B=1."""

    def finalize_operands(self) -> tuple:
        self.operands = super().finalize_operands()
        return self.operands


def stacked(operands: list) -> tuple:
    """Finalize operands of several sessions as fused_finalize's batch."""
    mel, count, tail, n_tail = zip(*operands)
    return np.stack(mel), np.asarray(count), np.stack(tail), np.asarray(n_tail)


def utterance_chunks(path: str, seed: int) -> np.ndarray:
    """A WAV as a microphone would deliver it: (n, 1024) chunks of the file
    and then TRAILING_S of room noise (seeded)."""
    x, _ = load_audio(path, target_sample_rate=16000)
    n = -(-(len(x) + int(TRAILING_S * 16000)) // STREAM_CHUNK) * STREAM_CHUNK
    x = np.concatenate([x, room_noise(np.random.default_rng(seed),
                                      n - len(x))])
    return x.reshape(-1, STREAM_CHUNK)


def stream_file(pred, path: str, mode: str, seed: int) -> dict:
    """One utterance through a fresh session, chunk by chunk
    (:func:`utterance_chunks`), until the recognizer returns its result.
    Times every feed (host clock); the one that returns the result is the
    end-of-speech latency.  In device mode also counts the featurizer's K4
    blocks (16 frames or fewer)."""
    rec = RecordingRecognizer(pred, featurizer_mode=mode)
    fz = rec._featurizer
    if fz.mode != mode:
        raise AssertionError(f"featurizer runs {fz.mode!r}, {mode!r} asked")
    blocks = [0]
    feed = fz.feed

    def counted_feed(chunk):
        before = fz._frames_done
        done = feed(chunk)
        blocks[0] += -(-(done - before) // streaming._BLOCK)
        return done

    if mode == "device":
        fz.feed = counted_feed
    out = {"feed_s": [], "rec": rec}
    for chunk in utterance_chunks(path, seed):
        recording = rec.recording
        t0 = time.perf_counter()
        result = rec.feed(chunk)
        dt = time.perf_counter() - t0
        if result is not None:
            out.update(result=result, latency_s=dt, blocks=blocks[0])
            return out
        if recording:
            out["feed_s"].append(dt)
    raise AssertionError(f"{path}: no end of speech in {mode} mode")


def percentile_ms(samples, q) -> float:
    return float(np.percentile(np.asarray(samples) * 1e3, q))


def stream_split(pred, cpu_pred, paths, labels, offline, mode) -> dict:
    """Phase 16a, one featurizer mode: every test WAV streamed through its
    own session with the counters reset before and read after (K4 once at
    the finalize, and in device mode once per featurizer block; K2 twice;
    nothing else), labels equal to predict_file's, accuracy, and the
    finalize's operands through the card and through the CPU."""
    results, operands, latency, feeds = [], [], [], []
    totals = dict.fromkeys(counters(), 0)
    for seed, path in enumerate(paths):
        torch.cuda.synchronize()
        reset_counters()
        run = stream_file(pred, path, mode, seed)
        got = counters()
        want = {**dict.fromkeys(got, 0), "K4": 1 + run["blocks"], "K2": 2}
        if got != want or cluster_launches() != 2:
            raise AssertionError(f"stream {mode} {path}: launched {got}, "
                                 f"want {want}; fp32 cluster K2 "
                                 f"{cluster_launches()}, want 2")
        for k in got:
            totals[k] += got[k]
        totals["K2_cluster"] = totals.get("K2_cluster", 0) + cluster_launches()
        results.append(run["result"])
        operands.append(run["rec"].operands)
        latency.append(run["latency_s"])
        feeds += run["feed_s"]
    blocks = " and once per featurizer block" if mode == "device" else ""
    log(f"ok: stream {mode}: each of {len(paths)} utterances launched K4 once "
        f"at the finalize{blocks} and K2 twice, both the fp32 cluster "
        f"kernel, nothing else (totals {totals})")
    streamed = [r["predicted_label"] for r in results]
    served = [o["predicted_label"] for o in offline]
    differ = [(os.path.basename(p), a, b, round(r["confidence"], 4))
              for p, a, b, r in zip(paths, streamed, served, results)
              if a != b]
    acc = float(np.mean([a == b for a, b in zip(streamed, labels)]))
    check(not differ and acc >= STREAM_ACC_BAR,
          f"stream {mode}: streamed label equals predict_file's on "
          f"{len(paths) - len(differ)} of {len(paths)} test WAVs (differ: "
          f"{differ[:8]}); streamed accuracy {acc:.4f} >= {STREAM_ACC_BAR}")
    ops = stacked(operands)
    card = fused_finalize(pred.model, pred.frontend_params, *ops).cpu().numpy()
    cpu = fused_finalize(cpu_pred.model, cpu_pred.frontend_params,
                         *ops).numpy()
    err = float(np.abs(card - cpu).max())
    conf = np.asarray([r["confidence"] for r in results])
    self_err = float(np.abs(card.max(-1) - conf).max())
    check(err <= STREAM_CPU_BAR and self_err <= STREAM_ROW_BAR
          and bool((card.argmax(-1) == cpu.argmax(-1)).all())
          and [pred.inv_label_map[int(i)] for i in card.argmax(-1)]
          == streamed,
          f"stream {mode}: the {len(paths)} finalizes' operands on the card "
          f"vs the CPU: max |prob err| {err:.3e} <= {STREAM_CPU_BAR}, argmax "
          f"equal; the streamed confidences within {self_err:.3e} <= "
          f"{STREAM_ROW_BAR} of the card's rows at B={len(paths)}")
    return {"results": results, "launches": totals, "acc": acc,
            "cpu_err": err, "latency_s": latency[:LATENCY_UTTERANCES],
            "feed_s": feeds}


def check_file_replay(pred, cpu_pred, paths, offline) -> dict:
    """Phase 16b: the path of ``cli.stream --audio`` on the card: each file
    through ``FileAudioSource`` (1.5 s of digital zeros after it) and
    ``run_live`` at the CLI's defaults (``auto`` mode), the counters reset
    before and read after each file (K4 once and K2 twice an utterance,
    nothing else), labels equal to the same replay on the CPU and
    confidences within STREAM_CPU_BAR of it.  The zeros put -100 dB rows
    into the per-utterance normalization, which the tone model never saw
    in training, so agreement with predict_file is logged, not gated;
    tests/test_torch_streaming.py holds this replay to the JAX package's."""
    worst, agree, totals = 0.0, 0, dict.fromkeys(counters(), 0)
    for path, off in zip(paths, offline):
        torch.cuda.synchronize()
        reset_counters()
        card = run_live(StreamingRecognizer(pred), FileAudioSource(path))
        got = counters()
        want = {**dict.fromkeys(got, 0), "K4": len(card), "K2": 2 * len(card)}
        if not card or got != want or cluster_launches() != 2 * len(card):
            raise AssertionError(f"replay {path}: {len(card)} results, "
                                 f"launched {got}, want {want}; fp32 "
                                 f"cluster K2 {cluster_launches()}")
        for k in got:
            totals[k] += got[k]
        totals["K2_cluster"] = totals.get("K2_cluster", 0) + cluster_launches()
        cpu = run_live(StreamingRecognizer(cpu_pred), FileAudioSource(path))
        if [r["predicted_label"] for r in card] != [
                r["predicted_label"] for r in cpu]:
            raise AssertionError(f"replay {path}: card {card} vs CPU {cpu}")
        worst = max([worst] + [abs(a["confidence"] - b["confidence"])
                               for a, b in zip(card, cpu)])
        agree += card[0]["predicted_label"] == off["predicted_label"]
    check(worst <= STREAM_CPU_BAR,
          f"file replay (FileAudioSource + run_live, auto mode) of "
          f"{len(paths)} WAVs: K4 once and K2 twice an utterance, both the "
          f"fp32 cluster kernel (totals {totals}), labels equal to the "
          f"CPU's, confidences within "
          f"{worst:.3e} <= {STREAM_CPU_BAR}")
    log(f"file replay: the first label equals predict_file's on {agree} of "
        f"{len(paths)} WAVs (digital silence; logged, not gated)")
    return {"launches": totals, "cpu_err": worst, "agree": agree}


def check_batched_flush(pred, paths) -> dict:
    """Phase 16c: STREAM_SESSIONS sessions, each fed its utterance (whole
    chunks), then room noise in turns, so that all reach end of speech in
    the same round: one flush (K4 once, K2 twice in all) and every row within
    STREAM_ROW_BAR of its own single finalize.  Then the batched finalize
    of 16 and the single one timed (host clock, to the result dicts)."""
    batcher = BatchFinalizer(pred, max_batch=STREAM_SESSIONS)
    recs = [RecordingRecognizer(pred, featurizer_mode="host",
                                async_results=True, batch_finalizer=batcher)
            for _ in paths]
    for rec, path in zip(recs, paths):
        x, _ = load_audio(path, target_sample_rate=16000)
        for i in range(0, len(x) - STREAM_CHUNK + 1, STREAM_CHUNK):
            if rec.feed(x[i:i + STREAM_CHUNK]) is not None:
                raise AssertionError(f"{path}: ended inside its speech")
    rng = np.random.default_rng(len(paths))
    torch.cuda.synchronize()
    reset_counters()
    pending, ended = [None] * len(recs), [None] * len(recs)
    for tick in range(64):
        for i, rec in enumerate(recs):
            if pending[i] is None:
                pending[i] = rec.feed(room_noise(rng, STREAM_CHUNK))
                ended[i] = tick if pending[i] is not None else None
        if all(p is not None for p in pending):
            break
    else:
        raise AssertionError("sessions did not reach end of speech")
    left = batcher.flush()
    results = PendingResult.get_all(pending)
    got = counters()
    check(len(set(ended)) == 1 and left == 0,
          f"{len(recs)} sessions reached end of speech in one round "
          f"({ended[0]}) and were dispatched by max_batch, none left queued")
    check_counts(got, {"K4": 1, "K2": 2},
                 f"the batched finalize of {len(recs)} sessions")
    check(cluster_launches() == 2, f"the batched finalize of {len(recs)} "
          f"sessions: both K2 launches the fp32 cluster kernel")
    got["K2_cluster"] = cluster_launches()
    worst = 0.0
    for rec, r in zip(recs, results):
        single = fused_finalize(pred.model, pred.frontend_params,
                                *stacked([rec.operands]))[0].cpu().numpy()
        label = pred.inv_label_map[int(single.argmax())]
        if r["predicted_label"] != label:
            raise AssertionError(f"batched row {r['predicted_label']} vs "
                                 f"single {label}")
        for p in r["top_predictions"]:
            worst = max(worst, abs(p["probability"]
                                   - float(single[pred.label_map[p["label"]]])))
    check(worst <= STREAM_ROW_BAR,
          f"batched rows vs their single finalize: labels equal, top-3 "
          f"probabilities within {worst:.3e} <= {STREAM_ROW_BAR}")

    timer = BatchFinalizer(pred, max_batch=4 * STREAM_SESSIONS)
    inv = pred.inv_label_map
    times = {}
    for n in (1, len(recs)):
        samples = []
        for _ in range(22):
            queued = [timer.submit(*rec.operands, inv) for rec in recs[:n]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.flush()
            PendingResult.get_all(queued)
            samples.append(time.perf_counter() - t0)
        times[n] = samples[2:]
    return {"launches": got, "row_err": worst, "times_s": times,
            "operands": [rec.operands for rec in recs]}


async def serve_sessions(pred, paths, sock: str) -> list:
    """Phase 16d: IntentServer on a Unix socket and one client connection
    per file, all concurrent in this loop; each streams the chunks of
    :func:`utterance_chunks` (the seeds of :func:`stream_split`), asks for
    a partial hypothesis after chunk PARTIAL_AT, and reads events until its
    result."""
    server = IntentServer(pred)
    srv = await server.start(socket_path=sock)

    async def client(i, path):
        reader, writer = await asyncio.open_unix_connection(sock)
        try:
            for k, chunk in enumerate(utterance_chunks(path, i)):
                writer.write((json.dumps({
                    "op": "chunk", "session": f"s{i}",
                    "pcm": encode_chunk(chunk)}) + "\n").encode())
                if k == PARTIAL_AT:
                    writer.write((json.dumps({"op": "partial",
                                              "session": f"s{i}"})
                                  + "\n").encode())
                await writer.drain()
            events = []
            while not events or events[-1].get("event") == "partial":
                events.append(json.loads(
                    await asyncio.wait_for(reader.readline(), 120)))
            return events
        finally:
            writer.close()
            await writer.wait_closed()

    try:
        return await asyncio.gather(*(client(i, p)
                                      for i, p in enumerate(paths)))
    finally:
        srv.close()
        await srv.wait_closed()


def check_fixture(dev) -> None:
    """Phase 16e: the committed narrow .msgpack (written by flax) and its
    .pt twin served on the card: the same probabilities, K3 once and K2
    twice each; the .msgpack on the CPU within STREAM_CPU_BAR; and no flax
    or msgpack module loaded to read it."""
    buf, ln = batch(GATE_LENGTHS, padded_samples(80000), seed=5)
    probs = {}
    for ext in (".msgpack", ".pt"):
        pred = Predictor.from_checkpoint(FIXTURE + ext, FIXTURE_LABELS,
                                         device=dev)
        torch.cuda.synchronize()
        reset_counters()
        probs[ext] = pred.predict_waveform_batch(buf, ln)
        check_counts(counters(), {"K3": 1, "K2": 2},
                     f"the narrow {ext} fixture served")
    cpu = Predictor.from_checkpoint(FIXTURE + ".msgpack", FIXTURE_LABELS,
                                    device="cpu").predict_waveform_batch(
        buf, ln)
    err = float(np.abs(probs[".msgpack"] - cpu).max())
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("flax", "msgpack", "jax"))
    check(np.array_equal(probs[".msgpack"], probs[".pt"])
          and probs[".pt"].shape == (len(GATE_LENGTHS), 4)
          and err <= STREAM_CPU_BAR and not loaded,
          f"the .msgpack fixture served on the card: the same probabilities "
          f"as its .pt twin, within {err:.3e} <= {STREAM_CPU_BAR} of the "
          f"CPU; flax / msgpack / jax modules loaded: {loaded}")


def time_streaming_kernels(dev, timings, bounds, spreads) -> None:
    """Phase 16f: K4 at the finalize's frame counts (one session's tail, 4
    and 16 sessions', full-scale noise) and the fp32 K2 at the streaming
    batches (T = 25), timed as medians of five blocks with the plain
    versions.  These sizes leave most of the card idle: the times are
    launch-bound, far above the bounds."""
    fe = make_frontend_params(device=dev)
    dft = fk.dft_matrices(fe)
    for n in STREAM_K4_FRAMES:
        frames = torch.randn((n, fe.n_fft), device=dev)
        timed(timings, spreads, f"k4_stream_n{n}",
              lambda: fk.mel_db(frames, fe), 200)
        timings[f"k4_stream_plain_n{n}"] = cuda_ms(
            lambda: fk._mel_db_plain(frames, fe, dft), 50)
        bounds[f"k4_stream_n{n}"] = least_ms(
            {"fp32": n * FRONTEND_FRAME_FLOPS}, nbytes(frames) + n * 64 * 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in FP32_K2_BATCHES:
        gx, w, bn = k2_inputs(b, torch.float32, dev, seed=b)
        old = Plan("simt", tile_rows(b, sms))
        want = _gru_layer_plain(gx, w, bn)
        iters = 100 if b <= 16 else 20 if b <= 256 else 5
        timed(timings, spreads, f"k2_fp32_b{b}", lambda: gru_layer(gx, w, bn),
              iters)
        timed(timings, spreads, f"k2_fp32_simt_b{b}",
              lambda: gru_layer(gx, w, bn, rows=old), iters)
        # the kernels alone: their C entry points, without the wrapper's
        # host work (at B=1 the wrapper's call takes longer than the kernel)
        lib, ys = _build.load(), torch.empty_like(want)
        stream = torch.cuda.current_stream(dev).cuda_stream
        picked = picked_plan(b, 256, torch.float32, dev)
        for key, fn, rows in (
                ("k2_fp32_kernel", lib.sir_gru_layer_cluster
                 if picked.kernel == "cluster" else lib.sir_gru_layer_f32,
                 picked.rows),
                ("k2_fp32_simt_kernel", lib.sir_gru_layer_f32, old.rows)):
            timed(timings, spreads, f"{key}_b{b}",
                  lambda: _build.check(fn(
                      gx.data_ptr(), w.data_ptr(), bn.data_ptr(),
                      ys.data_ptr(), 25, b, 256, rows, *k2_strides(gx, ys),
                      stream), key), iters)
        timings[f"k2_fp32_plain_b{b}"] = cuda_ms(
            lambda: _gru_layer_plain(gx, w, bn), 10 if b <= 256 else 2)
        bounds[f"k2_fp32_b{b}"] = least_ms(
            {"fp32": 2.0 * gx.numel() * 256},
            nbytes(gx, w, bn) + gx.numel() // 3 * 4)
        # the yardstick: one cuDNN fp32 layer (input product included), as
        # phase 9's bf16 one, with TF32 off (the fp32-equal number) and on;
        # and with a one-wide input, so that its time is the recurrence's
        for tf32, key, width in ((False, "cudnn_gru_layer_fp32", 1024),
                                 (True, "cudnn_gru_layer_tf32", 1024),
                                 (False, "cudnn_gru_layer_fp32_narrow", 1)):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                cudnn = torch.nn.GRU(width, 256, num_layers=1,
                                     batch_first=True, bidirectional=True,
                                     device=dev).eval()
                cudnn.flatten_parameters()
                x = torch.randn((b, 25, width), device=dev)
                with torch.inference_mode():
                    timed(timings, spreads, f"{key}_b{b}", lambda: cudnn(x),
                          iters)
            finally:
                torch.backends.cudnn.allow_tf32 = False
        del gx, w, bn, want, ys


def compare_fp32_plans(pred, paths, operands) -> dict:
    """Phase 16g: the streaming path with the fp32 cluster K2 (what the
    plan picks) and with the CUDA-core K2 it replaced forced
    (:func:`fp32_plan`), in turns in one run: end of speech -> result at
    B=1 in each featurizer mode over the first LATENCY_UTTERANCES test WAVs
    (which kernel goes first alternates utterance by utterance), and the
    finalize of 1 and of 16 queued sessions (rounds of A B B A, host clock,
    flush to result dicts; the first two rounds warm up).  Every run
    launches K2 twice, both the kernel asked for."""

    def counted(kernel, what):
        launched = counters()["K2"]
        got = sum(e.kernel_launches[kernel] for e in (gru_layer,
                                                      gru_layer_btc))
        if launched != 2 or got != 2:
            raise AssertionError(f"{what} with the {kernel} K2: launched "
                                 f"{launched} K2, {got} of them "
                                 f"{kernel}, want 2 and 2")

    eos = {}
    for mode in STREAM_MODES:
        eos[mode] = {"cluster": [], "simt": []}
        for i, path in enumerate(paths[:LATENCY_UTTERANCES]):
            for kernel in (("cluster", "simt") if i % 2 == 0
                           else ("simt", "cluster")):
                torch.cuda.synchronize()
                reset_counters()
                with fp32_plan(kernel):
                    run = stream_file(pred, path, mode, i)
                counted(kernel, f"stream {mode} {path}")
                eos[mode][kernel].append(run["latency_s"])
    timer = BatchFinalizer(pred, max_batch=4 * STREAM_SESSIONS)
    inv = pred.inv_label_map
    finalize = {}
    for n in (1, len(operands)):
        finalize[n] = {"cluster": [], "simt": []}
        for rnd in range(22):
            order = ("cluster", "simt") if rnd % 2 == 0 else ("simt", "cluster")
            for kernel in order + order[::-1]:
                with fp32_plan(kernel):
                    queued = [timer.submit(*ops, inv) for ops in operands[:n]]
                    torch.cuda.synchronize()
                    reset_counters()
                    t0 = time.perf_counter()
                    timer.flush()
                    PendingResult.get_all(queued)
                    dt = time.perf_counter() - t0
                counted(kernel, f"the finalize of {n}")
                if rnd >= 2:
                    finalize[n][kernel].append(dt)
    return {"eos": eos, "finalize": finalize}


def check_streaming(dev, tmp: str, run: dict, timings, bounds,
                    spreads) -> dict:
    """Phase 16: the streaming and serving path at full width on the model
    that phase 15 trained, over the tone corpus's test split."""
    from speech_intent_recognizer_tpu_torch.data.manifest import (
        read_manifest)

    manifest = read_manifest(run["test_csv"])
    paths, labels = manifest.paths, manifest.labels
    pred = Predictor.from_checkpoint(run["best"], run["label_map"],
                                     device=dev)
    cpu_pred = Predictor.from_checkpoint(run["best"], run["label_map"],
                                         device="cpu")
    offline = [pred.predict_file(p) for p in paths]
    out = {"modes": {}}
    for mode in STREAM_MODES:
        out["modes"][mode] = stream_split(pred, cpu_pred, paths, labels,
                                          offline, mode)
    sessions = paths[:STREAM_SESSIONS]
    out["replay"] = check_file_replay(pred, cpu_pred, sessions, offline)
    out["batched"] = check_batched_flush(pred, sessions)

    direct = out["modes"]["native"]["results"][:STREAM_SESSIONS]
    partial = []
    for i, path in enumerate(sessions):
        rec = StreamingRecognizer(pred)
        for chunk in utterance_chunks(path, i)[:PARTIAL_AT + 1]:
            rec.feed(chunk)
        partial.append(rec.partial_result())
    got = asyncio.run(serve_sessions(pred, sessions,
                                     os.path.join(tmp, "sir.sock")))
    check(all(p is not None for p in partial)
          and all([e["event"] for e in g] == ["partial", "result"]
                  and {e["session"] for e in g} == {f"s{i}"}
                  for i, g in enumerate(got)),
          f"IntentServer, {len(got)} concurrent client sessions on a Unix "
          f"socket: each got its partial hypothesis and then its result")
    worst = max(abs(e["confidence"] - d["confidence"])
                for g, p, r in zip(got, partial, direct)
                for e, d in zip(g, (p, r)))
    check(all(e["predicted_label"] == d["predicted_label"]
              for g, p, r in zip(got, partial, direct)
              for e, d in zip(g, (p, r)))
          and worst <= STREAM_ROW_BAR,
          f"IntentServer: partials and results equal to the direct "
          f"recognizer's labels, confidences within {worst:.3e} <= "
          f"{STREAM_ROW_BAR}")
    check_fixture(dev)
    time_streaming_kernels(dev, timings, bounds, spreads)
    out["plans"] = compare_fp32_plans(pred, paths, out["batched"]["operands"])
    return out


def least_ms(flops: dict, n_bytes: float) -> tuple:
    """(bound_ms, bound_by): the least time of ``flops`` (operations by
    operand type) and ``n_bytes`` on the card (``peaks.least_seconds``),
    and which of the two sets it."""
    by = ("bytes" if n_bytes / peaks.HBM_BYTES_PER_S
          >= peaks.compute_seconds(flops) else "operations")
    return peaks.least_seconds(flops, n_bytes) * 1e3, by


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k5_inputs(dev, b: int, seed: int, t1: int = 100):
    """Seeded bf16 sheet like K1's output (non-negative) and the operands
    of seeded folded conv2 / conv3 stages at torch's default init scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, t1, 1024), generator=g).mul_(2.0).to(
        dev, torch.bfloat16)
    w2 = (torch.rand((64, 32, 3, 3), generator=g) * 2 - 1) / 288 ** 0.5
    w3 = (torch.rand((128, 64, 3, 3), generator=g) * 2 - 1) / 576 ** 0.5
    b2 = (torch.rand(64, generator=g) * 2 - 1) * 0.1
    b3 = (torch.rand(128, generator=g) * 2 - 1) * 0.1
    return x, tuple(o.to(dev) for o in conv23_operands(w2, b2, w3, b3))


def torch_chain(y, weight, bias):
    """The epilogue K7 replaces: ``BatchNorm2d`` in training mode (an fp32
    channels-last copy, ``var_mean``, ``native_batch_norm``), ReLU, the
    cast to bf16, 2x2 max-pool; -> (module, forward callable)."""
    import torch.nn.functional as F

    from speech_intent_recognizer_tpu_torch.models.cnn_gru import BatchNorm2d

    bn = BatchNorm2d(y.shape[1]).to(y.device).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    return bn, lambda t: F.max_pool2d(F.relu(bn(t)).to(t.dtype), 2)


def check_k7(y, weight, bias, dout, fwd, what: str) -> float:
    """K7's forward ``fwd`` (``_launch_forward``'s) and its backward,
    launched on it, against their plain versions at its card tests' bars:
    on K7's statistics the plain apply
    pass's bits; the mean within 1e-6 of the channel's deviation, the
    variance within 1e-6 relative; dy within one bf16 step of the plain
    backward on K7's statistics plus twice what the sums' order carries
    into it; the weight and bias gradients within 1e-5 of their largest.
    -> dy's max |err|."""
    out, yarg, mean, var, invstd = fwd
    dy, dw, db = bn_pool._launch_backward(y, yarg, dout, weight, bias, mean,
                                          invstd)
    p_mean, p_var, _ = bn_pool._stats_plain(y, 1e-5)
    k_out, k_yarg = bn_pool._apply_plain(y, weight, bias, mean, invstd)
    p_dy, p_dw, p_db = bn_pool._backward_plain(y, yarg, dout, weight, bias,
                                               mean, invstd)
    col, n = bn_pool._col, y.numel() // y.shape[1]
    carried = 2.0 * col((weight * invstd).abs()) * (
        col((db - p_db).abs()) + (y.float() - col(mean)).abs()
        * col(invstd * (dw - p_dw).abs())) / n
    step = torch.ldexp(torch.ones_like(p_dy, dtype=torch.float32),
                       torch.frexp(p_dy.float().abs())[1] - 8)
    got = {"mean": float(((mean - p_mean).abs() / p_var.sqrt()).max()),
           "var": float(((var - p_var).abs() / p_var).max()),
           "dy_bar": float(((dy.float() - p_dy.float()).abs()
                            / (step + carried)).max()),
           "dw": float((dw - p_dw).abs().max() / p_dw.abs().max()),
           "db": float((db - p_db).abs().max() / p_db.abs().max())}
    bits = torch.equal(out, k_out) and torch.equal(yarg, k_yarg)
    check(bits and got["dy_bar"] <= 1.0 and max(
        got["mean"], got["var"]) <= 1e-6 and max(got["dw"], got["db"]) <= 1e-5,
        f"K7 vs plain, {what}: the plain apply's bits {bits}, readings "
        f"{got} (bars: mean / var 1e-6, dy_bar 1, dw / db 1e-5)")
    return max_err(dy, p_dy)


def time_k7(dev) -> dict:
    """Phase 6: K7 (the training conv epilogue) at the train step's three
    conv outputs: what its four kernels take on the card, and at B = 1024
    the forward and backward timed beside the torch chain they replace
    (library_ms) and the plain versions, on a bf16 channels-last conv
    output N(0.3, 2), a BatchNorm weight U(0.5, 1.5) and bias U(-0.5,
    0.5)."""
    out = {"resources": {}, "timings": {}, "bounds": {}, "errs": {}}
    iters, b = 10, K7_BATCH
    for c, h, w in K7_STAGES:
        out["resources"][f"c{c}"] = bn_pool.kernel_resources(dev, c)
        g = torch.Generator(device=dev).manual_seed(80 + c)
        y = (2.0 * torch.randn((b, h, w, c), generator=g, device=dev)
             + 0.3).to(torch.bfloat16).permute(0, 3, 1, 2)
        weight = 0.5 + torch.rand(c, generator=g, device=dev)
        bias = torch.rand(c, generator=g, device=dev) - 0.5
        dout = torch.randn((b, h // 2, w // 2, c), generator=g,
                           device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
        n = b * c * h * w
        fwd = bn_pool._launch_forward(y, weight, bias, 1e-5)
        out["errs"][f"c{c}"] = check_k7(y, weight, bias, dout, fwd,
                                        f"B={b} (C, H, W)={(c, h, w)}")
        key = f"k7_c{c}_b{b}"
        timed(out["timings"], {}, f"{key}_forward",
              lambda: bn_pool._launch_forward(y, weight, bias, 1e-5), iters)
        timed(out["timings"], {}, f"{key}_backward",
              lambda: bn_pool._launch_backward(y, fwd[1], dout, weight, bias,
                                               fwd[2], fwd[4]), iters)
        # forward: y twice, the pooled output and the argmax values;
        # backward: dout and the argmax values, then y and dout, dy
        out["bounds"][f"{key}_forward"] = least_ms({}, n * (2 + 2 + 0.5
                                                           + 0.5))
        out["bounds"][f"{key}_backward"] = least_ms({}, n * (0.5 + 0.5 + 2
                                                            + 0.5 + 2))
        out["timings"][f"{key}_forward_plain"] = cuda_ms(
            lambda: bn_pool._forward_plain(y, weight, bias, 1e-5), 3)
        out["timings"][f"{key}_backward_plain"] = cuda_ms(
            lambda: bn_pool._backward_plain(y, fwd[1], dout, weight, bias,
                                            fwd[2], fwd[4]), 3)
        _bn, chain = torch_chain(y, weight, bias)
        yt = y.detach().requires_grad_()
        timed(out["timings"], {}, f"{key}_forward_library",
              lambda: chain(yt), iters)
        pooled = chain(yt)
        timed(out["timings"], {}, f"{key}_backward_library",
              lambda: torch.autograd.grad(pooled, yt, dout,
                                          retain_graph=True), iters)
        del pooled
        t = out["timings"]
        log(f"  K7 at B={b} (C, H, W)={(c, h, w)}: forward "
            f"{t[f'{key}_forward']:.4f} ms (bound "
            f"{out['bounds'][f'{key}_forward'][0]:.4f}, the torch chain "
            f"{t[f'{key}_forward_library']:.4f}, plain "
            f"{t[f'{key}_forward_plain']:.4f}), backward "
            f"{t[f'{key}_backward']:.4f} ms (bound "
            f"{out['bounds'][f'{key}_backward'][0]:.4f}, the torch chain "
            f"{t[f'{key}_backward_library']:.4f}, plain "
            f"{t[f'{key}_backward_plain']:.4f})")
        del y, dout, fwd, yt
    # the plain versions leave gigabytes in torch's cache: hand them back,
    # so that the later phases run with the memory they had before
    torch.cuda.empty_cache()
    log(f"  K7 resources: {out['resources']}")
    return out


def reset_counters() -> None:
    for fn in (fk.frontend_conv1, fk.frontend, fk.mel_db, gru_layer,
               gru_layer_btc, gru_layer_backward, conv23, bias_relu_pool2,
               bn_pool.bn_relu_pool2_train):
        fn.launches = 0
    bn_pool.bn_relu_pool2_train.backward_launches = 0
    for fn in (gru_layer, gru_layer_btc, gru_layer_backward):
        fn.kernel_launches.update(dict.fromkeys(fn.kernel_launches, 0))


def cudnn_backward(dev, b: int, dtype):
    """cuDNN's GRU layer backward (bidirectional, H = 256, T = 25) at batch
    b in ``dtype`` with a one-wide input, so that its work is the
    recurrence's adjoint and the weight gradients; the forward runs once
    and its graph is kept, the callable runs the backward alone."""
    cudnn = torch.nn.GRU(1, 256, num_layers=1, batch_first=True,
                         bidirectional=True, device=dev, dtype=dtype)
    cudnn.flatten_parameters()
    x = torch.randn((b, 25, 1), device=dev, dtype=dtype, requires_grad=True)
    out = cudnn(x)[0]
    grad = torch.randn_like(out)
    leaves = [x, *cudnn.parameters()]
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def time_fp32_k2t(dev, timings, bounds, spreads) -> None:
    """Phase 14b: the fp32 K2T at the fp32 training batches (T = 25): the
    build the card picks and the CUDA-core kernel it replaced, each alone
    (the C entry point) and through ``gru_layer_backward``; cuDNN's fp32
    backward (TF32 off); the plain version; the bounds, the kernel's with
    its two products, the wrapper's with the dW product as well."""
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in FP32_K2T_BATCHES:
        gx, w, bn, ys, dys = k2t_inputs(b, torch.float32, dev, seed=b)
        picked = picked_plan(b, 256, torch.float32, dev, True)
        old = Plan("simt", tile_rows(b, sms))
        log(f"fp32 K2T at B={b} launches "
            f"{plan_name(None, b, torch.float32, dev, True)} ({sms} SMs)")
        iters = 20 if b <= 64 else 10 if b <= 256 else 5
        timed(timings, spreads, f"k2t_fp32_b{b}",
              lambda: gru_layer_backward(gx, w, bn, ys, dys), iters)
        timed(timings, spreads, f"k2t_fp32_simt_b{b}",
              lambda: gru_layer_backward(gx, w, bn, ys, dys, rows=old),
              iters)
        wt = w.transpose(1, 2).contiguous()
        dgx, dgh = torch.empty_like(gx), torch.empty_like(gx)
        timed(timings, spreads, f"k2t_fp32_kernel_b{b}",
              lambda: _build.check(lib.sir_gru_layer_bwd_cluster(
                  gx.data_ptr(), w.data_ptr(), bn.data_ptr(), ys.data_ptr(),
                  dys.data_ptr(), dgx.data_ptr(), dgh.data_ptr(), 25, b, 256,
                  picked.rows, stream), "fp32 K2T"), iters)
        timed(timings, spreads, f"k2t_fp32_simt_kernel_b{b}",
              lambda: _build.check(lib.sir_gru_layer_bwd_f32(
                  gx.data_ptr(), w.data_ptr(), wt.data_ptr(), bn.data_ptr(),
                  ys.data_ptr(), dys.data_ptr(), dgx.data_ptr(),
                  dgh.data_ptr(), 25, b, 256, old.rows, stream),
                  "fp32 K2T"), iters)
        timed(timings, spreads, f"cudnn_gru_backward_fp32_b{b}",
              cudnn_backward(dev, b, torch.float32), iters)
        timings[f"k2t_fp32_plain_b{b}"] = cuda_ms(
            lambda: _gru_layer_backward_plain(gx, w, bn, ys, dys), 3)
        product = 2.0 * gx.numel() * 256
        bounds[f"k2t_fp32_kernel_b{b}"] = least_ms(
            {"fp32": 2 * product}, nbytes(gx, gx, gx, w, bn, ys, dys))
        bounds[f"k2t_fp32_b{b}"] = least_ms(
            {"fp32": 3 * product},
            nbytes(gx, gx, w, bn, ys, dys) + w.numel() * 4)
        del gx, w, bn, ys, dys, wt, dgx, dgh


def compare_fp32_k2t_steps(dev) -> dict:
    """Phase 14c: the fp32 train step at B = 16 and 64 (host clock, ms a
    step over blocks of FP32_STEP_ITERS) with the cluster K2T (what the
    plan picks) and the CUDA-core K2T forced, FP32_STEP_ROUNDS rounds of A
    B B A after a warm-up of each; every block's K2T launches counted by
    kernel (2 a step, all of the kernel asked for)."""
    out = {}
    for b in (16, 64):
        step = train_step_timer(dev, b, bf16=False)
        times = {"cluster": [], "simt": []}

        def block(kernel, record=True):
            with fp32_plan(kernel, backward=True):
                torch.cuda.synchronize()
                reset_counters()
                t0 = time.perf_counter()
                for _ in range(FP32_STEP_ITERS):
                    step()
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3 / FP32_STEP_ITERS
            got = counters()
            want = 2 * FP32_STEP_ITERS if kernel == "cluster" else 0
            if got["K2T"] != 2 * FP32_STEP_ITERS or got["K2T_cluster"] != want:
                raise AssertionError(f"fp32 step B={b} with the {kernel} "
                                     f"K2T launched {got}")
            if record:
                times[kernel].append(dt)

        block("cluster", False)
        block("simt", False)
        for _ in range(FP32_STEP_ROUNDS):
            for kernel in ("cluster", "simt", "simt", "cluster"):
                block(kernel)
        out[b] = times
        log(f"  fp32 train step B={b}, host clock, ms a step over "
            f"{FP32_STEP_ITERS} steps, {FP32_STEP_ROUNDS} rounds of A B B A: "
            f"cluster K2T {[round(t, 4) for t in times['cluster']]}, "
            f"CUDA-core K2T {[round(t, 4) for t in times['simt']]}")
        del step
    return out


def cluster_launches() -> int:
    """K2 launches of the fp32 cluster kernel since the last reset, through
    either entry."""
    return (gru_layer.kernel_launches["cluster"]
            + gru_layer_btc.kernel_launches["cluster"])


@contextlib.contextmanager
def fp32_plan(kernel: str, backward: bool = False):
    """Inside, the fp32 forward (with ``backward``, the fp32 backward) at
    H = 256 launches ``kernel``: "cluster" (what the plan picks on an H100)
    or "simt" (the CUDA-core kernel at ``tile_rows``' height, the kernel it
    replaced), so that a path can be timed with each in one run."""
    picked = gru_ops.picked_plan

    def forced(batch, hidden, dtype, device, is_backward=False):
        plan = picked(batch, hidden, dtype, device, is_backward)
        if (kernel == "simt" and plan.kernel == "cluster"
                and is_backward == backward):
            return Plan("simt", tile_rows(batch, torch.cuda.get_device_properties(
                device).multi_processor_count))
        return plan

    gru_ops.picked_plan = forced
    try:
        yield
    finally:
        gru_ops.picked_plan = picked


def counters() -> dict:
    # K2 through either entry: the contract's under autograd, the GEMM's
    # layout elsewhere
    return {"K1": fk.frontend_conv1.launches,
            "K2": gru_layer.launches + gru_layer_btc.launches,
            "K3": fk.frontend.launches, "K2T": gru_layer_backward.launches,
            "K4": fk.mel_db.launches, "K5": conv23.launches,
            "K6": bias_relu_pool2.launches,
            "K7": bn_pool.bn_relu_pool2_train.launches,
            "K7T": bn_pool.bn_relu_pool2_train.backward_launches,
            # of K2T's, the launches of the fp32 cluster backward
            "K2T_cluster": gru_layer_backward.kernel_launches["cluster"]}


def check_counts(got: dict, want: dict, what: str) -> None:
    want = {**{k: 0 for k in got}, **want}
    check(got == want, f"{what} launched {got} (want {want})")


def check_kernels(dev, fe, main_buf, main_ln, folded, rng) -> dict:
    """Phase 2: each kernel once against its plain version at the shape its
    main path gives it, at its card tests' bar.  -> max |err| by kernel."""
    err = {}

    def held(key, got, want, ok, what):
        err[key] = max_err(got, want)
        check(got.shape == want.shape and bool(torch.isfinite(
            got.float()).all()) and ok, f"{key} vs plain, {what}: max |err| "
              f"{err[key]:.3e} (scale {float(want.float().abs().max()):.3g})")

    wf, lt = torch.from_numpy(main_buf).to(dev), torch.from_numpy(main_ln).to(dev)
    state, w1, b1 = conv23_params(folded)
    w1, b1 = w1.to(dev, torch.bfloat16), b1.to(dev, torch.bfloat16)
    x = fk.frontend_conv1(wf, lt, fe, w1, b1)
    want = fk._frontend_conv1_plain(wf, lt, fe, w1, b1).float()
    gap = (x.float() - want).abs()
    far = float((gap > 2.0 ** -7 * want.abs().clamp(min=1.0)).float().mean())
    held("K1", x, want, float(gap.max()) <= 0.05 * float(want.abs().max())
         and far < K1_FAR_SHARE, f"B={len(main_ln)}, checkpoint's conv1 "
         f"(share beyond one bf16 step {far:.2e} < {K1_FAR_SHARE})")
    ops = tuple(state[k].to(dev) for k in CONV23_BUFFERS)
    want = _conv23_plain(x, *ops)
    got = conv23(x, *ops)
    held("K5", got, want, max_err(got, want) <= K5_BAR * float(
        want.float().abs().max()), f"on K1's output, checkpoint's conv2 / conv3")
    # K2 as the main path runs it: the GEMM's (B, T, 6H), direction 1 in
    # reversed time, written to (B, T, 2H); then the training path's
    # contract entry on the same values
    gx, w, bn = k2_inputs(MAIN_BATCH, torch.bfloat16, dev, seed=MAIN_BATCH)
    gx6 = torch.cat([gx[0], gx[1].flip(0)], -1).transpose(0, 1).contiguous()
    got, want = gru_layer_btc(gx6, w, bn), _gru_layer_btc_plain(gx6, w, bn)
    held("K2", got, want, max_err(got, want) <= 1e-2,
         f"B={MAIN_BATCH} bf16, gru_layer_btc (B, T, 6H) -> (B, T, 2H)")
    got, want = gru_layer(gx, w, bn), _gru_layer_plain(gx, w, bn)
    held("K2 contract", got, want, max_err(got, want) <= 1e-2,
         f"B={MAIN_BATCH} bf16, gru_layer (2, T, B, 3H) -> (2, T, B, H)")
    del gx6
    gx, w, bn, ys, dys = k2t_inputs(K2T_BATCH, torch.bfloat16, dev,
                                    seed=K2T_BATCH)
    got = gru_layer_backward(gx, w, bn, ys, dys)
    for name, g, p in zip(("dgx", "dW", "db_hn"), got,
                          _gru_layer_backward_plain(gx, w, bn, ys, dys)):
        g, p = g.float(), p.float()
        bar = GRAD_ATOL + GRAD_RTOL * float(p.abs().max())
        held(f"K2T {name}", g, p, bool(((g - p).abs() <= bar + (
            2.0 ** -7 * p.abs() if name != "db_hn" else 0.0)).all()),
            f"B={K2T_BATCH} bf16")
    del gx, w, bn, ys, dys, got
    buf, ln = batch(list(rng.integers(1, PRECOMPUTE_WIDTH + 1, MAIN_BATCH)),
                    PRECOMPUTE_WIDTH, seed=300)
    wf, lt = torch.from_numpy(buf).to(dev), torch.from_numpy(ln).to(dev)
    got, want = fk.frontend(wf, lt, fe), log_mel_frontend_plain(wf, lt, fe)
    held("K3", got, want, max_err(got, want) <= K3_BAR,
         f"B={MAIN_BATCH} precompute rows, f32")
    fe_hop = make_frontend_params(AudioConfig(**HOP256), dev)
    frames = torch.from_numpy(rng.standard_normal((MAIN_BATCH * 313, 1024))
                              .astype(np.float32)).to(dev)
    got, want = fk.mel_db(frames, fe_hop), fk._mel_db_plain(frames, fe_hop)
    held("K4", got, want, bool(((got - want).abs() <= K4_ATOL + K4_RTOL
                                * want.abs()).all()),
         f"B={MAIN_BATCH} x 313 hop-256 frames")
    y = torch.from_numpy(rng.standard_normal((MAIN_BATCH, 100, 32, 64)).astype(
        np.float32)).to(dev, torch.bfloat16).permute(0, 3, 1, 2)
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(dev)
    got, want = bias_relu_pool2(y, bias), _bias_relu_pool2_plain(y, bias)
    held("K6", got, want, max_err(got, want) <= 2.0 ** -8 * float(
        want.float().abs().max()), f"B={MAIN_BATCH} conv2's output, bf16")
    torch.cuda.empty_cache()
    return err


def check_hop256(dev, model_path, label_path, rng) -> dict:
    """Phase 7: off the reference geometry (hop 256, 400 frames) the
    front-end runs K4.  ``log_mel_frontend`` on the card against the fp64
    golden, then the predictor at B=256."""
    cfg = AudioConfig(**HOP256)
    fe = make_frontend_params(cfg, dev)
    width = padded_samples(cfg.max_samples, cfg.hop_length)
    buf, ln = batch(GATE_LENGTHS, width, seed=1)
    got = log_mel_frontend(torch.from_numpy(buf).to(dev),
                           torch.from_numpy(ln).to(dev), fe)
    gold = np.stack([golden.pad_or_trim_np(golden.log_mel_spectrogram_np(
        buf[i, :n], hop_length=256), 400).astype(np.float32)
        for i, n in enumerate(GATE_LENGTHS)])
    gerr = float(np.abs(got.cpu().numpy() - gold).max())
    check(gerr < 0.05, f"front-end through K4 vs the fp64 golden, hop 256: "
          f"feature err {gerr:.3e} < 0.05")

    pred = Predictor.from_checkpoint(model_path, label_path, audio_cfg=cfg,
                                     device=dev)
    check(pred._conv1 is None, "hop 256 is served by the unfused predictor")
    lengths = list(rng.integers(1, cfg.max_samples + 1, MAIN_BATCH))
    buf, ln = batch(lengths, width, seed=600)
    wf = torch.from_numpy(buf).to(dev)
    torch.cuda.synchronize()
    reset_counters()
    probs = pred.predict_waveform_batch(wf, ln)
    launches = counters()
    check_counts(launches, {"K4": 1, "K2": 2},
                 f"predictor at hop 256, B={MAIN_BATCH}")
    cpu_pred = Predictor.from_checkpoint(model_path, label_path,
                                         audio_cfg=cfg, device="cpu")
    check_probs(probs[:8], cpu_pred.predict_waveform_batch(buf[:8], ln[:8]),
                "predictor at hop 256 vs the CPU predictor, 8 rows")
    return launches


def time_new_kernels(dev, variant, timings, bounds, spreads) -> None:
    """Phase 9: K4, K5, K6 at B=256 and B=2048 beside their plain
    versions and the library calls: for K5 the model's own two conv stages
    on the same input (cuDNN with torch's epilogue passes) and the
    configuration K5 has to beat (raw cuDNN convs, each followed by K6),
    K5 and both of those as medians of five timed blocks; for K6
    bias-add + ReLU + max-pool on the same raw conv output, for K4
    torch.fft.rfft + matmul on the same frames.  K4 also at 512 and 2048
    points, on as many bytes of frames."""
    import torch.nn.functional as F

    fe = make_frontend_params(AudioConfig(**HOP256), dev)
    dft = fk.dft_matrices(fe)
    for b in TIMING_BATCHES:
        iters = 20 if b <= 256 else 5
        n = b * 313  # valid hop-256 frames of 5 s utterances
        frames = torch.randn((n, fe.n_fft), device=dev)
        timed(timings, spreads, f"k4_b{b}", lambda: fk.mel_db(frames, fe),
              iters)
        timings[f"k4_plain_b{b}"] = cuda_ms(
            lambda: fk._mel_db_plain(frames, fe, dft), iters)

        def rfft_matmul():
            spec = torch.fft.rfft(frames * fe.window, dim=-1)
            power = spec.real.square() + spec.imag.square()
            return 10.0 * torch.log10((power @ fe.mel_fb).clamp(min=1e-10))

        timings[f"k4_library_b{b}"] = cuda_ms(rfft_matmul, iters)
        out = fk.mel_db(frames, fe)
        bounds[f"k4_b{b}"] = least_ms({"fp32": n * FRONTEND_FRAME_FLOPS},
                                      nbytes(frames, out))
        del frames, out
        for n_fft in (512, 2048):
            fe_n = make_frontend_params(AudioConfig(
                n_fft=n_fft, hop_length=n_fft // 4), dev)
            frames = torch.randn((n * 1024 // n_fft, n_fft), device=dev)
            timed(timings, spreads, f"k4_nfft{n_fft}_b{b}",
                  lambda: fk.mel_db(frames, fe_n), iters)
            del frames

        x, ops = k5_inputs(dev, b, seed=70)
        timed(timings, spreads, f"k5_b{b}", lambda: conv23(x, *ops),
              2 * iters)
        timings[f"k5_plain_b{b}"] = cuda_ms(
            lambda: _conv23_plain(x, *ops), iters)
        x4 = x.view(b, 100, 32, 32).permute(0, 3, 1, 2)

        def conv_pair():
            return variant._conv(3, variant._conv(2, x4))

        def conv_pair_k6():
            y = x4
            for i in (2, 3):
                conv = getattr(variant, f"conv{i}")
                y = bias_relu_pool2(F.conv2d(
                    y, conv.weight.to(torch.bfloat16), None, padding=1),
                    conv.bias)
            return y

        with torch.inference_mode():
            timed(timings, spreads, f"k5_library_b{b}", conv_pair, 2 * iters)
            timed(timings, spreads, f"k5_cudnn_k6_b{b}", conv_pair_k6,
                  2 * iters)
        flops = b * 2.0 * (100 * 32 * 64 * 288 + 50 * 16 * 128 * 576)
        bounds[f"k5_b{b}"] = least_ms({"bf16": flops},
                                      nbytes(x, *ops) + b * 25 * 1024 * 2)

        # K6 at conv2's raw output (the larger of its two launches), then
        # both launches of a batch together
        with torch.inference_mode():
            raws = []
            y = x4
            for i in (2, 3):
                conv = getattr(variant, f"conv{i}")
                raw = F.conv2d(y, conv.weight.to(torch.bfloat16), None,
                               padding=1)
                raws.append((raw, conv.bias))
                y = bias_relu_pool2(raw, conv.bias)
            raw2, bias2 = raws[0]
            timings[f"k6_b{b}"] = cuda_ms(
                lambda: bias_relu_pool2(raw2, bias2), iters)
            timings[f"k6_plain_b{b}"] = cuda_ms(
                lambda: _bias_relu_pool2_plain(raw2, bias2), iters)
            bt = bias2.to(torch.bfloat16)[None, :, None, None]
            timings[f"k6_library_b{b}"] = cuda_ms(
                lambda: F.max_pool2d(F.relu(raw2 + bt), 2), iters)
            timings[f"k6_both_stages_b{b}"] = cuda_ms(
                lambda: [bias_relu_pool2(r, bb) for r, bb in raws], iters)
            timings[f"k6_library_both_stages_b{b}"] = cuda_ms(
                lambda: [F.max_pool2d(F.relu(
                    r + bb.to(torch.bfloat16)[None, :, None, None]), 2)
                    for r, bb in raws], iters)
        bounds[f"k6_b{b}"] = least_ms({"fp32": raw2.numel() * 3.0},
                                      raw2.numel() * 2 * 1.25 + 128)
        del x, x4, raws, raw2, y


def served_as_chunks(pred, rows, lengths, n: int, sizes) -> tuple:
    """The live predictor on the batches a production ``ServingModel``
    runs for ``n`` rows (``rows`` repeated): chunks of at most the largest
    program, each filled with rows of length 1 to the smallest program
    that holds it.  -> (those probabilities, the unchunked call's)."""
    reps = -(-n // len(rows))
    wf = np.concatenate([rows] * reps)[:n]
    ln = np.concatenate([lengths] * reps)[:n]
    outs = []
    for s in range(0, n, sizes[-1]):
        cw, cl = wf[s:s + sizes[-1]], ln[s:s + sizes[-1]]
        m = len(cw)
        bs = next(z for z in sizes if z >= m)
        cw = np.concatenate([cw, np.zeros((bs - m, cw.shape[1]), np.float32)])
        cl = np.concatenate([cl, np.ones(bs - m, np.int32)])
        outs.append(pred.predict_waveform_batch(cw, cl)[:m])
    return np.concatenate(outs), pred.predict_waveform_batch(wf, ln)


def run_children(jobs: dict) -> dict:
    """Phase 18's loaders, all started together: name -> (artifact, kind,
    inputs, outputs).  -> name -> (report, outputs)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", ARTIFACT_CHILD, *job], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, job in jobs.items()}
    found = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0,
              f"artifact loader {name} exit {proc.returncode}: "
              f"{(out + err).strip()[-2000:]}")
        found[name] = (json.loads(out.strip().splitlines()[-1]),
                       np.load(jobs[name][3]))
    return found


def dispatch_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` enqueued back to back (the
    card keeps up: no call waits for the device)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def check_export(dev, tmp: str, run: dict, label: str) -> dict:
    """Phase 18: serving artifacts of the model phase 15 trained.  Exports
    the production flavour of the default and the unfused predictor, the
    portable flavour and the streaming artifact; loads each in its own process
    (which prints what it launched and imported); holds the results to the
    live path; times the artifacts beside the live ``Predictor`` and the
    kernels' op dispatch.  -> the launches each artifact made."""
    from speech_intent_recognizer_tpu_torch.data.manifest import (
        read_manifest)
    from speech_intent_recognizer_tpu_torch.infer.export import (
        ServingModel, export_predictor, export_streaming)

    best, labels = run["best"], run["label_map"]
    preds = {"default": Predictor.from_checkpoint(best, labels, device=dev),
             "unfused": Predictor.from_checkpoint(best, labels, device=dev,
                                                  fold_bn=False)}
    base = os.path.join(tmp, "artifacts")
    dirs, export_s = {}, {}
    for name, sizes in EXPORT_CONFIGS.items():
        dirs[name] = os.path.join(base, name)
        t0 = time.perf_counter()
        export_predictor(preds[name], dirs[name], flavor="production",
                         batch_sizes=sizes)
        export_s[name] = time.perf_counter() - t0
    for name, export in (("portable", export_predictor),
                         ("streaming", export_streaming)):
        dirs[name] = os.path.join(base, name)
        t0 = time.perf_counter()
        export(preds["default"], dirs[name])
        export_s[name] = time.perf_counter() - t0
    log(f"exported in s: " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in export_s.items()))

    # inputs: the test split's rows; the gate rows for the portable; each
    # test WAV as microphone chunks for the streaming artifact
    rows, lengths = decode_split(run["test_csv"], padded_samples(80000))
    gate_rows, gate_ln = batch(GATE_LENGTHS, rows.shape[1], seed=1)
    paths = read_manifest(run["test_csv"]).paths
    chunks = [utterance_chunks(p, seed) for seed, p in enumerate(paths)]
    jobs = {}
    for name in list(EXPORT_CONFIGS) + ["portable", "streaming"]:
        data = os.path.join(base, f"{name}_in.npz")
        if name == "streaming":
            np.savez(data, chunks=np.concatenate(chunks),
                     ends=np.cumsum([len(c) for c in chunks]))
        elif name == "portable":
            np.savez(data, rows=gate_rows, lengths=gate_ln,
                     requests=np.asarray([len(gate_ln)]))
        else:
            np.savez(data, rows=rows, lengths=lengths,
                     requests=np.asarray(EXPORT_REQUESTS[name]))
        kind = name if name in ("portable", "streaming") else "production"
        jobs[name] = (dirs[name], kind, data,
                      os.path.join(base, f"{name}_out.npz"))
    t0 = time.perf_counter()
    found = run_children(jobs)
    log(f"{len(jobs)} artifact loaders, one process each, all at once: "
        f"{time.perf_counter() - t0:.1f} s; load s " + ", ".join(
            f"{k} {r['load_s']:.1f}" for k, (r, _) in found.items()))

    pkg = "speech_intent_recognizer_tpu_torch."
    for name, (report, _) in found.items():
        barred = ("models", "infer.predict", "train", "jax", "flax") + (
            () if name == "streaming" else ("data",)) + (
            ("ops",) if name == "portable" else ())
        bad = [m for m in report["modules"] if m.removeprefix(pkg).startswith(
            barred)]
        check(not bad, f"artifact loader {name} imported none of "
              f"{barred} (found {bad})")

    artifact_launches = {}
    for name, sizes in EXPORT_CONFIGS.items():
        report, got = found[name]
        for n in EXPORT_REQUESTS[name]:
            calls = -(-n // sizes[-1])
            want = {k: v * calls for k, v in EXPORT_LAUNCHES[name].items()}
            check(report["launches"][str(n)] == want,
                  f"{name} artifact, {n} rows ({calls} program call(s)): "
                  f"launched {report['launches'][str(n)]} (want {want})")
            chunked, whole = served_as_chunks(preds[name], rows, lengths, n,
                                              sizes)
            same = np.array_equal(got[f"b{n}"], chunked)
            diff = float(np.abs(got[f"b{n}"] - whole).max())
            check(same, f"{name} artifact, {n} rows: bit-equal to the live "
                  f"predictor on the same program batches (vs one live "
                  f"call of all {n} rows: max |prob diff| {diff:.3e})")
        artifact_launches[name] = report["launches"][
            str(EXPORT_REQUESTS[name][0])]

    report, got = found["portable"]
    check(report["launches"] == {str(len(gate_ln)): {}},
          f"portable artifact launched {report['launches']} (want no "
          f"kernel)")
    artifact_launches["portable"] = {}
    live = preds["default"].predict_waveform_batch(gate_rows, gate_ln)
    portable = got[f"b{len(gate_ln)}"]
    logp_err = float(np.abs(np.log(np.maximum(portable, 1e-30))
                            - np.log(np.maximum(live, 1e-30))).max())
    check(logp_err <= LOGP_BAR
          and bool((portable.argmax(-1) == live.argmax(-1)).all()),
          f"portable artifact (fp32, plain front-end) vs the live bf16 path "
          f"on the {len(gate_ln)} gate rows: log-prob err {logp_err:.3e} <= "
          f"{LOGP_BAR}, argmax equal")

    report, got = found["streaming"]
    want_labels, want_conf = [], []
    for c in chunks:
        rec = StreamingRecognizer(preds["default"], featurizer_mode="host")
        for chunk in c:
            r = rec.feed(chunk)
            if r is not None:
                break
        want_labels.append(r["predicted_label"])
        want_conf.append(r["confidence"])
    n_utt = len(chunks)
    check(report["launches"]["split"] == {"K4": n_utt, "K2": 2 * n_utt},
          f"streaming artifact over {n_utt} utterances launched "
          f"{report['launches']['split']} (want K4 {n_utt}, K2 {2 * n_utt}: "
          f"once and twice a finalize)")
    conf_err = float(np.abs(got["confidence"] - np.asarray(want_conf)).max())
    check(report["labels"] == want_labels and conf_err <= STREAM_ROW_BAR,
          f"streaming artifact: labels equal to the live recognizer's on "
          f"{n_utt} test WAVs, confidences within {conf_err:.3e} <= "
          f"{STREAM_ROW_BAR}")
    artifact_launches["streaming"] = {
        k: v // n_utt for k, v in report["launches"]["split"].items()}

    # timings: the artifacts beside the live predictor, device-resident
    # input, in turns
    calls = {"production": ServingModel.load(dirs["default"], device=dev),
             "portable": ServingModel.load(dirs["portable"], device=dev)}
    served_ms = {}
    for b in EXPORT_TIMED:
        reps = -(-b // len(rows))
        wf = torch.from_numpy(np.concatenate([rows] * reps)[:b]).to(dev)
        ln = torch.from_numpy(np.concatenate([lengths] * reps)[:b]).to(dev)
        fns = {"live": lambda: preds["default"].predict_waveform_batch(wf, ln),
               **{k: (lambda srv=srv: srv.predict_waveform_batch(wf, ln))
                  for k, srv in calls.items()}}
        for name in list(fns) + list(fns)[::-1]:
            iters = 3 if name == "portable" else 10
            served_ms.setdefault(f"{name}_b{b}", []).append(
                (cuda_ms_blocks(fns[name], iters, warmup=2),
                 host_ms_blocks(fns[name], iters, warmup=1)))
    log(f"served on {label}, device-resident input, ms per call (CUDA "
        f"events / host clock, least / median / most of five blocks), live "
        f"Predictor and artifacts in the order A B C C B A:")
    for k, passes in served_ms.items():
        log(f"    {k}: " + "; ".join(
            " / ".join(f"{lo:.4f} {med:.4f} {hi:.4f}" for lo, med, hi in p)
            for p in passes))

    # the op dispatch: a wrapper's call, the op's, and the kernel's launch
    # body alone, on the two host-bound paths' kernels
    fe = make_frontend_params(device=dev)
    frames = torch.randn((4, 1024), device=dev)
    gx, w, bn = k2_inputs(1, torch.float32, dev, seed=5)
    wf8 = torch.from_numpy(rows[:8]).to(dev)
    ln8 = torch.from_numpy(lengths[:8]).to(dev)
    c1w = preds["default"]._conv1.conv1_weight
    c1b = preds["default"]._conv1.conv1_bias
    routes = {
        "K4_4_frames": (lambda: fk.mel_db(frames, fe),
                        lambda: torch.ops.sir.mel_db(frames, *fe),
                        lambda: fk._mel_db_cuda(frames, *fe)),
        "K2_fp32_b1": (lambda: gru_layer(gx, w, bn),
                       lambda: torch.ops.sir.gru_layer(gx, w, bn, "", 0),
                       lambda: gru_ops._gru_layer_cuda(gx, w, bn, "", 0)),
        "K1_b8": (lambda: fk.frontend_conv1(wf8, ln8, fe, c1w, c1b),
                  lambda: torch.ops.sir.frontend_conv1(wf8, ln8, c1w, c1b,
                                                      *fe),
                  lambda: fk._frontend_conv1_cuda(wf8, ln8, c1w, c1b, *fe))}
    dispatch = {}
    for name, fns in routes.items():
        for route, fn in zip(("wrapper", "op", "launch_body"), fns):
            dispatch.setdefault(f"{name}_{route}", []).extend(
                dispatch_us(fn) for _ in range(3))
    # the live B=256 step and the B=1 end of speech through the ops and
    # with every op swapped for its launch body (the route before the
    # ops), in alternating rounds
    rec = StreamingRecognizer(preds["default"], featurizer_mode="host")
    tone = speech_like(np.random.default_rng(11), 24000)
    for i in range(0, tone.size, STREAM_CHUNK):
        rec.feed(tone[i:i + STREAM_CHUNK])
    wf256 = torch.from_numpy(rows).to(dev)
    ln256 = torch.from_numpy(lengths).to(dev)
    steps = {"predict_b256": lambda: preds["default"].predict_waveform_batch(
                 wf256, ln256),
             "finalize_b1": rec._fused_finalize}
    launch_bodies = {"frontend_conv1": fk._frontend_conv1_cuda,
                     "frontend": fk._frontend_cuda, "mel_db": fk._mel_db_cuda,
                     "gru_layer": gru_ops._gru_layer_cuda,
                     "gru_layer_btc": gru_ops._gru_layer_btc_cuda,
                     "conv23": conv23_ops._conv23_cuda,
                     "bias_relu_pool2": pool_ops._bias_relu_pool2_cuda}
    swaps = {"op": {k: getattr(torch.ops.sir, k) for k in launch_bodies},
             "direct": launch_bodies}
    route_ms = {}
    for r in range(DISPATCH_ROUNDS):
        for route in list(swaps)[::1 if r % 2 == 0 else -1]:
            for name, fn in swaps[route].items():
                setattr(torch.ops.sir, name, fn)
            for step, fn in steps.items():
                route_ms.setdefault(f"{step}_{route}", []).append(
                    host_ms_blocks(fn, 50, blocks=1, warmup=10)[1])
    for name, fn in swaps["op"].items():
        setattr(torch.ops.sir, name, fn)
    log(f"live steps on {label} through the ops and through the launch "
        f"bodies alone, host ms per call of a block of 50, "
        f"{DISPATCH_ROUNDS} rounds in alternating order (median; blocks):")
    for k, v in route_ms.items():
        log(f"    {k}: {float(np.median(v)):.4f} "
            f"({', '.join(f'{x:.4f}' for x in v)})")
    log(f"op dispatch on {label}: host us per call enqueued back to back "
        f"(3 runs of 200 calls; median), the wrapper (checks, then the op), "
        f"the op alone, the kernel's launch body alone:")
    for k, v in dispatch.items():
        log(f"    {k}: {sorted(v)[1]:.2f} ({', '.join(f'{x:.2f}' for x in v)})")
    return {"launches": artifact_launches, "export_s": export_s,
            "served_ms": served_ms, "dispatch_us": dispatch,
            "route_ms": route_ms}


def wav2vec_flops(cfg, n_samples: int, num_classes: int) -> tuple:
    """Operations of one utterance through ``Wav2VecIntent``, counted from
    the shapes: (the conv feature encoder's, the rest's), 2 per
    multiply-add (the convolutions, the projection, the positional conv,
    q / k / v / out, scores and their sum over values, the FFN, the
    head)."""
    t, c_in, conv = n_samples, 1, 0.0
    for c_out, k, st in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // st + 1
        conv += 2.0 * t * c_out * c_in * k
        c_in = c_out
    h, g = cfg.hidden_size, cfg.num_conv_pos_embedding_groups
    rest = 2.0 * t * c_in * h + 2.0 * t * h * (h // g) * \
        cfg.num_conv_pos_embeddings
    rest += cfg.num_hidden_layers * (4 * 2.0 * t * h * h + 2 * 2.0 * t * t * h
                                     + 2 * 2.0 * t * h * cfg.intermediate_size)
    return conv, rest + 2.0 * t * h + 2.0 * h * num_classes


def seeded_wav2vec(cfg, dtype=torch.float32) -> "Wav2VecIntent":
    """The seeded full-width model of phase 19, its biases, norm parameters
    and mask embedding moved by 0.1 N(0, 1) off their initial zeros and
    ones, as a trained model's are.  At zero biases a row of feature length
    <= 0 stays exactly constant through the encoder, and its gradient grows
    by ~1 / sqrt(eps) at each of the 25 layer norms until it overflows: the
    JAX package does the same (ROADMAP Queue 3, noted in the reference)."""
    model = Wav2VecIntent(cfg, W2V_CLASSES, dtype).reset_parameters(
        torch.Generator().manual_seed(W2V_SEED))
    gen = torch.Generator().manual_seed(W2V_SEED + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def wav2vec_case(dev, tmp: str) -> dict:
    """Phase 19a: the full-width model card vs CPU (fp32), forward and one
    fine-tune step; bf16 against fp32 on the card."""
    import copy

    from speech_intent_recognizer_tpu_torch.data.labelmap import (
        save_label_map)

    cfg = Wav2Vec2Config(hidden_dropout=0.0, attention_dropout=0.0,
                         activation_dropout=0.0, layerdrop=0.0)
    cpu_model = seeded_wav2vec(cfg).eval()
    n_params = sum(p.numel() for p in cpu_model.wav2vec.parameters())
    width = W2V_CPU_LENGTHS[0]
    buf, ln = batch(list(W2V_CPU_LENGTHS), width, seed=1900)
    x = torch.from_numpy(buf)
    mask = torch.arange(width)[None] < torch.from_numpy(ln)[:, None].long()
    y = torch.tensor([3, 17])
    out = {"backbone_params": n_params}
    runs = {}
    for d in ("cpu", dev):
        model = copy.deepcopy(cpu_model).to(d)
        xd, md = x.to(d), mask.to(d)
        with torch.no_grad():
            hidden, logits = model.wav2vec(xd, md), model(xd, md)
        for p in feature_extractor_params(model):
            p.requires_grad_(False)
        trainer = Wav2VecTrainer(
            model, create_wav2vec_optimizer(model.parameters(), lr=W2V_LR),
            W2V_CLASSES, max_length=width, noise_prob=0.0)
        gen = torch.Generator(device=d).manual_seed(0)
        loss, _ = trainer.train_step(xd, md, y.to(d), gen)
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        runs[str(d)] = (hidden.cpu(), logits.cpu(), float(loss), grads,
                        {n: t.detach().cpu() for n, t in
                         model.state_dict().items()})
    (h_c, l_c, loss_c, g_c, s_c), (h_d, l_d, loss_d, g_d, s_d) = (
        runs["cpu"], runs[str(dev)])
    for key, name, got, want in (("hidden", "last hidden state", h_d, h_c),
                                 ("logits", "logits", l_d, l_c)):
        err, scale = max_err(got, want), float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and err <= W2V_FWD_BAR * scale,
              f"wav2vec2-base {name} card vs CPU (fp32, TF32 off, rows "
              f"{W2V_CPU_LENGTHS}): max |err| {err:.3e} <= {W2V_FWD_BAR} * "
              f"{scale:.3f}")
        out[f"{key}_err"] = err
    t_out, short = (int(feat_extract_output_lengths(cfg, torch.tensor(n)))
                    for n in W2V_CPU_LENGTHS)
    want_shape = (2, t_out, cfg.hidden_size)
    check(tuple(h_c.shape) == want_shape and short <= 0,
          f"hidden {tuple(h_c.shape)} (want {want_shape}); the "
          f"{W2V_CPU_LENGTHS[1]}-sample row has feature length {short} <= 0")
    loss_err = abs(loss_d - loss_c) / abs(loss_c)
    worst = max(g_c, key=lambda n: max_err(g_d[n], g_c[n])
                / (STEP_GRAD_ATOL + STEP_GRAD_RTOL
                   * float(g_c[n].abs().max())))
    check(loss_err <= STEP_LOSS_RTOL and sorted(g_c) == sorted(g_d)
          and all(within_scaled(g_d[n], g_c[n], STEP_GRAD_RTOL,
                                STEP_GRAD_ATOL) for n in g_c),
          f"wav2vec fine-tune step card vs CPU (extractor frozen, dropout "
          f"0, AdamW + plateau): loss {loss_d:.6f} vs {loss_c:.6f}, "
          f"relative {loss_err:.2e} <= {STEP_LOSS_RTOL}; {len(g_c)} clipped "
          f"gradients within rtol {STEP_GRAD_RTOL} / atol {STEP_GRAD_ATOL} "
          f"of scale (closest: {worst}, err "
          f"{max_err(g_d[worst], g_c[worst]):.2e})")
    moved = {n: (s_d[n] - s_c[n]).abs() for n in s_c}
    far = sum(int((m > 1e-3 * W2V_LR).sum()) for m in moved.values())
    total = sum(m.numel() for m in moved.values())
    step_err = max(float(m.max()) for m in moved.values())
    frozen_same = all(torch.equal(s_d[n], cpu_model.state_dict()[n])
                      for n in s_c if "feature_extractor" in n)
    check(step_err <= 2.001 * W2V_LR and far <= W2V_FAR_SHARE * total
          and frozen_same,
          f"wav2vec parameters after the step, card vs CPU: max |diff| "
          f"{step_err:.3e} <= 2 lr; {far} of {total} beyond 1e-3 lr (<= "
          f"{W2V_FAR_SHARE}); the frozen extractor unchanged")
    out.update(loss_rel_err=loss_err, param_far=far)

    # bf16 against fp32 on the card, through Wav2VecPredictor
    labels = os.path.join(tmp, "w2v_labels.json")
    save_label_map({f"intent_{i}": i for i in range(W2V_CLASSES)}, labels)
    rng = np.random.default_rng(1901)
    lens = list(rng.integers(16000, 80001, W2V_BF16_ROWS))
    buf, ln = batch(lens, 80000, seed=1902)
    preds, logits = {}, {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = Wav2VecIntent(Wav2Vec2Config(), W2V_CLASSES, dtype)
        model.load_state_dict(cpu_model.state_dict())
        preds[name] = Wav2VecPredictor(model, {f"intent_{i}": i for i in
                                               range(W2V_CLASSES)},
                                       AudioConfig(), dev)
        probs = preds[name].predict_waveform_batch(buf, ln)
        check(probs.shape == (W2V_BF16_ROWS, W2V_CLASSES)
              and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1).max()) < 1e-4,
              f"Wav2VecPredictor {name}, B={W2V_BF16_ROWS} of 1-5 s: "
              f"probabilities finite, rows sum to 1")
        wf = torch.from_numpy(buf).to(dev)
        keep = torch.arange(80000, device=dev)[None] < torch.from_numpy(
            ln).to(dev)[:, None]
        with torch.no_grad():
            logits[name] = preds[name].model(wf, keep).float().cpu()
        check(np.abs(torch.softmax(logits[name], -1).numpy() - probs).max()
              < 1e-6, f"{name} predictor's probabilities are its logits' "
              f"softmax")
    err = max_err(logits["bf16"], logits["fp32"])
    scale = float(logits["fp32"].abs().max())
    check(err <= W2V_BF16_BAR * scale,
          f"wav2vec2-base bf16 vs fp32 on the card, {W2V_BF16_ROWS} rows of "
          f"1-5 s: logits max |err| {err:.3e} <= {W2V_BF16_BAR} * "
          f"{scale:.3f}")
    out["bf16_logit_err"] = err
    out["bf16_logit_scale"] = scale
    out["state"] = cpu_model.state_dict()
    return out


def wav2vec_cli(dev, tmp: str, run: dict) -> dict:
    """Phase 19b: ``cli.train_wav2vec --small`` on phase 15's corpus, its
    model through ``cli.test_model`` and ``cli.evaluate`` with
    ``--model_type wav2vec``, one epoch of the warmup-cosine recipe; then
    the model's serving artifacts (production pinned at
    W2V_EXPORT_SIZES, portable), each loaded in a process of its own."""
    from speech_intent_recognizer_tpu_torch.cli import evaluate as cli_eval
    from speech_intent_recognizer_tpu_torch.cli import test_model
    from speech_intent_recognizer_tpu_torch.cli import train_wav2vec
    from speech_intent_recognizer_tpu_torch.data.manifest import (
        read_manifest)
    from speech_intent_recognizer_tpu_torch.evaluation.evaluate import (
        evaluate_manifest_with_predictor)
    from speech_intent_recognizer_tpu_torch.infer.export import (
        export_predictor)

    csvs, labels = run["csvs"], run["label_map"]
    out = {}
    for name, extra, epochs in (("plateau", [], W2V_TRAIN_EPOCHS),
                                ("warmup", ["--warmup_steps",
                                            str(W2V_WARMUP)], 1)):
        save = os.path.join(tmp, f"w2v_{name}")
        cfg_path = os.path.join(tmp, f"w2v_{name}.yaml")
        with open(cfg_path, "w") as f:
            f.write(f"model:\n  num_labels: {TONE_CLASSES}\n"
                    f"train:\n  save_path: {save}\n"
                    f"  early_stop_patience: {epochs}\n")
        t0 = time.perf_counter()
        result = train_wav2vec.main([
            "--config", cfg_path, "--train_csv", csvs["train"], "--val_csv",
            csvs["valid"], "--label_map", labels, "--small", "--epochs",
            str(epochs), "--batch_size", str(W2V_TRAIN_BATCH), "--device",
            str(dev), *extra])
        out[f"{name}_s"] = time.perf_counter() - t0
        losses = [h["train_loss"] for h in result["history"]]
        check(len(losses) == epochs and all(np.isfinite(losses)),
              f"cli.train_wav2vec --small ({name}): {epochs} epochs, train "
              f"loss finite {[round(v, 4) for v in losses]}")
        out[f"{name}_val_acc"] = result["best_val_acc"]
        out[f"{name}_history"] = [
            {k: round(v, 4) for k, v in h.items()} for h in result["history"]]
    ckpt = os.path.join(tmp, "w2v_plateau", "wav2vec_intent.pt")
    cfg_path = os.path.join(tmp, "w2v_plateau.yaml")
    wav = read_manifest(csvs["test"]).paths[0]
    r = test_model.main(["--model_type", "wav2vec", "--model", ckpt,
                         "--label_map", labels, "--audio", wav, "--config",
                         cfg_path, "--device", str(dev)])
    check(r is not None and r["predicted_label"].startswith("tone_"),
          f"cli.test_model --model_type wav2vec: {r['predicted_label']}")
    results_dir = os.path.join(tmp, "w2v_eval")
    ev = cli_eval.main(["--model_type", "wav2vec", "--model_path", ckpt,
                        "--test_csv", csvs["test"], "--label_map", labels,
                        "--config", cfg_path, "--results_dir", results_dir,
                        "--device", str(dev)])
    pred = Wav2VecPredictor.from_checkpoint(ckpt, labels, device=dev)
    direct = evaluate_manifest_with_predictor(pred,
                                              read_manifest(csvs["test"]))
    with open(os.path.join(results_dir, "classification_report.txt")) as f:
        head = f.readline().strip()
    check(ev["accuracy"] == direct["accuracy"]
          and head == f"Test Accuracy: {ev['accuracy']:.4f}",
          f"cli.evaluate --model_type wav2vec: accuracy {ev['accuracy']:.4f}"
          f" = evaluate_manifest_with_predictor's {direct['accuracy']:.4f}; "
          f"report says {head!r}")
    out["test_acc"] = ev["accuracy"]

    # serving artifacts of that model, each loaded by its own process
    base = os.path.join(tmp, "w2v_artifacts")
    dirs = {"production": os.path.join(base, "production"),
            "portable": os.path.join(base, "portable")}
    t0 = time.perf_counter()
    export_predictor(pred, dirs["production"], flavor="production",
                     batch_sizes=W2V_EXPORT_SIZES)
    out["export_production_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_predictor(pred, dirs["portable"])
    out["export_portable_s"] = time.perf_counter() - t0
    rows, lengths = decode_split(csvs["test"], pred._buffer_width())
    rows, lengths = rows[:W2V_EXPORT_SIZES[-1]], lengths[:W2V_EXPORT_SIZES[-1]]
    jobs = {}
    for name, requests in (("production", W2V_EXPORT_REQUESTS),
                           ("portable", W2V_EXPORT_REQUESTS[:1])):
        data = os.path.join(base, f"{name}_in.npz")
        np.savez(data, rows=rows, lengths=lengths,
                 requests=np.asarray(requests))
        jobs[f"w2v_{name}"] = (dirs[name], name, data,
                               os.path.join(base, f"{name}_out.npz"))
    found = run_children(jobs)
    pkg = "speech_intent_recognizer_tpu_torch."
    for name, (report, _) in found.items():
        mods = [m.removeprefix(pkg) for m in report["modules"]]
        check(mods == ["infer", "infer.export"]
              and all(v == {} for v in report["launches"].values()),
              f"{name} artifact loader: imported {mods} of the port (want "
              f"infer.export alone), launched {report['launches']} (want no "
              f"kernel)")
    report, got = found["w2v_production"]
    for n in W2V_EXPORT_REQUESTS:
        chunked, whole = served_as_chunks(pred, rows, lengths, n,
                                          W2V_EXPORT_SIZES)
        check(np.array_equal(got[f"b{n}"], chunked),
              f"wav2vec production artifact, {n} rows: bit-equal to the live "
              f"Wav2VecPredictor on the same program batch (vs the live call "
              f"of {n} rows: max |diff| "
              f"{float(np.abs(got[f'b{n}'] - whole).max()):.3e})")
    n = W2V_EXPORT_REQUESTS[0]
    report, got = found["w2v_portable"]
    err = float(np.abs(got[f"b{n}"] - pred.predict_waveform_batch(
        rows[:n], lengths[:n])).max())
    check(err <= 1e-5, f"wav2vec portable artifact vs the live fp32 "
          f"predictor, {n} rows: max |prob diff| {err:.3e} <= 1e-5")
    out["load_s"] = {k: r["load_s"] for k, (r, _) in found.items()}
    return out


def wav2vec_timings(dev, state: dict) -> dict:
    """Phase 19c: inference at W2V_INFER in bf16 and fp32 and the fine-tune
    step at W2V_STEPS (fp32, extractor frozen, AdamW + plateau), CUDA
    events and host clock (least / median / most of five blocks), beside
    the FLOP bound."""
    cfg = Wav2Vec2Config()
    lm = {f"intent_{i}": i for i in range(W2V_CLASSES)}
    cells = {}

    def measure(key, fn, iters, flops, precision, n_bytes):
        lo, med, hi = cuda_ms_blocks(fn, iters, warmup=3)
        _lo, host, host_most = host_ms_blocks(fn, 2, warmup=1)
        ms_bound, by = least_ms({precision: flops}, n_bytes)
        cells[key] = {"ms": med, "ms_least": lo, "ms_most": hi,
                      "host_ms": host, "host_ms_most": host_most,
                      "bound_ms": ms_bound, "bound_by": by,
                      "gflop": flops / 1e9}

    b, n = W2V_INFER
    rng = np.random.default_rng(1910)
    buf, ln = batch([n] * b, n, seed=1911)
    wf, lt = torch.from_numpy(buf).to(dev), torch.from_numpy(ln).to(dev)
    conv, rest = wav2vec_flops(cfg, n, W2V_CLASSES)
    weights = sum(t.numel() * 4 for t in state.values())
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model = Wav2VecIntent(cfg, W2V_CLASSES, dtype)
        model.load_state_dict(state)
        pred = Wav2VecPredictor(model, lm, AudioConfig(max_duration=3.0), dev)
        measure(f"infer_{name}_b{b}_{n}",
                lambda: pred.predict_waveform_batch(wf, lt), 5,
                b * (conv + rest), name, weights + nbytes(wf, lt))
        del pred, model
    for b, n in W2V_STEPS:
        model = Wav2VecIntent(cfg, W2V_CLASSES)
        model.load_state_dict(state)
        for p in feature_extractor_params(model):
            p.requires_grad_(False)
        model.to(dev)
        trainer = Wav2VecTrainer(model, create_wav2vec_optimizer(
            model.parameters(), lr=W2V_LR), W2V_CLASSES, max_length=n)
        buf, ln = batch(list(rng.integers(n // 2, n + 1, b)), n,
                        seed=1912 + b)
        wf = torch.from_numpy(buf).to(dev)
        mask = torch.arange(n, device=dev)[None] < torch.from_numpy(ln).to(
            dev)[:, None]
        y = torch.from_numpy(rng.integers(0, W2V_CLASSES, b)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(b)

        def step():
            return float(trainer.train_step(wf, mask, y, gen)[0])

        conv, rest = wav2vec_flops(cfg, n, W2V_CLASSES)
        # the frozen extractor runs forward only; the rest forward and
        # backward (gradients of activations and of weights)
        measure(f"step_fp32_b{b}_{n}", step, 3, b * (conv + 3 * rest),
                "fp32", 3 * weights + nbytes(wf, mask))
        del trainer, model
    torch.cuda.empty_cache()
    return cells


def sheet_rows() -> list:
    from speech_intent_recognizer_tpu_torch.tts.generate import (
        _read_sentence_sheet)

    return _read_sentence_sheet(SHEET)


def synthetic_pipeline(dev, tmp: str) -> dict:
    """Phase 20b: ``examples.make_ab_corpus --profile harder --variants 8``
    (304 utterances), then ``examples.synthetic_e2e``'s run of
    ``cli.run_pipeline`` on a 60 / 20 / 20 split of it (precompute with K3,
    a full-width bf16 model trained with K2 / K2T, evaluated with K2), the
    counters reset just before and read just after."""
    from speech_intent_recognizer_tpu_torch.config import load_config
    from speech_intent_recognizer_tpu_torch.examples import (
        make_ab_corpus, synthetic_e2e)

    t0 = time.perf_counter()
    manifest = make_ab_corpus.make_corpus(
        os.path.join(tmp, "ab_corpus"), variants=SYNTH_VARIANTS,
        profile="harder", seed=0)
    corpus_s = time.perf_counter() - t0
    n_sheet = len(sheet_rows())
    d = np.load(os.path.join(tmp, "ab_corpus", "features.npz"))
    check(len(manifest) == SYNTH_VARIANTS * n_sheet
          and d["features"].shape == (len(manifest), 64, 200)
          and bool(np.isfinite(d["features"]).all())
          and len(d["classes"]) == SYNTH_CLASSES,
          f"make_ab_corpus --profile harder --variants {SYNTH_VARIANTS}: "
          f"{len(manifest)} WAVs and their golden features in "
          f"{corpus_s:.1f} s")
    work = os.path.join(tmp, "synthetic_e2e")
    os.makedirs(work)
    paths = synthetic_e2e.write_splits(manifest, work,
                                       np.random.default_rng(0))
    stages = {}
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    metrics = synthetic_e2e.train_and_evaluate(
        paths, work, SYNTH_EPOCHS, str(dev), stage_times=stages)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    cfg = load_config(os.path.join(work, "config.json"))
    with open(os.path.join(work, "ckpt", "training_history.json")) as f:
        history = json.load(f)
    n = {s: sum(1 for _ in open(paths[s])) - 1
         for s in ("train", "valid", "test")}
    bs = cfg.train.batch_size
    eval_bs = bs * cfg.train.eval_batch_multiplier
    steps = history["epochs_run"] * -(-n["train"] // bs)
    eval_batches = history["epochs_run"] * -(-n["valid"] // eval_bs)
    test_batches = -(-n["test"] // eval_bs)
    precompute = sum(-(-v // cfg.data.precompute_batch_size)
                     for v in n.values())
    check_counts(launches, {
        "K3": precompute, "K2T": 2 * steps,
        "K2": 2 * (steps + eval_batches + test_batches),
        "K7": 3 * steps, "K7T": 3 * steps},
        f"synthetic_e2e's run_pipeline ({n}; {precompute} precompute "
        f"batches, {steps} train steps, {eval_batches} eval batches, "
        f"{test_batches} evaluate-stage batches)")
    # 12 steps an epoch on 184 utterances leave the model near chance
    # (PERF.md section 6): the accuracy is reported, not held to a
    # bar; the controls (examples.convergence_ab, waveform_ab) measure it
    losses = [h["train_loss"] for h in history["history"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"synthetic_e2e on the harder corpus: train loss finite and lower "
          f"after {history['epochs_run']} epochs than after the first "
          f"{[round(x, 4) for x in losses]}; test accuracy "
          f"{metrics['accuracy']:.4f}; run_pipeline {seconds:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in stages.items()))
    return {"launches": launches, "accuracy": metrics["accuracy"],
            "val_acc": history["best_val_acc"],
            "epochs": history["epochs_run"], "seconds": seconds,
            "corpus_s": corpus_s, "stages": stages,
            "best": os.path.join(work, "ckpt", "best_model.pt"),
            "label_map": os.path.join(work, "label_map.json"),
            "paths": [p for p, _ in manifest],
            "labels": [lab for _, lab in manifest]}


def tts_holdout(dev, tmp: str, tts_dir: str, run: dict) -> dict:
    """Phase 20c: ``cli.test_tts_samples`` over the TTS WAVs with phase
    20b's model on the card (one K1, one K5 and two K2 a file, nothing
    else) and
    with ``--device cpu``: equal predicted labels, confidences within
    phase 4's bar."""
    from speech_intent_recognizer_tpu_torch.cli.test_tts_samples import (
        main as tts_main)

    args = ["--model", run["best"], "--label_map", run["label_map"],
            "--audio_dir", tts_dir]
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    card = tts_main(args + ["--report_dir", os.path.join(tmp, "tts_card"),
                            "--device", str(dev)])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = counters()
    n = len(card["rows"])
    check(n == len(sheet_rows()), f"the TTS holdout predicted {n} WAVs")
    check_counts(launches, {"K1": n, "K5": n, "K2": 2 * n},
                 f"cli.test_tts_samples on the card over {n} WAVs")
    t0 = time.perf_counter()
    cpu = tts_main(args + ["--report_dir", os.path.join(tmp, "tts_cpu"),
                           "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    same = [a["predicted"] == b["predicted"]
            for a, b in zip(card["rows"], cpu["rows"])]
    err = float(np.abs(np.array([r["confidence"] for r in card["rows"]])
                       - [r["confidence"] for r in cpu["rows"]]).max())
    check([r["file"] for r in card["rows"]]
          == [r["file"] for r in cpu["rows"]] and all(same)
          and err < PROB_GATE,
          f"TTS holdout card vs CPU: predicted equal on {sum(same)} of {n}, "
          f"confidence err {err:.3e} < {PROB_GATE}")
    for name in ("detailed_results.csv", "classification_report.csv"):
        check(os.path.exists(os.path.join(tmp, "tts_card", name)),
              f"the TTS holdout wrote {name}")
    log(f"TTS holdout accuracy {card['accuracy']:.4f} (card) / "
        f"{cpu['accuracy']:.4f} (CPU) over {n} clean synthetic WAVs; "
        f"{card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU")
    return {"launches": launches, "accuracy": card["accuracy"],
            "cpu_accuracy": cpu["accuracy"], "conf_err": err,
            "card_s": card_s, "cpu_s": cpu_s}


def librosa_mode(dev, run: dict, tts_dir: str) -> dict:
    """Phase 20d: a librosa-mode predictor of phase 20b's model on the
    card (plain front-end, no K1 / K3 / K4) against the CPU predictor and
    against the fp64 golden features through the same model."""
    cfg = AudioConfig(frontend="librosa")
    wavs = sorted(f for f in os.listdir(tts_dir) if f.endswith(".wav"))
    pred = Predictor.from_checkpoint(run["best"], run["label_map"],
                                     audio_cfg=cfg, device=dev)
    check(pred._conv1 is None, "librosa mode: the fused K1 path is off")
    width = pred._buffer_width()
    buf = np.zeros((len(wavs), width), np.float32)
    ln = np.zeros(len(wavs), np.int32)
    for i, name in enumerate(wavs):
        x, _ = load_audio(os.path.join(tts_dir, name))
        ln[i] = min(len(x), cfg.max_samples)
        buf[i, :ln[i]] = x[:ln[i]]
    torch.cuda.synchronize()
    reset_counters()
    probs = pred.predict_waveform_batch(buf, ln)
    torch.cuda.synchronize()
    launches = counters()
    check_counts(launches, {"K2": 2},
                 f"librosa-mode predictor, B={len(wavs)} (K1, K3, K4 none)")
    cpu_pred = Predictor.from_checkpoint(run["best"], run["label_map"],
                                         audio_cfg=cfg, device="cpu")
    check_probs(probs, cpu_pred.predict_waveform_batch(buf, ln),
                f"librosa-mode predictor on the card vs the CPU, "
                f"B={len(wavs)}")
    feats = log_mel_frontend(torch.from_numpy(buf).to(dev),
                             torch.from_numpy(ln).to(dev),
                             pred.frontend_params).cpu().numpy()
    gold = np.stack([golden.pad_or_trim_np(golden.log_mel_spectrogram_np(
        buf[i, :n], frontend="librosa"), 200) for i, n in enumerate(ln)])
    err = float(np.abs(feats - gold).max())
    check(np.allclose(feats, gold, rtol=LIBROSA_RTOL, atol=LIBROSA_ATOL),
          f"librosa front-end on the card vs the fp64 golden: max |err| "
          f"{err:.3e} (rtol {LIBROSA_RTOL}, atol {LIBROSA_ATOL})")
    with torch.inference_mode():
        want = torch.softmax(pred.model(torch.from_numpy(gold).to(
            dev)).float(), -1).cpu().numpy()
    check_probs(probs, want, "librosa-mode predictor vs the golden "
                "features through the same model")
    return {"launches": launches, "feature_err": err}


def prefetch_epoch(dev, run: dict) -> dict:
    """Phase 20e: one epoch of the small wav2vec recipe on the card with
    ``device_prefetch`` (pinned, non-blocking copies on a side stream) and
    with the synchronous copies it replaced, after one warm-up epoch, in
    the order A B B A: bit-equal losses and weights every time."""
    from speech_intent_recognizer_tpu_torch.models import wav2vec as w2v
    from speech_intent_recognizer_tpu_torch.train import (
        wav2vec_trainer as wt)

    names = sorted(set(run["labels"]))
    paths = run["paths"][:PREFETCH_FILES]
    labels = [names.index(lab) for lab in run["labels"][:PREFETCH_FILES]]
    n_train = PREFETCH_FILES * 3 // 4
    prefetch = wt.device_prefetch

    def synchronous(host, buffer_size, device):
        for x, mask, y in host:
            yield (torch.from_numpy(x).to(device),
                   torch.from_numpy(mask).to(device),
                   torch.from_numpy(y).to(device, torch.int64))

    def epoch(route):
        model = w2v.init_wav2vec(w2v.Wav2VecIntent(
            w2v.small_wav2vec_config(), len(names)), 0).to(dev)
        trainer = wt.Wav2VecTrainer(model, wt.create_wav2vec_optimizer(
            model.parameters(), lr=1e-3), len(names))
        wt.device_prefetch = route
        try:
            t0 = time.perf_counter()
            out = trainer.fit(paths[:n_train], labels[:n_train],
                              paths[n_train:], labels[n_train:], epochs=1,
                              batch_size=8, seed=0, log=lambda m: None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            wt.device_prefetch = prefetch
        h = out["history"][0]
        return ((h["train_loss"], h["val_loss"], h["val_acc"]), seconds,
                {k: v.cpu() for k, v in model.state_dict().items()})

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want, _, want_state = epoch(synchronous)  # warm-up
        runs = [(name, *epoch(route)) for name, route in (
            ("prefetch", prefetch), ("sync", synchronous),
            ("sync", synchronous), ("prefetch", prefetch))]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    seconds = {n: [s for m, _, s, _ in runs if m == n]
               for n in ("prefetch", "sync")}
    check(all(got == want and all(torch.equal(state[k], want_state[k])
                                  for k in want_state)
              for _, got, _, state in runs),
          f"wav2vec epoch ({n_train} train / {PREFETCH_FILES - n_train} "
          f"valid files, small config) through device_prefetch and through "
          f"synchronous copies (A B B A after a warm-up): losses {want} "
          f"bit-equal, every weight equal; seconds {seconds}")
    return {"seconds": seconds}


def traced_predict(dev, tmp: str, run: dict) -> dict:
    """Phase 20f: ``utils.trace`` around one B=256 ``predict_waveform_batch``
    of phase 20b's model inside a ``trace_annotation``: the trace names
    K1's and K2's kernels and the region."""
    from speech_intent_recognizer_tpu_torch.utils import (
        trace, trace_annotation)

    pred = Predictor.from_checkpoint(run["best"], run["label_map"],
                                     device=dev)
    rng = np.random.default_rng(20)
    buf, ln = batch(list(rng.integers(1, 80001, MAIN_BATCH)),
                    padded_samples(80000), seed=20)
    wf = torch.from_numpy(buf).to(dev)
    pred.predict_waveform_batch(wf, ln)  # warm
    logdir = os.path.join(tmp, "trace")
    with trace(logdir):
        # a trace taken after phases 1-19 once held no record of K1's
        # launch, the batch's first kernel: the window now opens and closes
        # on a throwaway launch, each side of the traced batch synchronized
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
        with trace_annotation("phase20_predict_b256"):
            probs = pred.predict_waveform_batch(wf, ln)
        torch.ones(1, device=dev).add_(1)
    check(probs.shape == (MAIN_BATCH, SYNTH_CLASSES)
          and bool(np.isfinite(probs).all()), "traced batch's probabilities")
    files = os.listdir(logdir)
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    check(len(files) == 1 and "phase20_predict_b256" in names
          and any("frontend_conv1_kernel" in n for n in kernels)
          and any("gru_layer" in n for n in kernels),
          f"trace {files} of {len(events)} events names the annotated "
          f"region, K1's kernel and K2's among the kernels "
          f"{[n[:60] for n in kernels]} (events by category: "
          f"{dict(Counter(e.get('cat') for e in events))})")
    return {"events": len(events), "kernels": kernels}


def check_synthetic(dev, tmp: str, label: str) -> dict:
    """Phase 20: the hermetic TTS corpus and its holdout, training on the
    synthetic A/B corpus, the librosa mode, device prefetch, tracing and
    the diagnostics."""
    from speech_intent_recognizer_tpu_torch.cli.generate_tts_samples import (
        main as tts_main)
    from speech_intent_recognizer_tpu_torch.utils import diagnostics

    t_phase = time.perf_counter()
    # a. the TTS corpus of the sentence sheet
    tts_dir = os.path.join(tmp, "tts")
    tts_main(["--csv", SHEET, "--output_dir", tts_dir, "--engine",
              "synthetic"])
    wavs = sorted(f for f in os.listdir(tts_dir) if f.endswith(".wav"))
    decoded = [load_audio(os.path.join(tts_dir, f)) for f in wavs]
    check(len(wavs) == len(sheet_rows())
          and all(sr == 16000 and len(x) > 0 and bool(np.isfinite(x).all())
                  for x, sr in decoded),
          f"generate_tts_samples --engine synthetic: {len(wavs)} WAVs, each "
          f"decoded by load_audio")
    # b-h
    run = synthetic_pipeline(dev, tmp)
    control_a = control_a_smoke(dev, tmp)
    holdout = tts_holdout(dev, tmp, tts_dir, run)
    librosa = librosa_mode(dev, run, tts_dir)
    prefetch = prefetch_epoch(dev, run)
    traced = traced_predict(dev, tmp, run)
    check(diagnostics.device_smoke_test(device=dev),
          "diagnostics.device_smoke_test on the card")
    stress = diagnostics.stress_test(seconds=STRESS_S, device=dev)
    log(f"diagnostics.stress_test on {label}: {stress['matmuls']} bf16 "
        f"matmuls of 4096^2 in {stress['seconds']:.3f} s (CUDA events) -> "
        f"{stress['tflops']:.1f} TFLOP/s")
    seconds = time.perf_counter() - t_phase
    return {"synthetic": run, "holdout": holdout, "librosa": librosa,
            "prefetch": prefetch, "trace": traced, "stress": stress,
            "control_a": control_a, "seconds": seconds}


def control_a_smoke(dev, tmp: str) -> dict:
    """Phase 20h: accuracy control (a)'s recipe
    (``examples.convergence_ab.train_port``: the reference model in fp32,
    B=16) for one epoch on phase 20b's features, the counters reset just
    before and read just after: K2T twice a step, every launch the fp32
    cluster backward."""
    from speech_intent_recognizer_tpu_torch.examples import convergence_ab

    feats, labels, v_feats, v_labels = convergence_ab.load_features_npz(
        os.path.join(tmp, "ab_corpus", "features.npz"), 0.2)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    acc, _ = convergence_ab.train_port(feats, labels, v_feats, v_labels, 1,
                                       batch=16, device=str(dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    steps = -(-len(feats) // 16)
    check(launches["K2T"] == launches["K2T_cluster"] == 2 * steps,
          f"control (a)'s recipe, one epoch of {steps} fp32 steps at B=16: "
          f"K2T launched {launches['K2T']}x, {launches['K2T_cluster']} of "
          f"them the fp32 cluster backward (want {2 * steps} and "
          f"{2 * steps}); held-out acc {acc:.4f}, {seconds:.1f} s")
    return {"launches": launches, "acc": acc, "seconds": seconds}


def check_wav2vec(dev, tmp: str, run: dict) -> dict:
    """Phase 19: the wav2vec family at full width, with every kernel
    counter reset before and read after (the path launches none)."""
    t0 = time.perf_counter()
    reset_counters()
    case = wav2vec_case(dev, tmp)
    state = case.pop("state")
    cli = wav2vec_cli(dev, tmp, run)
    cells = wav2vec_timings(dev, state)
    check_counts(counters(), {}, "the wav2vec phase (model, step, CLIs, "
                 "artifacts, timings)")
    return {"card_vs_cpu": case, "cli": cli, "cells": cells,
            "flop_per_utt_3s": sum(wav2vec_flops(Wav2Vec2Config(), 48000,
                                                 W2V_CLASSES)),
            "seconds": time.perf_counter() - t0}


def dp_cli_run(dev, tmp: str, csvs: dict, label_map: str, name: str,
               waveform: bool, coordinator=None) -> tuple:
    """Phase 21a: ``cli.train`` of the DP config ``name``; -> (result,
    launches, the model after each epoch)."""
    from speech_intent_recognizer_tpu_torch.cli import train as cli_train

    path = os.path.join(tmp, f"{name}.yaml")
    flag = str(waveform).lower()
    with open(path, "w") as f:
        f.write(f"data:\n  cache_dir: {os.path.join(tmp, 'dp_cache')}\n"
                f"  precompute_batch_size: {PRECOMPUTE_BATCH}\n"
                f"  train_on_waveforms: {flag}\n"
                f"  use_waveform_augment: {flag}\n"
                f"model:\n  num_labels: {TONE_CLASSES}\n"
                f"train:\n  epochs: {DP_EPOCHS}\n"
                f"  batch_size: {TRAIN_BATCH}\n  lr: {DP_LR}\n"
                f"  early_stop_patience: {DP_EPOCHS}\n  bf16: false\n"
                f"  save_path: {os.path.join(tmp, name)}\n")
        if coordinator is not None:
            f.write(f"parallel:\n  coordinator_address: {coordinator}\n"
                    f"  num_processes: 1\n  process_id: 0\n  data_axis: 1\n")
    torch.cuda.synchronize()
    reset_counters()
    result = cli_train.main(["--config", path, "--train_csv", csvs["train"],
                             "--val_csv", csvs["valid"], "--label_map",
                             label_map, "--device", str(dev)])
    launches = counters()
    states = [torch.load(os.path.join(tmp, name, "state",
                                      f"epoch_{e:06d}.pt"),
                         map_location="cpu", weights_only=True)["model"]
              for e in range(1, DP_EPOCHS + 1)]
    return result, launches, states


def torch_epilogue(fn):
    """``fn`` with K7's rule held off while it runs: every conv stage's
    epilogue through the torch chain, as a step with a sync group runs
    it."""
    def run():
        engages = bn_pool.engages
        bn_pool.engages = lambda bn, x: False
        try:
            return fn()
        finally:
            bn_pool.engages = engages
    return run


def check_distributed(dev, tmp: str, run: dict, timings: dict) -> dict:
    """Phase 21: data-parallel training, evaluation and serving.  a.
    ``cli.train`` with a coordinator (world 1, NCCL) against the same run
    without, in feature and waveform mode, and the DP machinery's cost at
    world 1 on the bf16 steps; b. ``dryrun_multichip(2, "cuda")``: two
    processes on the one card over gloo, each part held to the one-process
    step, each process's launches; c. ``Predictor(mesh=)`` over [dev, dev]
    on a ragged batch against the meshless rows."""
    from speech_intent_recognizer_tpu_torch.cli import (
        precompute_features as cli_pre)
    from speech_intent_recognizer_tpu_torch.ops.augment import draw_augment
    from speech_intent_recognizer_tpu_torch.parallel.dryrun import (
        dryrun_multichip)
    from speech_intent_recognizer_tpu_torch.parallel.mesh import create_mesh

    t0 = time.perf_counter()
    out = {"launches": {}}
    # ---- 21a ----
    csvs = {}
    for split, n in (("train", DP_TRAIN), ("valid", DP_VAL)):
        with open(run["csvs"][split]) as f:
            lines = f.read().splitlines()
        csvs[split] = os.path.join(tmp, f"dp_{split}.csv")
        with open(csvs[split], "w") as f:
            f.write("\n".join(lines[:n + 1]) + "\n")
    cli_pre.main(["--train_csv", csvs["train"], "--valid_csv", csvs["valid"],
                  "--test_csv", csvs["valid"], "--output_dir",
                  os.path.join(tmp, "dp_cache"), "--label_map",
                  run["label_map"], "--device", str(dev)])
    for mode in ("feature", "waveform"):
        waveform = mode == "waveform"
        plain, plain_launches, plain_states = dp_cli_run(
            dev, tmp, csvs, run["label_map"], f"dp_{mode}_plain", waveform)
        dp, launches, dp_states = dp_cli_run(
            dev, tmp, csvs, run["label_map"], f"dp_{mode}", waveform,
            "file://" + os.path.join(tmp, f"dp_{mode}_store"))
        dist = torch.distributed
        check(dist.is_initialized() and dist.get_world_size() == 1
              and dist.get_backend() == "nccl",
              f"cli.train {mode}: a process group of 1 over NCCL")
        steps = DP_EPOCHS * -(-DP_TRAIN // TRAIN_BATCH)
        evals = DP_EPOCHS * -(-DP_VAL // (2 * TRAIN_BATCH))
        want = {"K2": 2 * steps + 2 * evals, "K2T": 2 * steps,
                "K2T_cluster": 2 * steps}
        if waveform:
            want["K3"] = steps + evals
        check_counts(plain_launches, want, f"cli.train {mode}, one process")
        check_counts(launches, want, f"cli.train {mode} with a coordinator")
        out["launches"][f"cli_train_{mode}"] = launches
        l_dp = [h["train_loss"] for h in dp.history]
        l_plain = [h["train_loss"] for h in plain.history]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_dp, l_plain))
        check(len(l_dp) == len(l_plain) == DP_EPOCHS
              and loss_err <= STEP_LOSS_RTOL,
              f"cli.train {mode} with a coordinator vs without: the "
              f"{DP_EPOCHS} steps' losses {l_dp} vs {l_plain}, relative err "
              f"{loss_err:.2e} <= {STEP_LOSS_RTOL}")
        steps_out = []
        for step, (dp_state, plain_state) in enumerate(
                zip(dp_states, plain_states), 1):
            weights = [k for k in plain_state if "running" not in k
                       and "num_batches" not in k]
            total = sum(plain_state[k].numel() for k in weights)
            apart = {k: int(((dp_state[k] - plain_state[k]).abs()
                             > DP_LR / 2).sum()) for k in weights}
            flips = sum(apart.values())
            w_err = max(max_err(dp_state[k], plain_state[k])
                        for k in weights)
            bn_err = max(max_err(dp_state[k], plain_state[k])
                         for k in plain_state if "running" in k)
            where = {k: v for k, v in apart.items() if v}
            check(flips <= DP_FLIP_SHARE * total and bn_err <= STEP_BN_ATOL,
                  f"cli.train {mode}: after step {step} with a coordinator "
                  f"vs without, {flips} of {total} weights "
                  f"({flips / total:.2e}) more than lr / 2 apart <= "
                  f"{DP_FLIP_SHARE} ({where}; max |err| {w_err:.2e}); "
                  f"BatchNorm's running statistics max |err| {bn_err:.2e} "
                  f"<= {STEP_BN_ATOL}")
            steps_out.append({"apart": flips, "share": flips / total,
                              "weight_err": w_err, "bn_err": bn_err})
        out[f"cli_{mode}"] = {"loss_err": loss_err, "steps": steps_out}
        if not waveform:
            dist.destroy_process_group()
    # the DP machinery at world 1 against the one-process step, A B B A;
    # both sides' conv epilogues through the torch chain (K7 does not
    # engage with a sync group), so that the gap is the DP machinery's
    mesh = create_mesh()
    for mode, b, iters in DP_TIMED:
        if mode == "feature":
            one, par = train_step_timer(dev, b), train_step_timer(dev, b,
                                                                  mesh)
        else:
            one, par = (wave_step_timer(dev, b)[0],
                        wave_step_timer(dev, b, mesh)[0])
        one = torch_epilogue(one)
        for side, fn in (("one process", one), ("world 1", par)):
            torch.cuda.synchronize()
            reset_counters()
            fn()
            got = counters()
            check(got["K7"] == got["K7T"] == 0,
                  f"DP at world 1, bf16 {mode} step B={b}, {side}: the conv "
                  f"epilogues through the torch chain (K7 {got['K7']}, "
                  f"backward {got['K7T']}; want 0)")
        blocks = [[cuda_ms(fn, iters) for fn in (one, par, par, one)]
                  for _ in range(DP_ABBA)]
        # each block's cost of world 1: its B windows over its A windows
        costs = [(t[1] + t[2]) / (t[0] + t[3]) - 1.0 for t in blocks]
        timings[f"{mode}_step_bf16_b{b}_one"] = float(np.mean(
            [(t[0] + t[3]) / 2 for t in blocks]))
        timings[f"{mode}_step_bf16_b{b}_dp1"] = float(np.mean(
            [(t[1] + t[2]) / 2 for t in blocks]))
        out[f"{mode}_b{b}_abba"] = blocks
        out[f"{mode}_b{b}_dp1_cost"] = costs
        log(f"  DP at world 1, bf16 {mode} step B={b}, both sides' conv "
            f"epilogues the torch chain, {DP_ABBA} blocks of "
            f"A B B A x {iters}: {blocks} ms; cost a block "
            f"{[f'{c:+.2%}' for c in costs]}")
        del one, par
    torch.distributed.destroy_process_group()
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in (512, 1024):
        timings[f"augment_draws_b{b}"] = cuda_ms(
            lambda: draw_augment(b, PRECOMPUTE_WIDTH, gen, dev), 10)
    # ---- 21b ----
    t1 = time.perf_counter()
    dry = dryrun_multichip(2, device="cuda", timeout_s=400.0)
    out["dryrun_s"] = time.perf_counter() - t1
    check(set(dry["parts"]) == {"feature", "wav2vec", "waveform",
                                "checkpoint", "serving"}
          and all(r["backend"] == "gloo" for r in dry["ranks"]),
          f"dryrun_multichip(2, cuda): every part over gloo, "
          f"{out['dryrun_s']:.1f} s")
    for r in dry["ranks"]:
        parts = {p["part"]: p for p in r["parts"]}
        check_counts(parts["feature"]["launches"],
                     {"K2": 2, "K2T": 2, "K2T_cluster": 2},
                     f"dryrun process {r['rank']}, feature step")
        check_counts(parts["waveform"]["launches"],
                     {"K3": 1, "K2": 2, "K2T": 2, "K2T_cluster": 2},
                     f"dryrun process {r['rank']}, waveform step")
    check_counts(dry["parts"]["serving"]["launches"],
                 {"K1": 2, "K5": 2, "K2": 4}, "dryrun serving mesh of 2")
    out["dryrun"] = {k: {f: v for f, v in p.items() if f != "launches"}
                     for k, p in dry["parts"].items()}
    out["launches"]["dryrun"] = {
        f"process_{r['rank']}": {p["part"]: p["launches"]
                                 for p in r["parts"] if "launches" in p}
        for r in dry["ranks"]}
    # ---- 21c ----
    mesh = create_mesh(devices=[dev, dev])
    pred = Predictor.from_checkpoint(run["best"], run["label_map"],
                                     device=dev, mesh=mesh)
    plain = Predictor.from_checkpoint(run["best"], run["label_map"],
                                      device=dev)
    buf, ln = decode_split(run["test_csv"], padded_samples(80000))
    buf, ln = buf[:DP_SERVE_ROWS], ln[:DP_SERVE_ROWS]
    torch.cuda.synchronize()
    reset_counters()
    got = pred.predict_waveform_batch(buf, ln)
    launches = counters()
    check_counts(launches, {"K1": 2, "K5": 2, "K2": 4},
                 f"serving mesh [{dev}, {dev}], {DP_SERVE_ROWS} rows")
    out["launches"]["serving_mesh"] = launches
    want = plain.predict_waveform_batch(buf, ln)
    check_probs(got, want, f"serving mesh [{dev}, {dev}] vs meshless, "
                f"{DP_SERVE_ROWS} rows")
    out["serving_err"] = float(np.abs(got - want).max())
    out["seconds"] = time.perf_counter() - t0
    return out


def check_tensor_parallel(dev) -> dict:
    """Phase 22: the dry run on the dp1 x tp2 and dp2 x tp2 grids of
    processes sharing the card; every check of each part is the dry
    run's, these are each process's launches, bytes and replicas."""
    from speech_intent_recognizer_tpu_torch.parallel.dryrun import (
        dryrun_multichip)

    t0 = time.perf_counter()
    out = {"launches": {}, "runs": {}}
    steps = ("feature", "wav2vec", "waveform", "checkpoint")
    for n in (2, 4):
        data = n // 2
        name = f"dp{data}xtp2"
        t1 = time.perf_counter()
        dry = dryrun_multichip(n, device="cuda", model_axis=2,
                               timeout_s=400.0)
        seconds = time.perf_counter() - t1
        parts = dry["meshes"][name]
        check(set(parts) == set(steps) | {"serving"}
              and all(r["backend"] == "gloo" for r in dry["ranks"]),
              f"dryrun_multichip({n}, cuda, model_axis=2): every part on "
              f"{name} over gloo, {seconds:.1f} s")
        for r in dry["ranks"]:
            got = {p["part"]: p for p in r["parts"]}
            what = f"{name} process {r['rank']}"
            check_counts(got["feature"]["launches"],
                         {"K2": 2, "K2T": 2, "K2T_cluster": 2},
                         f"{what}, feature step")
            check_counts(got["waveform"]["launches"],
                         {"K3": 1, "K2": 2, "K2T": 2, "K2T_cluster": 2},
                         f"{what}, waveform step")
            for part in steps:
                by = got[part]["bytes"]
                check(by["split"] > 0 and 2 * by["split"] == by["split_full"]
                      and 2 * by["adam_split"] == by["adam_split_full"]
                      and got[part]["replicas_equal"],
                      f"{what}, {part}: half of each split leaf and of its "
                      f"Adam moments ({by}), the whole parameters equal on "
                      f"every process")
        check_counts(parts["serving"]["launches"],
                     {"K1": data, "K5": data, "K2": 2 * data},
                     f"{name} serving mesh of {n} entries")
        out["runs"][name] = {
            "seconds": seconds,
            "parts": {k: {f: v for f, v in p.items() if f != "launches"}
                      for k, p in parts.items()},
            "bytes": {f"process_{r['rank']}": {
                p["part"]: p["bytes"] for p in r["parts"] if "bytes" in p}
                for r in dry["ranks"]}}
        out["launches"][name] = {
            f"process_{r['rank']}": {p["part"]: p["launches"]
                                     for p in r["parts"] if "launches" in p}
            for r in dry["ranks"]}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = gpu_label()
    log(f"device: {torch.cuda.get_device_name(dev)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | {label}")
    cfg = AudioConfig()
    width = padded_samples(cfg.max_samples, cfg.hop_length)
    fe = make_frontend_params(cfg, dev)

    # ---- 1. build: the kernels, and libsirdsp (host C++ of the streaming
    # featurizer's native mode) beside them when the checkout has none ----
    t0 = time.perf_counter()
    native_build = None
    if not os.path.exists(os.path.join(ROOT, "native", "build",
                                       "libsirdsp.so")):
        native_build = subprocess.Popen(
            [os.path.join(ROOT, "native", "build.sh")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build(ptxas_verbose=True)
    _build.load()
    if native_build is not None:
        out = native_build.communicate(timeout=600)[0]
        check(native_build.returncode == 0,
              f"native/build.sh exit {native_build.returncode}: "
              f"{out.strip()[-300:]}")
    check(native.available(), "libsirdsp loaded")
    log(f"built {_build.library_path()} and libsirdsp in "
        f"{time.perf_counter() - t0:.1f} s")
    resources = fk.kernel_resources(dev, tuple(
        make_frontend_params(AudioConfig(n_fft=n, hop_length=n // 4), dev)
        for n in (1024, 512, 2048)))
    resources.update(gru_ops.kernel_resources(dev))
    resources.update(conv23_ops.kernel_resources(dev))
    check(all(r["blocks_per_sm"] >= 1 for r in resources.values())
          and all(r.get("clusters_per_card", 1) >= 1
                  for r in resources.values()),
          "K1, K3, K4, K5, the tensor-core K2 and K2T and the fp32 cluster "
          "K2 as built fit an SM, and at least one cluster of each cluster "
          "kernel the card")
    log(f"resources on {label} (registers per thread, local (spilled) bytes per "
        f"thread, shared memory per block, threads per block, resident "
        f"blocks per SM; for the cluster kernels also blocks per cluster and "
        f"resident clusters per card): " + json.dumps(resources))

    rng = np.random.default_rng(0)
    main_lengths = CHECK_LENGTHS + list(
        rng.integers(1, cfg.max_samples + 1, MAIN_BATCH - len(CHECK_LENGTHS)))
    main_buf, main_ln = batch(main_lengths, width, seed=100)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        model_path, label_path, state = seeded_checkpoint(tmp)
        # ---- 2. each kernel vs its plain version at its main path's shape
        kernel_errs = check_kernels(dev, fe, main_buf, main_ln,
                                    fold_batchnorm(state),
                                    np.random.default_rng(2))

        # ---- 4. end to end: the main path, the fp64 golden gates ----
        pred = Predictor.from_checkpoint(model_path, label_path, device=dev)
        check(pred._conv1 is not None, "fused conv1 path enabled")
        wf_main = torch.from_numpy(main_buf).to(dev)
        torch.cuda.synchronize()
        reset_counters()
        probs = pred.predict_waveform_batch(wf_main, main_ln)
        main_launches = counters()
        check_counts(main_launches, {"K1": 1, "K5": 1, "K2": 2},
                     f"main path, B={MAIN_BATCH}")
        check(probs.shape == (MAIN_BATCH, 31)
              and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1).max()) < 1e-4,
              f"B={MAIN_BATCH} probabilities finite, (B, 31), rows sum to 1")

        cpu_pred = Predictor.from_checkpoint(model_path, label_path,
                                             device="cpu")
        check_probs(probs[:16], cpu_pred.predict_waveform_batch(
            main_buf[:16], main_ln[:16]),
            "main run vs the CPU predictor (plain versions), 16 rows")

        gate_buf, gate_ln = batch(GATE_LENGTHS, width, seed=1)
        feats = log_mel_frontend_plain(torch.from_numpy(gate_buf).to(dev),
                                       torch.from_numpy(gate_ln).to(dev),
                                       fe).cpu().numpy()
        golden_feats = np.stack([
            golden.pad_or_trim_np(golden.log_mel_spectrogram_np(
                gate_buf[i, :n]), cfg.mel_spec_length).astype(np.float32)
            for i, n in enumerate(GATE_LENGTHS)])
        feat_err = float(np.abs(feats - golden_feats).max())
        check(feat_err < 0.05,
              f"plain front-end vs golden: feature err {feat_err:.3e} < 0.05")
        gate_probs = pred.predict_waveform_batch(gate_buf, gate_ln)
        ref_model = CNNAudioGRU(num_classes=31, fold_bn=True)
        ref_model.load_state_dict(fold_batchnorm(state))
        with torch.no_grad():
            want_probs = torch.softmax(ref_model.eval()(
                torch.from_numpy(golden_feats)), -1).numpy()
        check_probs(gate_probs, want_probs, "fused path vs golden features "
                    "-> unfused folded model")

        # ---- 5. CLI ----
        from speech_intent_recognizer_tpu_torch.cli.test_model import (
            main as cli_main)

        wav = os.path.join(tmp, "utterance.wav")
        save_wav(wav, speech_like(np.random.default_rng(9), 24000), 16000)
        result = cli_main(["--model", model_path, "--label_map", label_path,
                           "--audio", wav, "--device", str(dev)])
        check(result is not None and result["predicted_label"]
              in pred.label_map, f"CLI predicted {result['predicted_label']}")

        # ---- 6. K7 as built: resources and times ----
        k7 = time_k7(dev)

        # ---- 7. off the reference geometry: the front-end through K4 ----
        hop256_launches = check_hop256(dev, model_path, label_path, rng)

        # ---- 9. timing (CUDA events; card and power limit beside) ----
        c1w = torch.from_numpy((rng.standard_normal((32, 1, 3, 3)) / 3.0)
                               .astype(np.float32)).to(dev)
        c1b = torch.from_numpy((0.1 * rng.standard_normal(32))
                               .astype(np.float32)).to(dev)
        timings, bounds, spreads = {}, {}, {}
        for b in TIMING_BATCHES:
            buf, ln = batch(list(rng.integers(1, cfg.max_samples + 1, b)),
                            width, seed=1000)
            wf = torch.from_numpy(buf).to(dev)
            lt = torch.from_numpy(ln).to(dev)
            iters = 20 if b <= 256 else 5
            timed(timings, spreads, f"k1_b{b}",
                  lambda: fk.frontend_conv1(wf, lt, fe, c1w, c1b), iters)
            timings[f"k1_plain_b{b}"] = cuda_ms(
                lambda: fk._frontend_conv1_plain(wf, lt, fe, c1w, c1b), iters)
            n_frames = int((1 + lt.long() // cfg.hop_length).sum())
            bounds[f"k1_b{b}"] = least_ms(
                {"fp32": n_frames * FRONTEND_FRAME_FLOPS,
                 "bf16": b * 2.0 * 9 * 32 * 64 * 200},
                nbytes(wf, lt) + b * 100 * 1024 * 2)
            del wf, buf
            gx, w, bn = k2_inputs(b, torch.bfloat16, dev, seed=b)
            timed(timings, spreads, f"k2_b{b}",
                  lambda: gru_layer(gx, w, bn), 20)
            bounds[f"k2_b{b}"] = least_ms(
                {"bf16": 2.0 * gx.numel() * 256},
                nbytes(gx, w, bn) + gx.numel() // 3 * 2)
            log(f"K2 at B={b} launches "
                f"{plan_name(None, b, torch.bfloat16, dev)} ({sms} SMs)")
            for rows in gru_variants(torch.bfloat16)[1:]:
                timed(timings, spreads, f"k2_b{b}_{plan_key(rows)}",
                      lambda: gru_layer(gx, w, bn, rows=rows), 20)
            timings[f"k2_plain_b{b}"] = cuda_ms(
                lambda: _gru_layer_plain(gx, w, bn), 5)
            # the yardstick: one cuDNN layer (its input product included),
            # weights flattened, eval mode, ten warm-up calls, the median
            # of five timed blocks.  In bf16, K2's type, torch does not
            # find the flattened weights and compacts them on every call
            # (it warns so), which makes the blocks spread; the same layer
            # in fp16 runs on the same tensor cores without that
            for dtype, key in ((torch.bfloat16, f"cudnn_gru_layer_b{b}"),
                               (torch.float16, f"cudnn_gru_layer_fp16_b{b}")):
                cudnn = torch.nn.GRU(1024, 256, num_layers=1, batch_first=True,
                                     bidirectional=True, device=dev,
                                     dtype=dtype).eval()
                cudnn.flatten_parameters()
                x = torch.randn((b, 25, 1024), device=dev, dtype=dtype)
                with torch.inference_mode():
                    timed(timings, spreads, key, lambda: cudnn(x), 20)

        # the model's own conv2 / conv3 with torch's epilogues, the library
        # route K5 stands beside
        variant = CNNAudioGRU(num_classes=31, compute_dtype=torch.bfloat16,
                              fold_bn=True, conv1_external=True)
        variant.load_state_dict(conv1_external_params(
            fold_batchnorm(state))[0])
        time_new_kernels(dev, variant.to(dev).eval(), timings, bounds,
                         spreads)

    # ---- 13. a train step card vs CPU ----
    check_train_step(dev)

    # ---- 14. timings of the training path's kernels and step ----
    for b in (256, 2048):
        buf, ln = batch(list(rng.integers(1, PRECOMPUTE_WIDTH + 1, b)),
                        PRECOMPUTE_WIDTH, seed=4000)
        wf = torch.from_numpy(buf).to(dev)
        lt = torch.from_numpy(ln).to(dev)
        fe_dev = make_frontend_params(device=dev)
        iters = 20 if b <= 256 else 5
        timed(timings, spreads, f"k3_b{b}",
              lambda: fk.frontend(wf, lt, fe_dev), iters)
        timings[f"k3_plain_b{b}"] = cuda_ms(
            lambda: log_mel_frontend_plain(wf, lt, fe_dev), iters)
        # the library route on the same rows: torch.fft.rfft + matmul on
        # their frames (framed beforehand, as for K4; the normalization
        # and the mel-major layout left out)
        frames = _frames(wf, lt.long(), 1024, 512)

        def rfft_matmul():
            spec = torch.fft.rfft(frames * fe_dev.window, dim=-1)
            power = spec.real.square() + spec.imag.square()
            return 10.0 * torch.log10((power @ fe_dev.mel_fb).clamp(
                min=1e-10))

        timings[f"k3_library_b{b}"] = cuda_ms(rfft_matmul, iters)
        del frames
        n_frames = int((1 + lt.long() // 512).sum())
        bounds[f"k3_b{b}"] = least_ms(
            {"fp32": n_frames * FRONTEND_FRAME_FLOPS},
            nbytes(wf, lt) + b * 64 * 200 * 4)
        del wf, buf
    for b in (256, 1024):
        gx, w, bn, ys, dys = k2t_inputs(b, torch.bfloat16, dev, seed=b)
        log(f"K2T at B={b} launches "
            f"{plan_name(None, b, torch.bfloat16, dev, True)} ({sms} SMs)")
        timed(timings, spreads, f"k2t_b{b}",
              lambda: gru_layer_backward(gx, w, bn, ys, dys), 10)
        # reads gx, W, ys, dys; writes dgx, fp32 dW and db; recomputes the
        # forward's product and takes two more (dh and dW)
        bounds[f"k2t_b{b}"] = least_ms(
            {"bf16": 3 * 2.0 * gx.numel() * 256},
            nbytes(gx, gx, w, bn, ys, dys) + w.numel() * 4)
        for rows in gru_variants(torch.bfloat16, backward=True)[1:]:
            timed(timings, spreads, f"k2t_b{b}_{plan_key(rows)}",
                  lambda: gru_layer_backward(gx, w, bn, ys, dys, rows=rows),
                  10)
        timings[f"k2t_plain_b{b}"] = cuda_ms(
            lambda: _gru_layer_backward_plain(gx, w, bn, ys, dys), 5)
        leaves = [t.clone().requires_grad_() for t in (gx, w, bn)]

        def autograd_plain():
            return torch.autograd.grad(_gru_layer_plain(*leaves), leaves, dys)

        timings[f"k2t_autograd_plain_b{b}"] = cuda_ms(autograd_plain, 5)
        # the library call: cuDNN's bf16 GRU backward (input, weights)
        timed(timings, spreads, f"cudnn_gru_backward_b{b}",
              cudnn_backward(dev, b, torch.bfloat16), 10)
    time_fp32_k2t(dev, timings, bounds, spreads)
    for b in (16, 256, 1024):
        step = train_step_timer(dev, b)
        timings[f"train_step_bf16_b{b}"] = cuda_ms(step, 10)
        del step
    fp32_steps = compare_fp32_k2t_steps(dev)

    # ---- 15. training end to end through the CLIs ----
    # ---- 16. streaming and serving on the trained model ----
    # ---- 17. run_pipeline: waveform-resident training, augmentation on ----
    with tempfile.TemporaryDirectory() as tmp:
        e2e_train = train_end_to_end(tmp, dev)
        t0 = time.perf_counter()
        stream = check_streaming(dev, tmp, e2e_train, timings, bounds,
                                 spreads)
        stream_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipeline = check_pipeline(dev, tmp, e2e_train, timings, spreads)
        pipeline_s = time.perf_counter() - t0
        # ---- 18. serving artifacts of the trained model ----
        t0 = time.perf_counter()
        exported = check_export(dev, tmp, e2e_train, label)
        export_phase_s = time.perf_counter() - t0
        # ---- 19. the wav2vec family at full width ----
        wav2vec = check_wav2vec(dev, tmp, e2e_train)
        # ---- 20. the TTS corpus, the synthetic A/B corpus, the librosa
        # mode, device prefetch, tracing, the diagnostics ----
        with tempfile.TemporaryDirectory() as tmp20:
            synthetic = check_synthetic(dev, tmp20, label)
        # ---- 21. data-parallel training, evaluation and serving, on
        # phase 15's corpus and model; after 20, whose trace once lost K1's
        # record when it ran after this phase ----
        distributed = check_distributed(dev, tmp, e2e_train, timings)
        # ---- 22. tensor parallelism: the dp1 x tp2 and dp2 x tp2 grids ----
        tensor_parallel = check_tensor_parallel(dev)
    syn, hold = synthetic["synthetic"], synthetic["holdout"]

    log(f"timing on {label} (CUDA events, ms per call):")
    for k, v in timings.items():
        log(f"  {k}: {v:.4f}")
    for k, (ms_bound, by) in bounds.items():
        log(f"  bound {k}: {ms_bound:.4f} ({by})")
    log("  least / median / most of five timed blocks after ten warm-up "
        "calls (the median is the time above):")
    for k, (lo, med, hi) in spreads.items():
        log(f"    {k}: {lo:.4f} / {med:.4f} / {hi:.4f}")
    log(f"  precompute CLI, {sum(CORPUS.values())} WAVs of 1-5 s (decode "
        f"included): {e2e_train['precompute_utt_s']:.1f} utt/s; tone task "
        f"val acc {e2e_train['val_acc']:.4f} after {e2e_train['epochs']} "
        f"epochs, test acc {e2e_train['test_acc']:.4f}")
    log(f"  streaming on {label}, host clock, ms (phase 16 took "
        f"{stream_s:.1f} s):")
    for mode, m in stream["modes"].items():
        log(f"    {mode}: end of speech -> result dict at B=1, p50 "
            f"{percentile_ms(m['latency_s'], 50):.3f} / p90 "
            f"{percentile_ms(m['latency_s'], 90):.3f} over "
            f"{len(m['latency_s'])} utterances; feed of one "
            f"{STREAM_CHUNK}-sample chunk while recording p50 "
            f"{percentile_ms(m['feed_s'], 50):.4f} / p90 "
            f"{percentile_ms(m['feed_s'], 90):.4f} over {len(m['feed_s'])}; "
            f"streamed accuracy {m['acc']:.4f}; card vs CPU prob err "
            f"{m['cpu_err']:.3e}; launches {m['launches']}")
    for n, samples in stream["batched"]["times_s"].items():
        log(f"    finalize of {n} queued session(s), flush to result dicts: "
            f"p50 {percentile_ms(samples, 50):.3f} / p90 "
            f"{percentile_ms(samples, 90):.3f} over {len(samples)}")
    plans = stream["plans"]
    log(f"    the fp32 K2 of the streaming path, cluster kernel (picked) vs "
        f"the CUDA-core kernel forced, in turns in this run on {label}, "
        f"host clock, ms p50 / p90:")
    for mode, lat in plans["eos"].items():
        log(f"      {mode}: end of speech -> result at B=1, "
            + "; ".join(f"{k} {percentile_ms(v, 50):.3f} / "
                        f"{percentile_ms(v, 90):.3f}" for k, v in lat.items())
            + f" over {len(lat['cluster'])} utterances each")
    for n, fin in plans["finalize"].items():
        log(f"      finalize of {n} queued session(s): "
            + "; ".join(f"{k} {percentile_ms(v, 50):.3f} / "
                        f"{percentile_ms(v, 90):.3f}" for k, v in fin.items())
            + f" over {len(fin['cluster'])} each")
    for b in FP32_K2_BATCHES:
        log(f"    fp32 K2 at B={b}, T=25, ms a layer (median of five blocks; "
            f"the kernel alone, then the wrapper's call) on {label}: "
            f"{plan_name(None, b, torch.float32, dev)} "
            f"{timings[f'k2_fp32_kernel_b{b}']:.4f} / "
            f"{timings[f'k2_fp32_b{b}']:.4f}, CUDA-core kernel "
            f"({plan_key(Plan('simt', tile_rows(b, sms)))}) "
            f"{timings[f'k2_fp32_simt_kernel_b{b}']:.4f} / "
            f"{timings[f'k2_fp32_simt_b{b}']:.4f}, cuDNN fp32 nn.GRU layer "
            f"with its input product, TF32 off "
            f"{timings[f'cudnn_gru_layer_fp32_b{b}']:.4f} (with TF32, not "
            f"fp32-equal: {timings[f'cudnn_gru_layer_tf32_b{b}']:.4f}; "
            f"a one-wide input, the recurrence alone, TF32 off: "
            f"{timings[f'cudnn_gru_layer_fp32_narrow_b{b}']:.4f}), "
            f"plain {timings[f'k2_fp32_plain_b{b}']:.4f}; bound "
            f"{bounds[f'k2_fp32_b{b}'][0]:.4f} "
            f"({bounds[f'k2_fp32_b{b}'][1]})")
    replay = stream["replay"]
    log(f"    file replay of {STREAM_SESSIONS} WAVs (digital silence): card vs "
        f"CPU confidence err {replay['cpu_err']:.3e}; label equal to "
        f"predict_file's on {replay['agree']}; launches {replay['launches']}")
    log(f"  run_pipeline on {label}, waveform mode, augmentation on (phase "
        f"17 took {pipeline_s:.1f} s; run_pipeline {pipeline['seconds']:.1f} "
        f"s: " + ", ".join(f"{k} {v:.1f} s"
                           for k, v in pipeline["stages"].items())
        + f"): val acc {pipeline['val_acc']:.4f} after {pipeline['epochs']} "
        f"epochs, test acc {pipeline['test_acc']:.4f}; launches "
        f"{pipeline['launches']}")
    for wb in WAVE_STEP_BATCHES:
        rest = (timings[f"wave_step_bf16_b{wb}"]
                - timings[f"wave_step_augment_b{wb}"]
                - timings[f"wave_step_k3_b{wb}"])
        log(f"    B={wb}: bf16 waveform step (augmentation on) "
            f"{timings[f'wave_step_bf16_b{wb}']:.3f} ms CUDA events / "
            f"{timings[f'wave_step_bf16_b{wb}_host']:.3f} ms host clock; "
            f"feature-cache step {timings[f'feature_step_bf16_b{wb}']:.3f} "
            f"/ {timings[f'feature_step_bf16_b{wb}_host']:.3f}; of the "
            f"waveform step: augmentation (gather + scale + augment) "
            f"{timings[f'wave_step_augment_b{wb}']:.3f}, K3 "
            f"{timings[f'wave_step_k3_b{wb}']:.3f}, the rest "
            f"{rest:.3f}")
    for fb in FP32_K2T_BATCHES:
        log(f"    fp32 K2T at B={fb}, T=25, ms a layer (median of five "
            f"blocks; the kernel alone, then gru_layer_backward's call) on "
            f"{label}: {plan_name(None, fb, torch.float32, dev, True)} "
            f"{timings[f'k2t_fp32_kernel_b{fb}']:.4f} / "
            f"{timings[f'k2t_fp32_b{fb}']:.4f}, CUDA-core kernel "
            f"{timings[f'k2t_fp32_simt_kernel_b{fb}']:.4f} / "
            f"{timings[f'k2t_fp32_simt_b{fb}']:.4f}, cuDNN fp32 backward "
            f"(one-wide input, TF32 off) "
            f"{timings[f'cudnn_gru_backward_fp32_b{fb}']:.4f}, plain "
            f"{timings[f'k2t_fp32_plain_b{fb}']:.4f}; bound kernel "
            f"{bounds[f'k2t_fp32_kernel_b{fb}'][0]:.4f} "
            f"({bounds[f'k2t_fp32_kernel_b{fb}'][1]}), with dW "
            f"{bounds[f'k2t_fp32_b{fb}'][0]:.4f}")
    for sb, t in fp32_steps.items():
        log(f"    fp32 train step B={sb} (host clock, mean of "
            f"{FP32_STEP_ROUNDS} rounds of A B B A): cluster K2T "
            f"{np.mean(t['cluster']):.4f} ms, CUDA-core K2T "
            f"{np.mean(t['simt']):.4f} ms")
    log(f"  serving artifacts on {label} (phase 18 took "
        f"{export_phase_s:.1f} s): launches per program call "
        f"{exported['launches']}")
    b = MAIN_BATCH

    def entry(name, key, source, replaces, err, library=None, **launches):
        ms_bound, by = bounds[f"{key}_b{b}"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, **launches, "max_abs_err": err,
                "ms": timings[f"{key}_b{b}"],
                "plain_ms": timings[f"{key}_plain_b{b}"],
                "bound_ms": ms_bound, "bound_by": by,
                "library_ms": None if library is None else timings[library]}

    log(f"kernels at B={b} on {label}: launches on each kernel's path, error "
        f"vs its plain version (phase 2; K7's dy, phase 6), ms per call; "
        f"library_ms: cuDNN nn.GRU layer "
        f"(K2), its backward with a one-wide input (K2T), torch.fft.rfft + "
        f"matmul on the frames (K3, K4), the model's conv stages 2 and 3 "
        f"(K5), bias-add + ReLU + max-pool at conv2 (K6); K7 at B=1024: "
        f"train-mode BatchNorm + ReLU + cast + max-pool and its backward")
    # launches on the streaming path: over the test split in each featurizer
    # mode, in the batched finalize of 16 and in the file replay of 16
    stream_launches = {
        kernel: {**{mode: m["launches"][kernel]
                    for mode, m in stream["modes"].items()},
                 f"batched_{STREAM_SESSIONS}":
                     stream["batched"]["launches"][kernel],
                 f"replay_{STREAM_SESSIONS}": stream["replay"]["launches"][kernel]}
        for kernel in ("K2", "K4", "K2_cluster")}
    ke, ml = kernel_errs, main_launches
    kernels = [
        entry("frontend_conv1", "k1", K1_SOURCE, K1_REPLACES, ke["K1"],
              launches=ml["K1"]),
        entry("gru_layer", "k2", K2_SOURCE, K2_REPLACES, ke["K2"],
              f"cudnn_gru_layer_b{b}", launches=ml["K2"]),
        entry("frontend", "k3", K3_SOURCE, K3_REPLACES, ke["K3"],
              f"k3_library_b{b}", launches=e2e_train["k3_launches"]),
        entry("gru_layer_backward", "k2t", K2T_SOURCE, K2T_REPLACES,
              max(v for k, v in ke.items() if k.startswith("K2T")),
              f"cudnn_gru_backward_b{b}",
              launches=e2e_train["k2t_launches"]),
        entry("mel_db", "k4", K4_SOURCE, K4_REPLACES, ke["K4"],
              f"k4_library_b{b}", launches=hop256_launches["K4"]),
        entry("conv23", "k5", K5_SOURCE, K5_REPLACES, ke["K5"],
              f"k5_library_b{b}", launches=ml["K5"]),
        entry("bias_relu_pool2", "k6", K6_SOURCE, K6_REPLACES, ke["K6"],
              f"k6_library_b{b}", launches=ml["K6"]),
    ]
    # the training path's entry to K2 against its plain version (phase 2)
    kernels[1]["contract_max_abs_err"] = ke["K2 contract"]
    kernels[1]["stream_launches"] = stream_launches["K2"]
    # of those, launches of the fp32 cluster kernel (K2's fp32 build at
    # hidden 256, which the streaming path runs)
    kernels[1]["stream_launches_cluster"] = stream_launches["K2_cluster"]
    kernels[4]["stream_launches"] = stream_launches["K4"]
    # launches on the waveform-resident path (phase 17's run_pipeline)
    for i, key in ((1, "K2"), (2, "K3"), (3, "K2T")):
        kernels[i]["waveform_launches"] = pipeline["launches"][key]
    # launches through the serving artifacts (phase 18): per program call,
    # per finalize of the streaming artifact
    # launches on phase 20's paths: the synthetic corpus's run_pipeline and
    # the TTS holdout on the card
    for i, key in ((1, "K2"), (2, "K3"), (3, "K2T")):
        kernels[i]["synthetic_launches"] = syn["launches"][key]
    for i, key in ((0, "K1"), (1, "K2")):
        kernels[i]["tts_launches"] = hold["launches"][key]
    # launches on phase 21's data-parallel paths: cli.train with a
    # coordinator, each process of the two-process dry run (its steps and
    # its serving mesh) and the serving mesh of two
    dl = distributed["launches"]
    for i, key in ((0, "K1"), (1, "K2"), (2, "K3"), (3, "K2T")):
        kernels[i]["distributed_launches"] = {
            **{f"cli_train_{m}_world1": dl[f"cli_train_{m}"][key]
               for m in ("feature", "waveform")},
            **{f"dryrun_{proc}_{part}": got[key]
               for proc, parts in dl["dryrun"].items()
               for part, got in parts.items()},
            "serving_mesh_2": dl["serving_mesh"][key]}
    # launches on phase 22's grids: each process of each dry run (its steps,
    # evaluations and, on process 0, its serving mesh)
    tl = tensor_parallel["launches"]
    for i, key in ((0, "K1"), (1, "K2"), (2, "K3"), (3, "K2T")):
        kernels[i]["tensor_parallel_launches"] = {
            f"{grid}_{proc}_{part}": got[key]
            for grid, procs in tl.items()
            for proc, parts in procs.items()
            for part, got in parts.items()}
    # the fp32 cluster backward (K2T's fp32 build at hidden 256): its
    # launches on the fp32 training paths (phase 20h; the fp32 steps of
    # phases 21 and 22), its times against the CUDA-core K2T, cuDNN's fp32
    # backward and the plain version, bounds
    kernels[3]["control_a_launches"] = synthetic["control_a"]["launches"][
        "K2T"]
    kernels[3]["fp32"] = {
        "route": "cuda", "source": K2T_SOURCE, "replaces": K2T_REPLACES,
        "launches_cluster": {
            "control_a": synthetic["control_a"]["launches"]["K2T_cluster"],
            **{f"cli_train_{m}_world1": dl[f"cli_train_{m}"]["K2T_cluster"]
               for m in ("feature", "waveform")},
            **{f"dryrun_{proc}_{part}": got["K2T_cluster"]
               for proc, parts in dl["dryrun"].items()
               for part, got in parts.items()},
            **{f"{grid}_{proc}_{part}": got["K2T_cluster"]
               for grid, procs in tl.items()
               for proc, parts in procs.items()
               for part, got in parts.items()}},
        **{f"b{fb}": {
            "ms": timings[f"k2t_fp32_kernel_b{fb}"],
            "wrapper_ms": timings[f"k2t_fp32_b{fb}"],
            "simt_ms": timings[f"k2t_fp32_simt_kernel_b{fb}"],
            "simt_wrapper_ms": timings[f"k2t_fp32_simt_b{fb}"],
            "plain_ms": timings[f"k2t_fp32_plain_b{fb}"],
            "bound_ms": bounds[f"k2t_fp32_kernel_b{fb}"][0],
            "bound_by": bounds[f"k2t_fp32_kernel_b{fb}"][1],
            "wrapper_bound_ms": bounds[f"k2t_fp32_b{fb}"][0],
            "library_ms": timings[f"cudnn_gru_backward_fp32_b{fb}"]}
           for fb in FP32_K2T_BATCHES},
        "train_step_fp32_host_ms": {
            f"b{sb}": {k: float(np.mean(v)) for k, v in t.items()}
            for sb, t in fp32_steps.items()}}
    for entry_, key in zip(kernels, ("K1", "K2", "K3", "K2T", "K4", "K5",
                                     "K6")):
        entry_["artifact_launches"] = {
            name: got[key] for name, got in exported["launches"].items()
            if key in got}
    # K7 at the train step's three conv outputs (B=1024): each pass beside
    # the torch chain it replaces (library_ms) and the plain version
    kt, kb = k7["timings"], k7["bounds"]
    kernels.append({
        "name": "bn_relu_pool2_train", "route": "cuda", "source": K7_SOURCE,
        "replaces": K7_REPLACES, "resources": k7["resources"],
        "max_abs_err": k7["errs"],
        **{f"{key[3:]}_{part}": {
            "ms": kt[f"{key}_{part}"], "plain_ms": kt[f"{key}_{part}_plain"],
            "bound_ms": kb[f"{key}_{part}"][0],
            "bound_by": kb[f"{key}_{part}"][1],
            "library_ms": kt[f"{key}_{part}_library"]}
           for key in (f"k7_c{c}_b{K7_BATCH}" for c, _h, _w in K7_STAGES)
           for part in ("forward", "backward")}})
    log(f"  wav2vec (phase 19 took {wav2vec['seconds']:.1f} s) on {label}, "
        f"TF32 off; ms: CUDA events, median of five blocks (least / most), "
        f"host clock median of five blocks (most); bound: the operations "
        f"over the peak of their type:")
    for key, c in wav2vec["cells"].items():
        log(f"    {key}: {c['ms']:.3f} ms ({c['ms_least']:.3f} / "
            f"{c['ms_most']:.3f}), host {c['host_ms']:.3f} ("
            f"{c['host_ms_most']:.3f}); {c['gflop']:.1f} GFLOP, bound "
            f"{c['bound_ms']:.3f} ms ({c['bound_by']})")
    log(f"  phase 20 on {label} took {synthetic['seconds']:.1f} s: "
        f"make_ab_corpus (304 WAVs + golden features) {syn['corpus_s']:.1f} "
        f"s; synthetic_e2e run_pipeline {syn['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in syn["stages"].items())
        + f"), val acc {syn['val_acc']:.4f}, test acc {syn['accuracy']:.4f} "
        f"after {syn['epochs']} epochs, launches {syn['launches']}; TTS "
        f"holdout accuracy {hold['accuracy']:.4f} (card {hold['card_s']:.1f} "
        f"s, CPU {hold['cpu_s']:.1f} s), launches {hold['launches']}; "
        f"librosa mode launches {synthetic['librosa']['launches']}; "
        f"epoch seconds {synthetic['prefetch']['seconds']}; stress "
        f"test {synthetic['stress']['tflops']:.1f} TFLOP/s (bf16 4096^2)")
    log(f"  phase 21 on {label} took {distributed['seconds']:.1f} s "
        f"(dry run {distributed['dryrun_s']:.1f} s): cli.train with a "
        f"coordinator (world 1, NCCL) vs without, fp32: "
        + "; ".join(f"{m} loss err {distributed[f'cli_{m}']['loss_err']:.2e}"
                    ", after each step weights more than lr / 2 apart "
                    + ", ".join(f"{s['apart']}" for s in
                                distributed[f"cli_{m}"]["steps"])
                    + ", BatchNorm statistics err "
                    + ", ".join(f"{s['bn_err']:.2e}" for s in
                                distributed[f"cli_{m}"]["steps"])
                    for m in ("feature", "waveform"))
        + f"; serving mesh vs meshless prob err "
        f"{distributed['serving_err']:.2e}")
    for mode, b, iters in DP_TIMED:
        one = timings[f"{mode}_step_bf16_b{b}_one"]
        dp1 = timings[f"{mode}_step_bf16_b{b}_dp1"]
        costs = distributed[f"{mode}_b{b}_dp1_cost"]
        log(f"    bf16 {mode} step B={b} (both sides' conv epilogues the "
            f"torch chain), CUDA events, {DP_ABBA} blocks of "
            f"A B B A x {iters} steps: one process {one:.4f} ms, "
            f"data-parallel at world 1 (NCCL) {dp1:.4f} ms "
            f"({100 * (dp1 / one - 1):+.2f} %); a block's cost "
            f"{min(costs):+.2%} to {max(costs):+.2%}")
    d512, d1024 = (timings["augment_draws_b512"],
                   timings["augment_draws_b1024"])
    w512 = timings["waveform_step_bf16_b512_one"]
    log(f"    the waveform augmentation's draws (9 uniforms a row and the "
        f"(B, 80000) normals): B=512 {d512:.4f} ms, B=1024 {d1024:.4f} ms; "
        f"a process of a two-process step at global B=1024 draws the 1024 "
        f"rows' {d1024:.4f} ms against its own 512's {d512:.4f}: "
        f"+{d1024 - d512:.4f} ms, {100 * (d1024 - d512) / w512:.2f} % of the "
        f"one-process B=512 step ({w512:.4f} ms)")
    for part, got in distributed["dryrun"].items():
        log(f"    dry run (correctness run: two processes share one card "
            f"over gloo; not a multi-GPU rate) {part}: "
            + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                        else f"{k} {v}" for k, v in got.items()
                        if k != "grad_errs"))
        if "grad_errs" in got:
            log("      each gradient's error over its leaf's scale: "
                + ", ".join(f"{k} {v:.2e}"
                            for k, v in got["grad_errs"].items()))
    log(f"  phase 22 on {label} took {tensor_parallel['seconds']:.1f} s "
        f"(a correctness run: the processes of each grid share one card "
        f"over gloo; not a multi-GPU rate):")
    for grid, run22 in tensor_parallel["runs"].items():
        log(f"    {grid}: {run22['seconds']:.1f} s")
        for part, got in run22["parts"].items():
            log(f"      {part}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in got.items()
                if k not in ("grad_errs", "grad_l2_errs", "bytes")))
            if "grad_errs" in got:
                log("        each gradient's error over its leaf's scale: "
                    + ", ".join(f"{k} {v:.2e}"
                                for k, v in got["grad_errs"].items()))
        for proc, parts in run22["bytes"].items():
            log(f"      {proc} bytes (this process / the whole model): "
                + "; ".join(
                    f"{part} split leaves {b['split']} / {b['split_full']}, "
                    f"their Adam moments {b['adam_split']} / "
                    f"{b['adam_split_full']}, all parameters {b['params']} "
                    f"/ {b['params_full']}" for part, b in parts.items()))
    print(json.dumps({"wav2vec": wav2vec, "device": label}, default=float))
    print(json.dumps({"kernels": kernels}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
