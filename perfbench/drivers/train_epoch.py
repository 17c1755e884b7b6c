"""Training: ``Trainer.train_epoch`` on cached features, on the recipe the
traffic file copies from one of the repository's ``configs/*.yaml``
(``recipe``: batch, bf16, Adam with L2 and its learning-rate schedule,
clip, SpecAugment, dropout).

Set-up draws the weights, builds the model, the optimizer and the trainer
as the training command does (``compute_dtype`` bf16,
``optimizer_from_config`` over ``rows`` rows), and puts the cached
feature set on the device: ``rows`` rows
of (n_mels, mel_spec_length) float32 drawn N(0, 1), as normalised
log-mels are, labels uniform over the classes, and a permutation of the
rows from the seed.  The first ``checked_steps`` steps go through
``train_epoch`` one call each, on the permutation's first rows, with the
generator that draws SpecAugment's and dropout's numbers; the loss and
logits of each, Adam's first moment after the first and the parameters
after the last are kept for the check.  The window hands the same trainer the
permutation's next rows, ``steps_per_call`` steps a call (each call ends
in the copy of its metrics to the host), until ``seconds`` have passed.

After the window the reference (``reference/<config>.py``) runs the same
steps from the same weights, rows and generator state in float32, and
three numbers are compared, each by the worst of its parts:

* ``loss_gap``: each step's loss, |program - reference| / |reference|;
* ``logits_gap``: each step's logits (the model's output inside the
  step, read by a forward hook), the widest gap of their log-softmax;
* ``grad_gap``: each leaf's first gradient as Adam took it (clipped,
  weight decay added; the program's read from its first moment, m / (1 -
  beta1)), | |program| - |reference| | over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: each leaf's change over the checked steps, measured so.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's (the attention score's bias, which the softmax over time cancels)
move by round-off alone and are left out of both leaf numbers.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from core import compare, trace, traffic as gen, weights

BETA1 = 0.9


class Driver:
    def __init__(self, cfg: dict, traffic: dict, reference, seed: int,
                 device="cuda"):
        from speech_intent_recognizer_tpu_torch.config import Config
        from speech_intent_recognizer_tpu_torch.models.cnn_gru import (
            CNNAudioGRU)
        from speech_intent_recognizer_tpu_torch.train.loop import Trainer
        from speech_intent_recognizer_tpu_torch.train.state import (
            optimizer_from_config)

        self.cfg, self.traffic, self.reference = cfg, traffic, reference
        self.device = dev = torch.device(device)
        self.recipe = traffic["recipe"]
        self.config = Config.from_dict(self.recipe)
        self.precision = cfg["precision"]["train"]
        self.batch = self.config.train.batch_size
        self.state = weights.make_state(
            reference.weight_spec(cfg), gen.device_generator(seed, dev, 0),
            dev)
        model = CNNAudioGRU(
            cfg["num_classes"], conv_channels=cfg["conv_channels"],
            gru_hidden=cfg["gru_hidden"], gru_layers=cfg["gru_layers"],
            dropout=cfg["dropout"], n_mels=cfg["n_mels"],
            compute_dtype=(torch.bfloat16 if self.config.train.bf16
                           else torch.float32)).to(dev)
        model.load_state_dict(self.state)
        self.trainer = Trainer(model, self.config, optimizer_from_config(
            self.config, model.parameters(), traffic["rows"]))
        g = gen.device_generator(seed, dev, 4)
        rows, n_mels, t = traffic["rows"], cfg["n_mels"], cfg["mel_spec_length"]
        self.features = torch.randn((rows, n_mels, t), generator=g,
                                    device=dev)
        self.labels = torch.randint(0, cfg["num_classes"], (rows,),
                                    generator=g, device=dev)
        steps = rows // self.batch
        self.perm = torch.randperm(rows, generator=g, device=dev)[
            :steps * self.batch].view(steps, self.batch)
        self.weights = torch.ones((steps, self.batch), device=dev)
        self.draws = gen.device_generator(seed, dev, 5)
        self.draws_at_start = self.draws.get_state()
        self.losses, self.logits, self.grad1 = [], [], None
        keep = model.register_forward_hook(
            lambda _m, _a, out: self.logits.append(out.detach().float()))
        for s in range(traffic["checked_steps"]):
            self.losses.append(self._steps(s, 1)["loss"])
            if s == 0:
                self.grad1 = {n: m.detach().clone() / (1 - BETA1)
                              for n, m in self._moments()}
        keep.remove()
        self.after = {n: p.detach().clone()
                      for n, p in self.trainer.model.named_parameters()}
        self.next = traffic["checked_steps"]

    def _moments(self):
        """Adam's first moment of each leaf (zero where the optimizer
        never updated it)."""
        opt = self.trainer.optimizer
        return [(n, (opt.moments(p) or [torch.zeros_like(p)])[0])
                for n, p in self.trainer.model.named_parameters()]

    def _steps(self, first: int, count: int) -> dict:
        rows = slice(first, first + count)
        return self.trainer.train_epoch(self.features, self.labels,
                                        self.perm[rows], self.weights[rows],
                                        self.draws)

    def _block(self) -> int:
        """The next ``steps_per_call`` rows of the permutation, from its
        start again once it runs out."""
        k = self.traffic["steps_per_call"]
        if self.next + k > self.perm.shape[0]:
            self.next = 0
        first, self.next = self.next, self.next + k
        self._steps(first, k)
        return k * self.batch

    # ------------------------------------------------------------ window

    def window(self, seconds: float, profiler=None) -> dict:
        calls, spans, t0 = [], [], time.perf_counter()
        while True:
            start = time.perf_counter()
            calls.append(self._block())
            spans.append((start, time.perf_counter()))
            if spans[-1][1] - t0 >= seconds:
                break
        wall = spans[-1][1] - t0
        rows = sum(calls)
        out = {"start": t0, "attempted": rows, "failed": 0, "seconds": wall,
               "calls": calls, "call_spans": spans,
               "metrics": {"train_utt_per_s": rows / wall}}
        if profiler is not None:
            out.update(self._slice(profiler))
        return out

    def _slice(self, profiler) -> dict:
        """``slice_calls`` more calls under the profiler: the GRU's forward
        and backward, and the optimizer's step, in spans of their own."""
        model, opt = self.trainer.model, self.trainer.optimizer
        step = opt.step

        def traced_step():
            with torch.profiler.record_function("Optimizer.step"):
                step()

        opt.step = traced_step
        calls = []
        try:
            with trace.SpanHooks([(model.gru, "TorchGRU")],
                                 backward=[(model.gru, "TorchGRU.backward")]):
                profiler.start()
                for _ in range(self.traffic["slice_calls"]):
                    calls.append(self._block())
                result = profiler.stop()
        finally:
            del opt.step
        return {"trace": result, "slice": {"calls": calls}}

    def layer_work(self, work, rows: int) -> dict:
        return work.train_layers(self.cfg, self.precision, rows)

    def call_flops(self, work, rows: int) -> dict:
        return work.train_layers(self.cfg, self.precision, rows)["model"][
            "flops"]

    # ------------------------------------------------------------- check

    def free(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, precision: str) -> dict:
        g = torch.Generator(device=self.device)
        g.set_state(self.draws_at_start)
        batches = [(self.features[self.perm[s]], self.labels[self.perm[s]])
                   for s in range(self.traffic["checked_steps"])]
        return self.reference.train_steps(self.state, self.cfg, self.recipe,
                                          self.traffic["rows"], batches, g,
                                          compare.CASTS[precision],
                                          compare.GRAD_CASTS[precision])

    def numbers(self, ref: dict, got: dict) -> list:
        """[(name, value, limit)] of ``got`` (losses, grad, delta) against
        ``ref``."""
        lim = self.traffic["limits"]
        losses = np.abs(np.subtract(got["losses"], ref["losses"])) / np.abs(
            ref["losses"])
        norms = {k: float(v.norm()) for k, v in ref["grad"].items()}
        med = float(np.median(list(norms.values())))
        moved = [k for k, n in norms.items() if n >= 1e-3 * med]
        logp = max(compare.logp_gap(torch.softmax(a.double(), -1).cpu(),
                                    torch.softmax(b.double(), -1).cpu())
                   for a, b in zip(got["logits"], ref["logits"]))
        return [("loss_gap", float(losses.max()), lim["loss_gap"]),
                ("logits_gap", logp, lim["logits_gap"]),
                ("grad_gap", compare.leaf_gap(got["grad"], ref["grad"],
                                              moved), lim["grad_gap"]),
                ("change_gap", compare.leaf_gap(got["delta"], ref["delta"],
                                                moved), lim["change_gap"])]

    def program_numbers(self) -> dict:
        return {"losses": self.losses, "logits": self.logits,
                "grad": self.grad1,
                "delta": {k: self.after[k] - self.state[k].float()
                          for k in self.after}}

    def check(self) -> list:
        got = self.program_numbers()
        self.free()
        return self.numbers(self.reference_steps("fp32"), got)

    def control_check(self, precision: str) -> list:
        """``check``'s numbers with the reference at ``precision`` in the
        program's place."""
        self.free()
        return self.numbers(self.reference_steps("fp32"),
                            self.reference_steps(precision))
