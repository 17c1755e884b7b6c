"""Plain PyTorch reference of the CNN-GRU intent model: waveform to
probabilities, and the training recipe's step (below).

Written from the reference project's description (Speech-Intent-Recognizer
``models/models.py`` and its feature scripts): the torchaudio log-mel
front-end (periodic Hann window, centre reflect padding of each row's
``length`` samples, power spectrum, HTK filterbank without norm, dB with
``10 log10(max(p, 1e-10))``, per-utterance normalisation by the mean and
the unbiased standard deviation plus 1e-5 over the valid frames, padded
or cut to ``mel_spec_length`` frames), three stages of 3x3 convolution,
eval-mode BatchNorm, ReLU and 2x2 max-pool, the channel-major flatten, a
bidirectional GRU with PyTorch's cell, additive attention pooling over
time, the linear classifier and a softmax.

It reads the training-form state dict (``conv{i}.weight``, ``bn{i}.*``,
``gru.*``, ``attention.*``, ``fc.*``) and folds nothing.  The front-end is
computed in float64; every convolution and product takes its operands
through ``cast`` (``core.compare.CASTS``) and sums in float32.  It
imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def weight_spec(cfg: dict) -> list:
    """The training-form state dict this reference reads, as
    ``core.weights`` specifications: torch's default bounds
    U(+-1/sqrt(fan_in)) for convolutions, the GRU (1/sqrt(H)) and the
    linear layers, and BatchNorm with scale, shift and running statistics
    drawn near those of a trained model."""
    spec = []
    chans = [1] + list(cfg["conv_channels"])
    for i in range(1, len(chans)):
        cin, cout = chans[i - 1], chans[i]
        spec.append((f"conv{i}.weight", (cout, cin, 3, 3), "uniform",
                     -1 / math.sqrt(9 * cin), 1 / math.sqrt(9 * cin)))
        spec += [(f"bn{i}.weight", (cout,), "uniform", 0.8, 1.2),
                 (f"bn{i}.bias", (cout,), "uniform", -0.1, 0.1),
                 (f"bn{i}.running_mean", (cout,), "uniform", -0.1, 0.1),
                 (f"bn{i}.running_var", (cout,), "uniform", 0.5, 1.5),
                 (f"bn{i}.num_batches_tracked", (), "count", 0, 0)]
    h = cfg["gru_hidden"]
    feat = chans[-1] * (cfg["n_mels"] // 2 ** (len(chans) - 1))
    for layer in range(cfg["gru_layers"]):
        n_in = feat if layer == 0 else 2 * h
        for sfx in ("", "_reverse"):
            for name, shape in (("weight_ih", (3 * h, n_in)),
                                ("weight_hh", (3 * h, h)),
                                ("bias_ih", (3 * h,)), ("bias_hh", (3 * h,))):
                spec.append((f"gru.{name}_l{layer}{sfx}", shape, "uniform",
                             -1 / math.sqrt(h), 1 / math.sqrt(h)))
    for name, n_out in (("attention", 1), ("fc", cfg["num_classes"])):
        bound = 1 / math.sqrt(2 * h)
        spec += [(f"{name}.weight", (n_out, 2 * h), "uniform", -bound, bound),
                 (f"{name}.bias", (n_out,), "uniform", -bound, bound)]
    return spec


def mel_filterbank(cfg: dict, device) -> torch.Tensor:
    """(n_fft // 2 + 1, n_mels) float64 HTK triangles, no norm."""
    n_freqs = cfg["n_fft"] // 2 + 1
    sr = cfg["sample_rate"]
    pts = np.linspace(0.0, 2595.0 * np.log10(1.0 + (sr / 2.0) / 700.0),
                      cfg["n_mels"] + 2)
    hz = 700.0 * (10.0 ** (pts / 2595.0) - 1.0)
    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    slopes = hz[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / np.diff(hz)[:-1]
    up = slopes[:, 2:] / np.diff(hz)[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return torch.as_tensor(fb, dtype=torch.float64, device=device)


def log_mel(waveforms: torch.Tensor, lengths: torch.Tensor,
            cfg: dict) -> torch.Tensor:
    """(B, W) rows, valid to ``lengths`` -> (B, n_mels, mel_spec_length)
    float32 normalised features."""
    dev = waveforms.device
    n_fft, hop, tmax = cfg["n_fft"], cfg["hop_length"], cfg["mel_spec_length"]
    pad = n_fft // 2
    n = lengths.to(torch.int64)[:, None, None]
    frames = 1 + waveforms.shape[1] // hop
    pos = (hop * torch.arange(frames, device=dev)[:, None]
           + torch.arange(n_fft, device=dev)[None, :] - pad)[None]
    src = torch.where(pos < 0, -pos, torch.where(pos < n, pos,
                                                 2 * n - 2 - pos))
    src = src.clamp(min=0).expand(waveforms.shape[0], -1, -1)
    x = torch.gather(waveforms.double(), 1,
                     src.reshape(waveforms.shape[0], -1)).view(src.shape)
    k = torch.arange(n_fft, device=dev, dtype=torch.float64)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)
    spec = torch.fft.rfft(x * window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    db = 10.0 * torch.log10((power @ mel_filterbank(cfg, dev))
                            .clamp(min=1e-10))            # (B, T, M)
    valid = (torch.arange(frames, device=dev)[None, :]
             < (1 + lengths.to(torch.int64) // hop)[:, None])
    mask = valid[..., None].double()
    cnt = mask.sum(dim=(1, 2)) * cfg["n_mels"]
    mean = (db * mask).sum(dim=(1, 2)) / cnt
    var = ((db - mean[:, None, None]).square() * mask).sum(dim=(1, 2)) / (
        cnt - 1.0)
    feats = (db - mean[:, None, None]) / (var.sqrt()[:, None, None]
                                          + BN_EPS) * mask
    feats = feats.transpose(1, 2)                         # (B, M, T)
    if frames >= tmax:
        feats = feats[:, :, :tmax]
    else:
        feats = F.pad(feats, (0, tmax - frames))
    return feats.float()


def gru_layer(x: torch.Tensor, state: dict, layer: int, cast,
              out=lambda y: y) -> torch.Tensor:
    """One bidirectional layer, PyTorch's cell: (B, T, F) -> (B, T, 2H);
    ``out`` is applied to each product's result."""
    outs = []
    for sfx in ("", "_reverse"):
        w_ih = state[f"gru.weight_ih_l{layer}{sfx}"].float()
        w_hh = state[f"gru.weight_hh_l{layer}{sfx}"].float()
        b_ih = state[f"gru.bias_ih_l{layer}{sfx}"].float()
        b_hh = state[f"gru.bias_hh_l{layer}{sfx}"].float()
        hidden = w_hh.shape[1]
        gx = out(cast(x) @ cast(w_ih).T) + b_ih             # (B, T, 3H)
        h = x.new_zeros((x.shape[0], hidden))
        steps = range(x.shape[1])
        ys = [None] * x.shape[1]
        for t in (reversed(steps) if sfx else steps):
            gh = out(cast(h) @ cast(w_hh).T) + b_hh
            xr, xz, xn = gx[:, t].split(hidden, dim=1)
            hr, hz, hn = gh.split(hidden, dim=1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            cand = torch.tanh(xn + r * hn)
            h = (1.0 - z) * cand + z * h
            ys[t] = h
        outs.append(torch.stack(ys, dim=1))
    return torch.cat(outs, dim=-1)


def logits(state: dict, feats: torch.Tensor, cast) -> torch.Tensor:
    """(B, n_mels, T) features -> (B, C) float32 logits."""
    x = feats[:, None]
    i = 1
    while f"conv{i}.weight" in state:
        w = state[f"conv{i}.weight"].float()
        b = state.get(f"conv{i}.bias")
        x = F.conv2d(cast(x), cast(w), None if b is None else b.float(),
                     padding=1)
        mean = state[f"bn{i}.running_mean"].float()[:, None, None]
        var = state[f"bn{i}.running_var"].float()[:, None, None]
        gamma = state[f"bn{i}.weight"].float()[:, None, None]
        beta = state[f"bn{i}.bias"].float()[:, None, None]
        x = (x - mean) / torch.sqrt(var + BN_EPS) * gamma + beta
        x = F.max_pool2d(F.relu(x), 2)
        i += 1
    b, c, m, t = x.shape
    x = x.permute(0, 3, 1, 2).reshape(b, t, c * m)
    layer = 0
    while f"gru.weight_ih_l{layer}" in state:
        x = gru_layer(x, state, layer, cast)
        layer += 1
    scores = (cast(x) @ cast(state["attention.weight"].float()).T
              + state["attention.bias"].float())          # (B, T, 1)
    weights = torch.softmax(scores, dim=1)
    pooled = (x * weights).sum(dim=1)
    return (cast(pooled) @ cast(state["fc.weight"].float()).T
            + state["fc.bias"].float())


@torch.no_grad()
def probabilities(state: dict, cfg: dict, waveforms: torch.Tensor,
                  lengths: torch.Tensor, cast, block: int = 256
                  ) -> np.ndarray:
    """(B, W) float32 rows and (B,) lengths -> (B, C) float64
    probabilities, computed ``block`` rows at a time."""
    out = []
    for i in range(0, waveforms.shape[0], block):
        feats = log_mel(waveforms[i:i + block], lengths[i:i + block], cfg)
        z = logits(state, feats, cast)
        out.append(torch.softmax(z.double(), dim=-1).cpu().numpy())
    return np.concatenate(out)


# ---------------------------------------------------------------- training
#
# The reference recipe's step (Speech-Intent-Recognizer scripts/train.py,
# with the recipe of the traffic file): SpecAugment on the gathered
# features, the model in train mode (BatchNorm on the batch's statistics
# with the biased variance, dropout between the GRU layers), the mean
# cross-entropy, the gradients clipped to a global norm of grad_clip
# (scaled by clip / norm once the norm reaches it), L2 weight decay added,
# and Adam at the recipe's learning rate for the k-th update: constant, or
# a linear warmup from 0 over warmup_steps, then (cosine) a half cosine to
# 0 at epochs x ceil(rows / batch_size) updates.
# The random draws follow the program's order on one generator, frozen
# here: per step, SpecAugment's (7, B) uniforms, then the (B, T', 2H)
# uniforms of the dropout after the first GRU layer.

TRAINABLE = ("conv", "bn", "gru", "attention", "fc")


def trainable(state: dict) -> list:
    return [k for k in state if k.startswith(TRAINABLE)
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]


def spec_augment(x: torch.Tensor, g: torch.Generator, prob: float,
                 time_mask: int, freq_mask: int) -> torch.Tensor:
    """Per row, with probability ``prob``, a time and a frequency mask each
    with probability 0.5; width uniform in [0, param), start uniform in
    [0, size - width); masked bins 0."""
    b, n_mels, t = x.shape
    u = torch.rand((7, b), generator=g, device=x.device)
    outer = u[0] < prob
    tgate, fgate = outer & (u[1] < 0.5), outer & (u[2] < 0.5)
    tw = u[3] * float(time_mask)
    ts = u[4] * (float(t) - tw).clamp(min=0.0)
    fw = u[5] * float(freq_mask)
    fs = u[6] * (float(n_mels) - fw).clamp(min=0.0)

    def keep(width, start, size, gate):
        i = torch.arange(size, device=x.device, dtype=torch.float32)
        inside = (i[None, :] >= start[:, None]) & (
            i[None, :] < (start + width)[:, None])
        return ~(inside & gate[:, None])

    return (x * keep(tw, ts, t, tgate)[:, None, :].float()
            * keep(fw, fs, n_mels, fgate)[:, :, None].float())


def train_logits(params: dict, x: torch.Tensor, cast, g: torch.Generator,
                 dropout: float, out=lambda y: y) -> torch.Tensor:
    """(B, n_mels, T) features -> (B, C) logits in train mode; ``out`` is
    applied to each product's result."""
    x = x[:, None]
    i = 1
    while f"conv{i}.weight" in params:
        x = out(F.conv2d(cast(x), cast(params[f"conv{i}.weight"]),
                         padding=1))
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0,
                                   keepdim=True)
        x = ((x - mean) / torch.sqrt(var + BN_EPS)
             * params[f"bn{i}.weight"][:, None, None]
             + params[f"bn{i}.bias"][:, None, None])
        x = F.max_pool2d(F.relu(x), 2)
        i += 1
    b, c, m, t = x.shape
    x = x.permute(0, 3, 1, 2).reshape(b, t, c * m)
    layer = 0
    while f"gru.weight_ih_l{layer}" in params:
        x = gru_layer(x, params, layer, cast, out)
        if f"gru.weight_ih_l{layer + 1}" in params and dropout > 0:
            keep = torch.rand(x.shape, generator=g, device=x.device) >= dropout
            x = x * keep.float() / (1.0 - dropout)
        layer += 1
    scores = out(cast(x) @ cast(params["attention.weight"]).T) \
        + params["attention.bias"]
    pooled = (x * torch.softmax(scores, dim=1)).sum(dim=1)
    return out(cast(pooled) @ cast(params["fc.weight"]).T) + params["fc.bias"]


class _GradCast(torch.autograd.Function):
    """Identity forward; the gradient rounded by ``cast`` on its way back,
    as a product's backward takes it in a lower precision."""

    @staticmethod
    def forward(ctx, y, cast):
        ctx.cast = cast
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return ctx.cast(grad), None


def learning_rate(recipe: dict, rows: int, k: int) -> float:
    """The recipe's learning rate for the k-th update (k from 0)."""
    lr, warm = recipe["lr"], recipe.get("warmup_steps", 0)
    schedule = recipe.get("lr_schedule", "constant")
    if not warm and schedule == "constant":
        return lr
    warm = max(warm, 1)
    if k < warm or schedule == "constant":
        return lr * min(k, warm) / warm
    total = recipe["epochs"] * -(-rows // recipe["batch_size"])
    c = min(k - warm, total - warm)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / (total - warm)))


def train_steps(state: dict, cfg: dict, recipe: dict, rows: int,
                batches: list, g: torch.Generator, cast, grad_cast) -> dict:
    """Run the recipe's step on each (features, labels) of ``batches``
    from ``state`` (``rows`` in the training set), drawing from ``g``:
    every product's operands through ``cast`` and the gradient of its
    result through ``grad_cast``.
    Returns each step's loss and logits, each leaf's first gradient as
    Adam takes it (clipped, weight decay added), and each leaf's change
    over all the steps."""
    def ste(y):  # the rounding in the forward pass, identity backward
        return y + (cast(y.detach()) - y.detach())

    def gq(y):
        return _GradCast.apply(y, grad_cast)

    names = trainable(state)
    p0 = {k: state[k].detach().float().clone() for k in names}
    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    wd, clip = recipe["weight_decay"], recipe["grad_clip"]
    losses, outs, first = [], [], None
    for step, (x, y) in enumerate(batches, start=1):
        x = spec_augment(x.float(), g, recipe["augment_prob"],
                         recipe["time_mask_param"], recipe["freq_mask_param"])
        z = train_logits(params, x, ste, g, cfg["dropout"], gq)
        loss = F.cross_entropy(z, y)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        outs.append(z.detach())
        with torch.no_grad():
            norm = torch.sqrt(sum(gr.square().sum() for gr in grads))
            scale = 1.0 if float(norm) < clip else clip / norm
            gd = {k: gr * scale + wd * params[k]
                  for k, gr in zip(names, grads)}
            if first is None:
                first = {k: t.clone() for k, t in gd.items()}
            lr = learning_rate(recipe, rows, step - 1)
            for k in names:
                m[k].mul_(b1).add_(gd[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(gd[k], gd[k], value=1 - b2)
                denom = (v2[k] / (1 - b2 ** step)).sqrt() + eps
                params[k].sub_(lr / (1 - b1 ** step) * m[k] / denom)
    return {"losses": losses, "logits": outs, "grad": first,
            "delta": {k: (params[k].detach() - p0[k]) for k in names}}
