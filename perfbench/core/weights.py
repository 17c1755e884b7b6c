"""Seeded weights, made on the device in two large calls.

A specification lists (name, shape, kind, a, b): ``uniform`` draws from
U(a, b), ``normal`` from N(a, b^2), ``const`` fills a in float32 and
``count`` in int64 (BatchNorm's ``num_batches_tracked``).  Every uniform
entry is cut from one ``torch.rand`` of their total size and every normal
one from one ``torch.randn``, both drawn by a ``torch.Generator`` on the
device, so the weights of 94 M parameters take milliseconds.  The state
dict is the benchmark's own: the program is given a copy, and the
references read the original.
"""

from __future__ import annotations

import math

import torch


def make_state(spec: list, g: torch.Generator, device) -> dict:
    sizes = {"uniform": 0, "normal": 0}
    for _name, shape, kind, _a, _b in spec:
        if kind in sizes:
            sizes[kind] += math.prod(shape)
    flat = {
        "uniform": torch.rand(sizes["uniform"], generator=g, device=device),
        "normal": torch.randn(sizes["normal"], generator=g, device=device),
    }
    used = {"uniform": 0, "normal": 0}
    state = {}
    for name, shape, kind, a, b in spec:
        if kind in ("const", "count"):
            state[name] = torch.full(shape, a, device=device,
                                     dtype=torch.float32 if kind == "const"
                                     else torch.int64)
            continue
        n = math.prod(shape)
        u = flat[kind][used[kind]:used[kind] + n].view(shape)
        used[kind] += n
        state[name] = (a + (b - a) * u if kind == "uniform" else a + b * u)
    return state
