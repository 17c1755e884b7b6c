"""The persistent K5 kernel (``speech_intent_recognizer_tpu_torch/csrc/
conv23.cu``) modelled in NumPy where no card is present.

The model follows the kernel thread by thread: the host plan cuts the batch
into work items (utterance, range of output rows) that persistent blocks
walk round-robin; a loader fills an input ring, warpgroup 0 makes pooled
conv2 rows into a pooled ring, warpgroup 1 makes two output rows a step;
the three meet on the rings' full / empty mbarriers (modelled with their
phase parity).  A operands are gathered at the kernel's ldmatrix addresses
from rings stored with its zero columns and chunk swizzles, B operands read
through its wgmma descriptors from the packed weights, accumulators laid
out as wgmma leaves them, and the epilogue pools across the lane pairs the
kernel exchanges.  Shared memory starts as NaN, so a read of a byte nobody
wrote shows.  The model is held against ``_conv23_plain``; the kernel
itself is held against it on the card (``tests/test_torch_cuda.py``)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from speech_intent_recognizer_tpu_torch import _build
from speech_intent_recognizer_tpu_torch.ops import conv23 as c23
from speech_intent_recognizer_tpu_torch.ops.conv23 import (
    C1, C2, C3, M1, W2_SHAPE, W3_SHAPE, Conv23Plan, _conv23_plain, _unpack,
    conv23_operands, conv23_plan)

CSRC = os.path.join(os.path.dirname(_build.__file__), "csrc")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = np.arange(32)
SMEM_LIMIT = 232448


def source():
    with open(os.path.join(CSRC, "conv23.cu")) as f:
        return f.read()


def constant(name):
    return int(re.search(rf"\b{name} = (\d+)", source()).group(1))


IN_SLOTS, P_SLOTS = constant("kInSlots"), constant("kPSlots")
LBO, SBO = constant("kLbo"), constant("kSbo")
IN_COLS, P_COLS = M1 + 2, M1 // 2 + 2
IN_ROW, P_ROW = IN_COLS * C1 * 2, P_COLS * C2 * 2
W2_TILE, W3_TILE = C2 * 32, C3 * 32
W3_OFF = 9 * (C1 // 16) * W2_TILE
IN_OFF = W3_OFF + 9 * (C2 // 16) * W3_TILE
P_OFF = IN_OFF + IN_SLOTS * IN_ROW
BAR_OFF = P_OFF + P_SLOTS * P_ROW
SMEM_BYTES = BAR_OFF + 8 * 2 * (IN_SLOTS + P_SLOTS)


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16() \
        .float().numpy()


# ---- index maps of csrc/conv23.cu ----

def in_offset(cc, chunk):
    """``in_offset``: four 16-byte chunks a padded column, at
    chunk ^ ((cc >> 1) & 3)."""
    return cc * C1 * 2 + ((chunk ^ ((cc >> 1) & 3)) << 4)


def p_offset(cc, chunk):
    """``p_offset``: eight chunks a column, at chunk ^ (cc & 7)."""
    return cc * C2 * 2 + ((chunk ^ (cc & 7)) << 4)


def ldmatrix_rows(lane):
    """(g, h, chunk) a lane addresses in ldmatrix.x4: row (l & 7) +
    8 ((l >> 3) & 1) of the warp's 16, k-chunk l >> 4."""
    return lane & 7, (lane >> 3) & 1, lane >> 4


def conv2_position(warp, h, g):
    """Row 8 h + g of warpgroup 0's warp: (conv2 time row in the pooled
    row's pair, mel position)."""
    return h, 8 * warp + g


def conv3_position(warp, h, g):
    """Row 8 h + g of warpgroup 1's warp: (conv3 row among the step's four,
    mel position)."""
    return 2 * (warp >> 1) + h, 8 * (warp & 1) + g


def b_address(start, k, n):
    """Byte of element (k, n) of a 16 x N B tile under a no-swizzle K-major
    descriptor: core matrices of 8 n-rows x 8 k (16 B a row), LBO between
    the two along K, SBO between those along N."""
    return start + (n // 8) * SBO + (k // 8) * LBO + (n % 8) * 16 + (k % 8) * 2


def items_of(plan, batch, t1):
    t3 = t1 // 4
    chunks = -(-t3 // plan.rows)
    out = []
    for i in range(batch * chunks):
        b, c = divmod(i, chunks)
        r0 = c * plan.rows
        r1 = min(r0 + plan.rows, t3)
        out.append((b, r0, r1, (r1 - r0 + 1) // 2))
    return out


# ---- the plan ----

@pytest.mark.parametrize("batch", [0, 1, 5, 131, 132, 133, 256, 2048])
@pytest.mark.parametrize("t1", [4, 8, 100, 200])
def test_plan_covers_every_output_row_once(batch, t1):
    sms = 132
    plan = conv23_plan(batch, t1, sms)
    t3 = t1 // 4
    assert plan.rows == t3 or (plan.rows % 2 == 0 and 2 <= plan.rows < t3)
    items = items_of(plan, batch, t1)
    assert plan.grid == min(len(items), sms)
    seen = np.zeros((batch, t3), int)
    for b, r0, r1, steps in items:
        seen[b, r0:r1] += 1
        assert 2 * steps >= r1 - r0 and steps >= 1
    assert (seen == 1).all()
    # round-robin over the grid: every block gets ceil or floor items
    if items:
        per_block = np.bincount(np.arange(len(items)) % plan.grid)
        assert per_block.max() - per_block.min() <= 1


def test_plan_picks():
    """Whole utterances where the batch covers the SMs many times; shorter
    ranges near or under the SM count."""
    assert conv23_plan(2048, 100, 132).rows == 25
    assert conv23_plan(256, 100, 132).rows == 25
    assert conv23_plan(1, 100, 132).rows == 2
    assert conv23_plan(133, 100, 132).rows < 25
    assert conv23_plan(5, 200, 132).rows < 50
    for batch in (1, 5, 131, 133, 256, 2048):
        plan = conv23_plan(batch, 100, 132)
        cost = c23._range_cost(batch, 25, plan.rows, 132)
        assert all(c23._range_cost(batch, 25, r, 132) >= cost
                   for r in [25] + list(range(2, 25, 2)))


# ---- shared memory and the rings ----

def test_shared_memory_and_constants_are_the_sources():
    assert SMEM_BYTES <= SMEM_LIMIT
    assert 9 * (C1 // 16) * W2_TILE == 36864 and W3_OFF + 147456 == IN_OFF
    assert IN_OFF + IN_SLOTS * IN_ROW + P_SLOTS * P_ROW <= SMEM_LIMIT
    assert IN_ROW == 2176 and P_ROW == 2304
    assert IN_OFF % 128 == 0 and BAR_OFF % 8 == 0
    # the next ring row would not fit
    assert SMEM_BYTES + min(IN_ROW, P_ROW) > SMEM_LIMIT
    assert constant("kThreads") == 288 and constant("kLoaderWarp") == 8


class Barrier:
    """An mbarrier: ``count`` arrivals complete a phase; a wait on parity P
    passes once the phase of that parity has completed."""

    def __init__(self, count):
        self.count, self.pending, self.completed = count, count, 0

    def arrive(self, n=1):
        self.pending -= n
        assert self.pending >= 0
        if self.pending == 0:
            self.completed += 1
            self.pending = self.count

    def ready(self, parity):
        return (self.completed & 1) != parity


def roles(items):
    """The three roles' programs as generators of ("wait", barrier list,
    slot, parity) / ("arrive", list, slot, n) / ("write" | "read", ring,
    slot, row id) steps, in the kernel's order."""
    def loader():
        count = 0
        for b, r0, _r1, steps in items:
            for k in range(8 * steps + 6):
                slot, use = count % IN_SLOTS, count // IN_SLOTS
                yield ("wait", "in_empty", slot, (use & 1) ^ 1)
                yield ("write", "in", slot, (b, r0, 4 * r0 - 3 + k))
                yield ("arrive", "in_full", slot, 32)
                count += 1

    def warpgroup0():
        # pooled rows in pairs: a pair reads six input rows, frees four (the
        # item's last pair all six), then stores its two rows
        in_base = p_count = 0
        for b, r0, _r1, steps in items:
            np_ = 4 * steps + 2
            for pi in range(0, np_, 2):
                rows = [in_base + 2 * pi + r for r in range(6)]
                for c in rows:
                    yield ("wait", "in_full", c % IN_SLOTS,
                           (c // IN_SLOTS) & 1)
                for r, c in enumerate(rows):
                    yield ("read", "in", c % IN_SLOTS,
                           (b, r0, 4 * r0 - 3 + 2 * pi + r))
                free = rows[:4] + (rows[4:] if pi + 2 == np_ else [])
                for c in free:
                    yield ("arrive", "in_empty", c % IN_SLOTS, 128)
                for u in range(2):
                    slot = (p_count + u) % P_SLOTS
                    yield ("wait", "p_empty", slot,
                           (((p_count + u) // P_SLOTS) & 1) ^ 1)
                    yield ("write", "p", slot, (b, r0, 2 * r0 - 1 + pi + u))
                    yield ("arrive", "p_full", slot, 128)
                p_count += 2
            in_base += 8 * steps + 6

    def warpgroup1():
        p_base = 0
        for b, r0, _r1, steps in items:
            for k in range(steps):
                rows = [p_base + 4 * k + r for r in range(6)]
                for c in rows:
                    yield ("wait", "p_full", c % P_SLOTS, (c // P_SLOTS) & 1)
                for r, c in enumerate(rows):
                    yield ("read", "p", c % P_SLOTS,
                           (b, r0, 2 * (r0 + 2 * k) - 1 + r))
                free = rows[:4] + (rows[4:] if k == steps - 1 else [])
                for c in free:
                    yield ("arrive", "p_empty", c % P_SLOTS, 128)
            p_base += 4 * steps + 2

    return [loader(), warpgroup0(), warpgroup1()]


def simulate(items, seed):
    """Run the roles in a random interleaving; a role blocks on a wait whose
    phase has not completed.  Returns the rows each ring slot held when it
    was read.  Fails on a deadlock."""
    bars = {name: [Barrier(32 if name == "in_full" else 128)
                   for _ in range(IN_SLOTS if name.startswith("in") else
                                  P_SLOTS)]
            for name in ("in_full", "in_empty", "p_full", "p_empty")}
    held = {"in": [None] * IN_SLOTS, "p": [None] * P_SLOTS}
    progs = roles(items)
    pending = [next(p, None) for p in progs]
    rng = np.random.default_rng(seed)
    reads = []
    while any(s is not None for s in pending):
        ready = [i for i, s in enumerate(pending) if s is not None and (
            s[0] != "wait" or bars[s[1]][s[2]].ready(s[3]))]
        assert ready, f"deadlock at {pending}"
        i = int(rng.choice(ready))
        op, name, slot, arg = pending[i]
        if op == "arrive":
            bars[name][slot].arrive(arg)
        elif op == "write":
            held[name][slot] = arg
        elif op == "read":
            assert held[name][slot] == arg, (name, slot, held[name][slot], arg)
            reads.append((name, arg))
        pending[i] = next(progs[i], None)
    return reads


@pytest.mark.parametrize("batch,t1,rows", [(3, 100, None), (2, 8, None),
                                           (1, 4, None), (2, 100, 2),
                                           (2, 100, 6), (1, 200, 8),
                                           (4, 12, 2)])
def test_rings_never_overwrite_a_row_still_read(batch, t1, rows):
    plan = conv23_plan(batch, t1, 2)
    if rows is not None:
        plan = Conv23Plan(rows, 2)
    for block in range(2):  # two blocks of a grid of two
        mine = items_of(plan, batch, t1)[block::2]
        for seed in range(3):
            reads = simulate(mine, seed)
            steps = sum(it[3] for it in mine)
            assert len(reads) == 3 * (4 * steps + 2 * len(mine)) + 6 * steps


# ---- ldmatrix and descriptors ----

def banks(addresses):
    """The 4-byte banks the eight 16-byte rows of one ldmatrix phase hit."""
    return np.concatenate([(a // 4 + np.arange(4)) % 32 for a in addresses])


@pytest.mark.parametrize("stage", [2, 3])
def test_every_tap_shifted_ldmatrix_is_conflict_free(stage):
    """Each of the four 8-lane phases of every ldmatrix.x4 of every tap
    (km shift 0..2), k-slice and warp reads eight rows on 32 distinct
    banks, in every ring slot."""
    g, h, chunk = ldmatrix_rows(LANES)
    slots, row_bytes, off = ((IN_SLOTS, IN_ROW, in_offset) if stage == 2
                             else (P_SLOTS, P_ROW, p_offset))
    kks = C1 // 16 if stage == 2 else C2 // 16
    for slot in range(slots):
        for warp in range(4):
            pos = conv2_position if stage == 2 else conv3_position
            _, m = pos(warp, h, g)
            for km in range(3):
                for kk in range(kks):
                    addr = (slot * row_bytes + off(m + km, 2 * kk + chunk))
                    for phase in range(4):
                        lanes = slice(8 * phase, 8 * phase + 8)
                        assert len(set(banks(addr[lanes]))) == 32


def test_b_descriptors_start_on_their_atom_and_address_the_packed_weights():
    """Every k-step's B tile starts on a 128-byte core matrix inside the
    weights region, its descriptor fields fit, and the element (k, n) the
    descriptor addresses is the packed weight of (input channel 16 kk + k,
    output channel n)."""
    g = torch.Generator().manual_seed(1)
    w2 = torch.randn((C2, C1, 3, 3), generator=g)
    w3 = torch.randn((C3, C2, 3, 3), generator=g)
    p2, _, p3, _ = conv23_operands(w2, torch.zeros(C2), w3, torch.zeros(C3))
    smem = np.concatenate([p2.view(torch.int16).numpy().ravel(),
                           p3.view(torch.int16).numpy().ravel()])
    k = np.arange(16)[:, None]
    for w, base, tile, kks, n in ((w2, 0, W2_TILE, C1 // 16, C2),
                                  (w3, W3_OFF, W3_TILE, C2 // 16, C3)):
        ref = w.to(torch.bfloat16).view(torch.int16).numpy()
        cols = np.arange(n)[None, :]
        for tap in range(9):
            kt, km = divmod(tap, 3)
            for kk in range(kks):
                start = base + (tap * kks + kk) * tile
                assert start % 128 == 0 and start + tile <= IN_OFF
                assert (start >> 4) < (1 << 14) and (LBO >> 4) < (1 << 14)
                addr = b_address(start, k, cols)
                assert addr.min() == start and addr.max() == start + tile - 2
                got = smem[addr // 2]
                want = ref[cols, 16 * kk + k, km, kt]
                np.testing.assert_array_equal(got, want)


def test_packed_weights_round_trip():
    g = torch.Generator().manual_seed(2)
    w2 = torch.randn((C2, C1, 3, 3), generator=g).bfloat16().float()
    w3 = torch.randn((C3, C2, 3, 3), generator=g).bfloat16().float()
    p2, _, p3, _ = conv23_operands(w2, torch.zeros(C2), w3, torch.zeros(C3))
    assert p2.shape == W2_SHAPE and p3.shape == W3_SHAPE
    assert torch.equal(_unpack(p2), w2) and torch.equal(_unpack(p3), w3)


@pytest.mark.parametrize("stage", [2, 3])
def test_m_row_order_puts_each_pool_window_in_a_lane_pair(stage):
    """In every warp the accumulator rows g, g + 8 of lane (g, q) and of
    lane ^ 4 are the four members of one 2x2 window; the warpgroup's
    windows are all of a pooled row (conv2) or of two output rows (conv3),
    once each, where the epilogue stores them."""
    g, q = LANES >> 2, LANES & 3
    pos = conv2_position if stage == 2 else conv3_position
    windows = []
    for warp in range(4):
        for lane in range(32):
            mine = {pos(warp, h, g[lane]) for h in (0, 1)}
            other = {pos(warp, h, g[lane ^ 4]) for h in (0, 1)}
            quad = mine | other
            assert len(quad) == 4
            ts, ms = {t for t, _ in quad}, {m for _, m in quad}
            assert len(ts) == 2 and len(ms) == 2
            assert min(ts) % 2 == 0 and min(ms) % 2 == 0
            assert max(ts) == min(ts) + 1 and max(ms) == min(ms) + 1
            window = (min(ts) // 2, min(ms) // 2)
            # where the epilogue writes it
            if stage == 2:
                assert window == (0, 4 * warp + (g[lane] >> 1))
            else:
                assert window == (warp >> 1, 4 * (warp & 1) + (g[lane] >> 1))
            if q[lane] == 0 and g[lane] % 2 == 0:
                windows.append(window)
    want = 16 if stage == 2 else 16
    assert len(windows) == len(set(windows)) == want


def test_output_transpose_gives_each_lane_sixteen_bytes():
    """The epilogue's exchange across the four lanes of a row: lane q ends
    with channels 8 j .. 8 j + 7 of group j = 2 (4 h + q) + odd, word i
    from lane i, in order."""
    for h in (0, 1):
        for odd in (0, 1):
            # lane q holds v[s] = (group 2 s + odd, channels 2q, 2q + 1)
            v = {(q, s): (2 * s + odd, 2 * q) for q in range(4)
                 for s in range(8)}
            for q in range(4):
                t = [None] * 4
                t[q] = v[(q, 4 * h + q)]
                for x1 in (1, 2, 3):
                    partner = q ^ x1
                    send = v[(partner, 4 * h + (partner ^ x1))]
                    t[q ^ x1] = send
                group = 2 * (4 * h + q) + odd
                assert t == [(group, 2 * i) for i in range(4)]


# ---- the model against the plain version ----

def _ring(slots, row_bytes, cols, offset, chunks):
    """A ring as NaN bf16 values by byte address / 2, its zero columns
    written as the kernel writes them once per launch."""
    ring = np.full(slots * row_bytes // 2, np.nan, np.float32)
    for s in range(slots):
        for cc in (0, cols - 1):
            for c in range(chunks):
                o = (s * row_bytes + offset(cc, c)) // 2
                ring[o:o + 8] = 0.0
    return ring


def _gather_a(ring, slot_of, row_bytes, offset, position, km, kk):
    """The 64 x 16 A tile the warpgroup's ldmatrix.x4 loads: lane (g, h,
    chunk) of warp w addresses row 8 h + g at its tap-shifted position."""
    g, h, chunk = ldmatrix_rows(LANES)
    a = np.full((64, 16), np.nan, np.float32)
    for warp in range(4):
        t, m = position(warp, h, g)
        addr = (slot_of(t) * row_bytes + offset(m + km, 2 * kk + chunk)) // 2
        a[(16 * warp + 8 * h + g)[:, None],
          8 * chunk[:, None] + np.arange(8)] = ring[addr[:, None]
                                                    + np.arange(8)]
    return a


def _epilogue(acc, bias):
    """Per (warp, lane, kept group): the two channels 2q, 2q + 1 after the
    in-thread max over rows g, g + 8, the exchange with lane ^ 4, bias and
    ReLU, rounded to bf16."""
    g, q = LANES >> 2, LANES & 3
    for warp in range(4):
        for lane in range(32):
            odd = g[lane] & 1
            rows = [16 * warp + gg + d for gg in (g[lane], g[lane ^ 4])
                    for d in (0, 8)]
            for s in range(acc.shape[1] // 16):
                j = 2 * s + odd
                cols = 8 * j + 2 * q[lane] + np.arange(2)
                v = acc[np.ix_(rows, cols)].max(0) + bias[cols]
                yield warp, lane, j, bf16(np.maximum(v, 0.0))


def model_conv23(x, w2p, b2, w3p, b3, rows, grid):
    """The kernel in NumPy, block by block.  Each block's roles run in a
    lockstep order the rings allow (the loader one input row ahead of what
    warpgroup 0 reads, warpgroup 1 as soon as a step's six pooled rows are
    written; the interleavings are checked above), with the kernel's ring
    counters, addresses, A gathers, descriptor reads and epilogue."""
    xs = x.float().numpy()
    batch, t1, _ = xs.shape
    t2n, t3n = t1 // 2, t1 // 4
    b2, b3 = b2.numpy(), b3.numpy()
    out = np.full((batch, t3n, 8 * C3), np.nan, np.float32)
    items = items_of(Conv23Plan(rows, grid), batch, t1)
    weights = np.concatenate([w2p.float().numpy().ravel(),
                              w3p.float().numpy().ravel()])
    k16 = np.arange(16)[:, None]

    def b_tile(start, n):
        return weights[b_address(start, k16, np.arange(n)[None, :]) // 2]

    g, q = LANES >> 2, LANES & 3
    for block in range(min(grid, len(items))):
        in_ring = _ring(IN_SLOTS, IN_ROW, IN_COLS, in_offset, 4)
        p_ring = _ring(P_SLOTS, P_ROW, P_COLS, p_offset, 8)
        loaded = in_base = p_count = p_base = 0
        for b, r0, r1, steps in items[block::grid]:
            def load_through(idx):
                nonlocal loaded
                while loaded < in_base + idx + 1:
                    t = 4 * r0 - 3 + (loaded - in_base)
                    slot = loaded % IN_SLOTS
                    for i in range(M1 * 4):
                        o = (slot * IN_ROW
                             + in_offset((i >> 2) + 1, i & 3)) // 2
                        in_ring[o:o + 8] = (xs[b, t, 8 * i:8 * i + 8]
                                            if 0 <= t < t1 else 0.0)
                    loaded += 1

            def conv3_step(k):
                acc = np.zeros((64, C3), np.float64)
                for tap in range(9):
                    kt, km = divmod(tap, 3)
                    for kk in range(C2 // 16):
                        a = _gather_a(
                            p_ring, lambda jr: (p_base + 4 * k + jr + kt)
                            % P_SLOTS, P_ROW, p_offset, conv3_position, km, kk)
                        acc += a @ b_tile(W3_OFF + (tap * 4 + kk) * W3_TILE,
                                          C3)
                for warp, lane, j, v in _epilogue(acc, b3):
                    o = r0 + 2 * k + (warp >> 1)
                    pm = 4 * (warp & 1) + (g[lane] >> 1)
                    if o < r1:
                        c = pm * C3 + 8 * j + 2 * q[lane]
                        out[b, o, c:c + 2] = v

            for pi in range(4 * steps + 2):
                load_through(2 * pi + 3)
                p = 2 * r0 - 1 + pi
                slot = p_count % P_SLOTS
                if 0 <= p < t2n:
                    acc = np.zeros((64, C2), np.float64)
                    for tap in range(9):
                        kt, km = divmod(tap, 3)
                        for kk in range(C1 // 16):
                            a = _gather_a(
                                in_ring,
                                lambda dt: (in_base + 2 * pi + dt + kt)
                                % IN_SLOTS, IN_ROW, in_offset, conv2_position,
                                km, kk)
                            acc += a @ b_tile((tap * 2 + kk) * W2_TILE, C2)
                    stores = _epilogue(acc, b2)
                else:
                    stores = ((w, lane, 2 * s + (g[lane] & 1), np.zeros(2))
                              for w in range(4) for lane in range(32)
                              for s in range(4))
                for warp, lane, j, v in stores:
                    cc = 4 * warp + (g[lane] >> 1) + 1
                    o = (slot * P_ROW + p_offset(cc, j) + 4 * q[lane]) // 2
                    p_ring[o:o + 2] = v
                p_count += 1
                if pi >= 5 and (pi - 5) % 4 == 0:
                    conv3_step((pi - 5) // 4)
            in_base += 8 * steps + 6
            p_base += 4 * steps + 2
    return out


@pytest.mark.parametrize("batch,t1,rows", [(2, 8, None), (2, 100, None),
                                           (2, 100, 25), (1, 100, 6),
                                           (3, 12, 2)])
def test_model_in_kernel_order_matches_plain(batch, t1, rows):
    """The model, fed the kernel's packed operands, against _conv23_plain:
    every output written, no NaN read, within K5's bar (0.02 of the
    largest output; fp32 sums in another order can move a bf16 rounding)
    and nearly all outputs equal."""
    g = torch.Generator().manual_seed(batch * 1000 + t1)
    x = (2 * torch.rand((batch, t1, 1024), generator=g)).to(torch.bfloat16)
    ops = conv23_operands(
        (torch.rand((C2, C1, 3, 3), generator=g) * 2 - 1) / 288 ** 0.5,
        0.1 * torch.randn(C2, generator=g),
        (torch.rand((C3, C2, 3, 3), generator=g) * 2 - 1) / 576 ** 0.5,
        0.1 * torch.randn(C3, generator=g))
    plan = conv23_plan(batch, t1, 132)
    got = model_conv23(x, *ops, rows or plan.rows, plan.grid if rows is None
                       else 3)
    want = _conv23_plain(x, *ops).float().numpy()
    assert not np.isnan(got).any()
    scale = np.abs(want).max()
    assert scale > 0.1 and (want > 0).mean() > 0.2
    assert np.abs(got - want).max() < 0.02 * scale
    assert (got == want).mean() > 0.97


# ---- entry points and the variants bench ----

def test_entry_points_match_their_ctypes_signatures():
    found = {entry: ["*" in a for a in args.split(",")]
             for entry, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                           source())}
    assert set(found) == {"sir_conv23", "sir_conv23_info"}
    for entry, pointers in found.items():
        assert [t is _build._P for t in _build._SIGNATURES[entry]] \
            == pointers, entry


def _python(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_conv23_variants_bench_edits_match_the_sources(tmp_path):
    """``bench_torch_conv23_variants.py`` builds its variants by replacing
    lines of the sources: every replacement still matches exactly once and
    changes them, and importing the script loads no JAX and nothing of the
    JAX package."""
    code = f"""
import os, sys
import bench_torch_conv23_variants as b
for i, name in enumerate(b.VARIANTS):
    src = os.path.join({str(tmp_path)!r}, f'v{{i}}')
    os.makedirs(src)
    b.write_sources(src)
    unit = b.VARIANTS[name][0]
    before = open(os.path.join(src, unit)).read()
    b.apply_edits(name, src)
    after = open(os.path.join(src, unit)).read()
    assert (before != after) == bool(b.VARIANTS[name][1]), name
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'optax',
              'speech_intent_recognizer_tpu'))
assert not bad, bad
"""
    r = _python(["-c", code], REPO)
    assert r.returncode == 0, r.stdout + r.stderr


def test_conv23_variants_bench_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the host without one")
    r = _python([os.path.join(REPO, "bench_torch_conv23_variants.py")], REPO)
    assert r.returncode != 0 and " ms" not in r.stdout
