"""The Theorem-3 kernel's walk over its rows, emulated on the CPU.

``src/repro_torch/kernels/csrc/offload_greedy.cu`` cannot run without a
card, so this file replays its indexing in numpy, with the kernel's own
constants read from the source, and holds the result exactly to the
plain version (``offload_greedy_plain``) and to the JAX oracle
(``repro.kernels.ref.offload_greedy_ref``):

- the persistent grid: each block's equal contiguous share of the T·n
  rows, walked one round at a time, one warp a row;
- a row's aligned head (the columns before adj's next 16-byte boundary,
  for a row starting at byte (t·n+i)·n), its 16-column runs as 16-byte
  vectors, lane L owning runs L, L+32, ..., a step's loads all issued
  before its first compare, and its masked tail;
- the c_link float4 of a run's 4-column word loaded only when the word
  holds a live link, 16-byte aligned because the wrapper's
  ``vector_aligned`` makes the bases agree, and no read outside the row;
- each lane's ascending scan with a strict <, and the warp's xor-shuffle
  reduction under (v < v') or (v == v' and j < j');
- c_next staged at j + j/16: in bounds and free of bank conflicts.

It checks the design's indexing, not the compiled kernel:
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` (a) hold the kernel
itself to the plain version on a card.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import offload_greedy as og

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "kernels" / "csrc" / "offload_greedy.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


WARPS = _const("kWarps")
COLS = _const("kColsPerLane")
LANES = 32


class Walk:
    """One launch of the kernel's indexing on flat host arrays. ``adj_base``
    and ``link_base`` are the byte addresses the tensors would start at
    (only their value mod 16 matters); the entry point refuses bases
    that disagree."""

    def __init__(self, c_link, c_next, c_node, f_err, adj, *, adj_base=0,
                 link_base=0):
        self.T, self.n = c_node.shape
        self.cl = c_link.reshape(-1)
        self.a8 = adj.reshape(-1).view(np.uint8)
        self.c_next, self.c_node, self.f_err = c_next, c_node, f_err
        self.adj_base, self.link_base = adj_base, link_base
        assert (link_base - 4 * adj_base) % 16 == 0, "entry point refuses"
        self.read = np.zeros(self.cl.size, bool)     # c_link entries read
        self.link_loads = 0                          # float4 loads issued

    def _adj(self, idx):
        assert ((idx >= 0) & (idx < self.a8.size)).all(), "adj read past end"
        return self.a8[idx]

    def _link(self, idx):
        assert ((idx >= 0) & (idx < self.cl.size)).all(), "c_link past end"
        self.read[idx] = True
        return self.cl[idx]

    def row(self, r):
        """(min, argmin) of row r as one warp finds them."""
        n, t, i = self.n, r // self.n, r % self.n
        off = r * n
        lane = np.arange(LANES)
        h = min(n, (16 - (self.adj_base + off) % 16) % 16)
        runs = (n - h) // COLS
        tail = h + runs * COLS
        v = np.full(LANES, np.inf, np.float32)
        arg = np.zeros(LANES, np.int64)
        last = np.full(LANES, -1)       # each lane's last column compared

        def consider(live, j, link):
            nonlocal v, arg
            assert (j[live] > last[live]).all(), "lane scan not ascending"
            last[live] = j[live]
            e = np.where(live & (j != i),
                         link + self.c_next[t, np.where(live, j, 0)],
                         np.float32(np.inf)).astype(np.float32)
            better = live & (j != i) & (e < v)
            v = np.where(better, e, v)
            arg = np.where(better, j, arg)

        # head and tail: one column a lane at most, bytes of this row only
        jh, jt = lane, tail + lane
        in_head, in_tail = lane < h, jt < n
        assert h <= n and (jt[in_tail] >= h).all()
        head_live = np.zeros(LANES, bool)
        tail_live = np.zeros(LANES, bool)
        head_live[in_head] = self._adj(off + jh[in_head]) != 0
        tail_live[in_tail] = self._adj(off + jt[in_tail]) != 0
        head_link = np.zeros(LANES, np.float32)
        tail_link = np.zeros(LANES, np.float32)
        head_link[head_live] = self._link(off + jh[head_live])
        tail_link[tail_live] = self._link(off + jt[tail_live])
        consider(head_live, jh, head_link)

        for s in range(0, runs, LANES):
            run = s + lane
            ok = run < runs
            start = off + h + run * COLS             # byte of the adj vector
            assert ((self.adj_base + start[ok]) % 16 == 0).all()
            assert (start[ok] + COLS <= off + n).all(), "run past row"
            b = np.zeros((LANES, COLS), np.uint8)
            b[ok] = self._adj(start[ok, None] + np.arange(COLS))
            f = np.zeros((LANES, 4, 4), np.float32)
            for q in range(4):                       # every load first
                word = ok & b[:, 4 * q:4 * q + 4].any(1)
                p = start[word] + 4 * q              # c_link float index
                assert ((self.link_base + 4 * p) % 16 == 0).all()
                self.link_loads += int(word.sum())
                f[word, q] = self._link(p[:, None] + np.arange(4))
            for q in range(4):                       # then every compare
                for k in range(4):
                    c = 4 * q + k
                    consider(ok & (b[:, c] != 0), start - off + c, f[:, q, k])
        consider(tail_live, jt, tail_link)

        for o in (16, 8, 4, 2, 1):                   # __shfl_xor_sync
            ov, oa = v[lane ^ o], arg[lane ^ o]
            take = (ov < v) | ((ov == v) & (oa < arg))
            v, arg = np.where(take, ov, v), np.where(take, oa, arg)
        return v[0], arg[0]

    def blocks(self, grid):
        """Rows in the order of the persistent grid: block b's share
        [R·b/G, R·(b+1)/G), one round at a time, warp w taking rows
        lo+w, lo+w+8, ... of each round's segment."""
        R = self.T * self.n
        for b in range(grid):
            lo, hi = R * b // grid, R * (b + 1) // grid
            while lo < hi:
                t = lo // self.n
                end = min(hi, (t + 1) * self.n)
                for w in range(WARPS):
                    for r in range(lo + w, end, WARPS):
                        assert r // self.n == t, "segment crosses a round"
                        yield r
                lo = end

    def run(self, grid=7):
        T, n = self.T, self.n
        choice = np.full(T * n, -1, np.int32)
        best_j = np.full(T * n, -1, np.int32)
        cost = np.zeros(T * n, np.float32)
        c_node, f_err = self.c_node.reshape(-1), self.f_err.reshape(-1)
        for r in self.blocks(grid):
            assert choice[r] == -1, "row decided twice"
            v, j = self.row(r)
            best = min(c_node[r], v, f_err[r])
            choice[r] = 0 if c_node[r] <= best else (1 if v <= best else 2)
            best_j[r], cost[r] = j, best
        assert (choice >= 0).all(), "row never decided"
        return (choice.reshape(T, n), best_j.reshape(T, n),
                cost.reshape(T, n))


def _case(T, n, density, seed, *, ties=False, isolated=0, last=0):
    rng = np.random.default_rng(seed)
    if ties:                               # integer costs: many ties
        c_link = rng.integers(0, 3, (T, n, n)).astype(np.float32)
        vec = [rng.integers(0, 3, (T, n)).astype(np.float32)
               for _ in range(3)]
    else:
        c_link = rng.random((T, n, n), np.float32)
        vec = [rng.random((T, n), np.float32) for _ in range(3)]
    adj = rng.random((T, n, n)) < density
    adj[:, :isolated] = False
    if last:
        adj[:, :last] = False
        adj[:, :last, n - 1] = True
    return [c_link, *vec, adj]


def _check(args, walk_kw=None, grid=7):
    got = Walk(*args, **(walk_kw or {})).run(grid)
    plain = og.offload_greedy_plain(*(torch.from_numpy(a) for a in args))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())
    for t in range(args[0].shape[0]):
        want = ref.offload_greedy_ref(*(jnp.asarray(a[t]) for a in args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[t], np.asarray(w))


@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("T,n", [(3, 1), (3, 7), (2, 16), (2, 129),
                                 (1, 1000), (1, 1003)])
def test_walk_equals_plain_and_reference(T, n, density):
    _check(_case(T, n, density, 1000 * n + int(10 * density)))


@pytest.mark.parametrize("T,n,density", [(3, 7, 0.7), (2, 129, 0.5),
                                         (1, 1003, 0.3)])
def test_walk_keeps_lowest_j_on_integer_ties(T, n, density):
    _check(_case(T, n, density, n, ties=True))


@pytest.mark.parametrize("T,n", [(2, 16), (2, 129), (1, 1003)])
def test_walk_isolated_and_last_column_rows(T, n):
    _check(_case(T, n, 0.2, 7 + n, isolated=min(5, n)))
    _check(_case(T, n, 0.2, 8 + n, last=n - 1))
    _check(_case(T, n, 0.2, 9 + n, ties=True, last=n // 2))


def _view_at(a, off):
    """A contiguous copy of ``a`` that starts ``off`` elements into its
    storage."""
    flat = torch.zeros(a.numel() + off, dtype=a.dtype)
    flat[off:] = a.reshape(-1)
    return flat[off:].view(a.shape)


# (adj, c_link) views starting that many elements into their storage:
# adj copied, c_link copied, both copied, neither (the bases agree, and
# the rows peel by adj's own address)
@pytest.mark.parametrize("adj_off,link_off,copied", [
    (3, 0, (False, True)), (0, 1, (True, False)), (5, 2, (True, True)),
    (4, 4, (False, False))])
def test_walk_on_unaligned_bases(adj_off, link_off, copied):
    args = _case(2, 517, 0.2, adj_off + link_off)
    c_link = _view_at(torch.from_numpy(args[0]), link_off)
    adj = _view_at(torch.from_numpy(args[4]), adj_off)
    got = og.vector_aligned(c_link, adj)
    assert tuple(g.data_ptr() != a.data_ptr()
                 for g, a in zip(got, (c_link, adj))) == copied
    assert torch.equal(got[0], c_link) and torch.equal(got[1], adj)
    walk_kw = dict(link_base=got[0].data_ptr() % 16,
                   adj_base=got[1].data_ptr() % 16)
    assert walk_kw["adj_base"] == (0 if copied[1] else adj_off % 16)
    _check(args, walk_kw)


@pytest.mark.parametrize("T,n,density", [(2, 129, 0.05), (1, 1003, 0.02),
                                         (1, 1003, 0.3)])
def test_walk_reads_c_link_only_in_live_words(T, n, density):
    args = _case(T, n, density, 3 + n)
    walk = Walk(*args)
    walk.run()
    adj = args[4].reshape(T * n, n)
    allowed = np.zeros_like(adj)
    for r in range(T * n):
        h = min(n, (16 - (r * n) % 16) % 16)
        tail = h + (n - h) // COLS * COLS
        allowed[r, :h] = adj[r, :h]
        allowed[r, tail:] = adj[r, tail:]
        words = adj[r, h:tail].reshape(-1, 4).any(1)
        allowed[r, h:tail] = np.repeat(words, 4)
    read = walk.read.reshape(T * n, n)
    assert not (read & ~allowed).any(), "c_link read in a dead word"
    assert (read | ~adj).all(), "a live link was not read"
    body_words = sum(int(adj[r, h:h + (n - h) // COLS * COLS]
                         .reshape(-1, 4).any(1).sum())
                     for r in range(T * n)
                     for h in [min(n, (16 - (r * n) % 16) % 16)])
    assert walk.link_loads == body_words


@pytest.mark.parametrize("T,n,grid", [(1, 1, 1), (3, 7, 2), (4, 129, 5),
                                      (20, 1000, 528), (2, 9, 40)])
def test_persistent_grid_decides_every_row_once(T, n, grid):
    walk = Walk(*_case(T, n, 0.0, 0))
    rows = list(walk.blocks(grid))
    assert sorted(rows) == list(range(T * n))


def test_staged_c_next_is_in_bounds_and_free_of_bank_conflicts():
    stage = re.search(r"int staged\(int j\) \{ return j \+ \(j >> (\d+)\); \}",
                      SRC)
    assert stage, "staged() changed: update this emulation"
    shift = int(stage.group(1))
    smem = re.search(r"\(n \+ \(n >> (\d+)\)\)", SRC)
    assert int(smem.group(1)) == shift

    def staged(j):
        return j + (j >> shift)

    for n in (1, 7, 16, 1000, 1003, 4097, 11566):
        idx = staged(np.arange(n))
        assert len(np.unique(idx)) == n and idx.max() < n + (n >> shift)
    lane = np.arange(LANES)
    for h in range(16):                  # every head length
        for s in (0, LANES, 7 * LANES):
            for c in range(COLS):        # the same column of every lane
                j = h + (s + lane) * COLS + c
                assert len(np.unique(staged(j) % 32)) == LANES
