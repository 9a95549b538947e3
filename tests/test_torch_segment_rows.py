"""The row-segment sum (``segment_reduce.segment_sum_rows``) and the
redesigned segment-reduce kernel's walks, on the CPU.

Held bit for bit: the plain row version against the reference's
``ops.segment_sum_rows`` (its scatter path); the row route against the
1-D route over the ids ``g·P + p`` of the product; the port's
``aggregate_tier`` against its former route (the (m, P) product summed
over those ids); and numpy replays of both CUDA kernels' indexing (the
row kernel's vector width by alignment, its tiles, staged member chunks
and unrolled tails; the 1-D kernel's segments per thread, summed in
lockstep when short, alone when longer, and its warp-staged walk of
wide segments) against the plain versions. Every one of these is a
float32 sum in ascending row (element) order from +0, one correctly
rounded product and add per entry, so they agree exactly. Against the reference's
Pallas kernel in interpret mode the sums are within rtol 1e-6, atol
1e-5 (its one-hot matmul sums each 128-element chunk first: another
order), on finite data only (it spreads a NaN across its tile).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.segment_reduce import segment_sum_pallas
from repro_torch.core import engine as teng
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as sr

# the CUDA source's constants (csrc/segment_reduce.cu)
THREADS, UNROLL, STAGE, ROW_MEMBERS = 256, 8, 8, 256
CHUNK = 32 * STAGE
WIDE_MIN = 2048


def _row_case(kind, seed):
    """(data (m, P) f32, ids (m,) int32, G, scale (m,) f32)."""
    rng = np.random.default_rng(seed)
    m, P, G = 40, 13, 5
    if kind == "empty_group":
        ids = rng.choice([0, 1, 3, 4], m)
    elif kind == "out_of_range":
        ids = rng.integers(-3, G + 3, m)
    elif kind == "p1":
        m, P = 25, 1
        ids = rng.integers(0, G, m)
    elif kind == "no_rows":
        m = 0
        ids = np.zeros(0, np.int64)
    elif kind == "no_groups":
        G = 0
        ids = rng.integers(0, 3, m)
    elif kind == "non_finite":
        ids = rng.integers(0, G, m)
    elif kind == "wide_p":
        m, P, G = 30, 1031, 3
        ids = rng.integers(0, G, m)
    else:
        ids = rng.integers(0, G, m)
    data = rng.standard_normal((m, P)).astype(np.float32)
    scale = rng.integers(0, 7, m).astype(np.float32)
    if kind == "non_finite":
        data[np.nonzero(ids == 1)[0][0]] = np.nan
        data[np.nonzero(ids == 2)[0][-1], 3] = np.inf
        data[np.nonzero(ids == 4)[0][0], 0] = -np.inf
    return data, ids.astype(np.int32), G, scale


ROW_KINDS = ["random", "empty_group", "out_of_range", "p1", "no_rows",
             "no_groups", "non_finite", "wide_p"]


def _t(*a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


def _bits(a):
    """float32 bits, every NaN one pattern (the sums keep the NaN that
    reached them; which payload is not the contract)."""
    a = np.array(a, np.float32)
    a[np.isnan(a)] = np.nan
    return a.view(np.int32)


def _seq_rows(data, ids, G, scale=None):
    """Sequential float32 row sums in ascending row order from +0."""
    out = np.zeros((G, data.shape[1]), np.float32)
    for i, g in enumerate(ids):
        if 0 <= g < G:
            out[g] = out[g] + (data[i] if scale is None
                               else data[i] * scale[i])
    return out


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_plain_rows_equal_reference_scatter(kind):
    data, ids, G, scale = _row_case(kind, 1)
    got = sr.segment_sum_rows_plain(*_t(data, ids), G).numpy()
    want = np.asarray(rops.segment_sum_rows(
        jnp.asarray(data), jnp.asarray(ids), num_segments=G,
        use_pallas=False))
    assert got.shape == (G, data.shape[1]) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # with the scale: the reference's scatter of the numpy product
    got = sr.segment_sum_rows_plain(*_t(data, ids), G,
                                    scale=torch.from_numpy(scale)).numpy()
    want = np.asarray(rops.segment_sum_rows(
        jnp.asarray(data * scale[:, None]), jnp.asarray(ids),
        num_segments=G, use_pallas=False))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_seq_rows(data, ids, G, scale)))


def _flat_ids(ids, G, P):
    """The 1-D route's ids ``g·P + p`` (out-of-range rows to -1)."""
    ok = (ids >= 0) & (ids < G)
    flat = ids.astype(np.int64)[:, None] * P + np.arange(P)[None]
    return np.where(ok[:, None], flat, -1).reshape(-1).astype(np.int32)


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_row_route_is_the_flat_route_bitwise(kind):
    data, ids, G, scale = _row_case(kind, 2)
    m, P = data.shape
    d, i, h = _t(data, ids, scale)
    got = sr.segment_sum_rows(d, i, G, scale=h)
    flat = sr.segment_sum((d * h[:, None]).reshape(-1),
                          torch.from_numpy(_flat_ids(ids, G, P)), G * P)
    np.testing.assert_array_equal(_bits(got), _bits(flat.reshape(G, P)))
    if G and m and np.isfinite(data).all():
        pallas = np.asarray(segment_sum_pallas(
            jnp.asarray((data * scale[:, None]).reshape(-1)),
            jnp.asarray(_flat_ids(ids, G, P)), G * P, interpret=True))
        np.testing.assert_allclose(got.numpy().reshape(-1), pallas,
                                   rtol=1e-6, atol=1e-5)


def test_cpu_index_add_adds_rows_in_row_order():
    """The plain row version's order: CPU ``index_add_`` over 2-D rows
    adds each column's entries in ascending row order, one float32 add
    at a time from +0 (the sums here depend on that order)."""
    rng = np.random.default_rng(3)
    m, P, G = 600, 37, 4
    data = (rng.standard_normal((m, P))
            * 10.0 ** rng.integers(-6, 8, (m, P))).astype(np.float32)
    ids = rng.integers(0, G, m).astype(np.int32)
    got = sr.segment_sum_rows_plain(*_t(data, ids), G).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_seq_rows(data, ids, G)))
    rev = _seq_rows(data[::-1], ids[::-1], G)
    assert not np.array_equal(_bits(got), _bits(rev))


def _aggregate_tier_flat(W, H, gids, G):
    """The former route of ``aggregate_tier``: the (m, P) product summed
    over the E-length ids ``g·P + p``."""
    gid = torch.as_tensor(np.asarray(gids)).to(torch.int32)
    m = H.shape[0]
    Hg = ops.segment_sum(H, gid, num_segments=G)
    zero = torch.zeros((), dtype=H.dtype)
    den = torch.clamp(Hg, min=1e-9)[:, None]
    ok = Hg[:, None] > 0
    out = {}
    for key, a in W.items():
        P = int(np.prod(a.shape[1:], dtype=np.int64))
        flat = (a.reshape(m, P) * H[:, None]).reshape(-1)
        p = torch.arange(P, dtype=torch.int32)
        ids = (gid[:, None] * P + p[None]).reshape(-1)
        s = ops.segment_sum(flat, ids, num_segments=G * P)
        o = torch.where(ok, s.reshape(G, P) / den, zero)
        out[key] = o.reshape((G,) + a.shape[1:]).to(a.dtype)
    return out, Hg


@pytest.mark.parametrize("case", ["random", "empty_group", "nan_row",
                                  "zero_weights"])
def test_aggregate_tier_equals_its_former_route(case):
    rng = np.random.default_rng(4)
    m, G = 60, 6
    W = {"w": rng.standard_normal((m, 7, 9)).astype(np.float32),
         "b": rng.standard_normal((m, 9)).astype(np.float32),
         "s": rng.standard_normal((m,)).astype(np.float32)}
    H = rng.integers(0, 9, m).astype(np.float32)
    gids = rng.integers(0, G, m)
    if case == "empty_group":
        gids[gids == 2] = 3
    elif case == "nan_row":
        W["w"][np.nonzero(gids == 1)[0][0]] = np.nan
    elif case == "zero_weights":
        H[gids == 4] = 0
    Wt = {k: torch.from_numpy(v) for k, v in W.items()}
    Ht = torch.from_numpy(H)
    got, Hg = teng.aggregate_tier(Wt, Ht, gids, G)
    want, Hg_want = _aggregate_tier_flat(Wt, Ht, gids, G)
    assert torch.equal(Hg, Hg_want)
    for k in W:
        assert got[k].shape == (G,) + W[k].shape[1:]
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    if case == "nan_row":
        bad = torch.isnan(got["w"]).reshape(G, -1).any(1).numpy()
        np.testing.assert_array_equal(np.nonzero(bad)[0], [1])


def test_ops_rows_wrapper_matches_reference_shapes():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((30, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 4, 30).astype(np.int32)
    got = ops.segment_sum_rows(*_t(data, ids), num_segments=4)
    want = rops.segment_sum_rows(jnp.asarray(data), jnp.asarray(ids),
                                 num_segments=4, use_pallas=False)
    assert got.shape == want.shape == (4, 3, 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    one = ops.segment_sum_rows(torch.from_numpy(data[:, 0, 0].copy()),
                               torch.from_numpy(ids), num_segments=4)
    np.testing.assert_array_equal(
        _bits(one), _bits(rops.segment_sum_rows(
            jnp.asarray(data[:, 0, 0]), jnp.asarray(ids), num_segments=4)))


@pytest.mark.parametrize("bad", ["data_dtype", "data_1d", "rows", "scale",
                                 "scale_dtype", "device", "layout"])
def test_rows_wrapper_rejects_bad_arguments(bad):
    data = torch.ones((8, 3))
    ids = torch.arange(8, dtype=torch.int32) % 4
    kw, err = {}, ValueError
    if bad == "data_dtype":
        data, err = data.double(), TypeError
    elif bad == "data_1d":
        data = data[:, 0]
    elif bad == "rows":
        data = data[:5]
    elif bad == "scale":
        kw["scale"] = torch.ones(7)
    elif bad == "scale_dtype":
        kw["scale"], err = torch.ones(8, dtype=torch.float64), TypeError
    elif bad == "device":
        data = data.to("meta")
    else:
        kw["layout"] = sr.segment_layout(ids, 5)
    with pytest.raises(err):
        sr.segment_sum_rows(data, ids, 4, **kw)


def test_rows_on_cpu_never_launch():
    data, ids, G, scale = _row_case("random", 6)
    d, i, h = _t(data, ids, scale)
    before = sr.launches
    got = sr.segment_sum_rows(d, i, G, scale=h,
                              layout=sr.segment_layout(i, G))
    assert torch.equal(got, sr.segment_sum_rows_plain(d, i, G, scale=h))
    assert sr.launches == before


# --- numpy replays of the CUDA kernels' indexing --------------------------

def _row_geometry(P, base_off):
    """The row kernel's launch: the vector width at which every row of
    data (``base_off`` floats past a 16-B boundary) starts aligned, the
    vectors a row, threads a block and tiles a group."""
    vec = (4 if P % 4 == 0 and base_off % 4 == 0 else
           2 if P % 2 == 0 and base_off % 2 == 0 else 1)
    nvec = P // vec
    threads = min(THREADS, -(-nvec // 32) * 32)
    return vec, nvec, threads, -(-nvec // threads)


def _replay_rows(storage, base_off, P, layout, G, scale):
    """The row kernel, block by block: a thread's columns c·vec ..
    c·vec + vec - 1, members staged 256 at a time, U loads then U
    adds, every address computed as the kernel computes it."""
    perm, offsets = layout.perm.numpy(), layout.offsets.numpy()
    vec, nvec, T, tiles = _row_geometry(P, base_off)
    U = 8 if vec == 4 else 16
    out = np.full(G * P, np.nan, np.float32)
    written = np.zeros(G * P, np.int64)
    lanes = np.arange(vec)[None]
    for blk in range(G * tiles):
        g, tile = divmod(blk, tiles)
        c = tile * T + np.arange(T)
        ca = c[c < nvec]
        cols = (ca * vec)[:, None] + lanes
        acc = np.zeros(cols.shape, np.float32)
        for base in range(offsets[g], offsets[g + 1], ROW_MEMBERS):
            n = min(ROW_MEMBERS, offsets[g + 1] - base)
            s_idx = perm[base:base + n]
            for k in range(0, n, U):
                xs = [storage[base_off + int(s_idx[k + u]) * nvec * vec
                              + cols] for u in range(U) if k + u < n]
                with np.errstate(invalid="ignore"):    # inf · 0
                    for u, x in enumerate(xs):
                        acc = acc + (x if scale is None
                                     else x * scale[s_idx[k + u]])
        addr = g * nvec * vec + cols
        out[addr] = acc
        written[addr] += 1
    assert (written == 1).all()
    return out.reshape(G, P)


@pytest.mark.parametrize("P,base_off", [
    (12, 0), (13, 0), (14, 0), (15, 0), (12, 1), (12, 2), (14, 1),
    (16, 3), (1, 0), (1031, 0), (1032, 2), (2000, 0)])
@pytest.mark.parametrize("scaled", [False, True])
def test_row_kernel_walk_replay_equals_plain(P, base_off, scaled):
    """Vector width by alignment (P % 4 in 0..3, unaligned bases), tiles
    and their ragged last tile, a group of 600 members (three staged
    chunks, an unrolled tail), an empty group, out-of-range rows."""
    rng = np.random.default_rng(P + base_off)
    G = 4
    ids = np.concatenate([np.zeros(600, np.int64),
                          rng.choice([1, 3, -1, 9], 45)])
    rng.shuffle(ids)
    ids = ids.astype(np.int32)
    m = ids.shape[0]
    storage = rng.standard_normal(base_off + m * P).astype(np.float32)
    storage[base_off + 7 * P + P // 2] = np.inf
    scale = rng.integers(0, 5, m).astype(np.float32) if scaled else None
    data = storage[base_off:].reshape(m, P)
    t_ids = torch.from_numpy(ids)
    layout = sr.segment_layout(t_ids, G)
    got = _replay_rows(storage, base_off, P, layout, G, scale)
    want = sr.segment_sum_rows_plain(
        torch.from_numpy(data.copy()), t_ids, G,
        scale=None if scale is None else torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not want[2].any()                 # the empty group


def _replay_1d(data, layout, op, K, wide_min):
    """The 1-D kernel, block by block: offsets staged; thread t owns the
    block's segments t, t + THREADS, ... (K of them); those of at most K
    elements summed in lockstep (a step takes one element of each),
    longer ones walked alone UNROLL elements a step, then each warp's
    wide segments gathered CHUNK at a time, lane 0 adding in order."""
    perm, offsets = layout.perm.numpy(), layout.offsets.numpy()
    S = layout.num_segments
    ident = np.float32(0.0 if op == "sum" else -np.inf)

    def apply(acc, x):
        if op == "sum":
            return np.float32(acc + x)
        return x if (x > acc or x != x) else acc

    def walk(lo, hi):
        acc = ident
        for k in range(lo, hi, UNROLL):
            x = [data[perm[k + j]] for j in range(UNROLL) if k + j < hi]
            for v in x:
                acc = apply(acc, v)
        return acc

    def warp_walk(lo, hi):
        n, acc = hi - lo, ident
        for base in range(0, n, CHUNK):
            buf = np.zeros(CHUNK, np.float32)
            for j in range(STAGE):
                for lane in range(32):
                    k = base + j * 32 + lane
                    if k < n:
                        buf[j * 32 + lane] = data[perm[lo + k]]
            for e in range(min(CHUNK, n - base)):
                acc = apply(acc, buf[e])
        return acc

    out = np.full(S, np.nan, np.float32)
    written = np.zeros(S, np.int64)
    per_block = THREADS * K
    for b in range(-(-S // per_block)):
        first = b * per_block
        cnt = min(per_block, S - first)
        so = offsets[first:first + cnt + 1]

        def emit(s, v):
            out[first + s] = v
            written[first + s] += 1

        wide = [[] for _ in range(THREADS)]
        for t in range(THREADS):
            segs = [t + j * THREADS for j in range(K) if t + j * THREADS < cnt]
            n = [so[s + 1] - so[s] for s in segs]
            short = [j for j in range(len(segs)) if n[j] <= K]
            acc = {j: ident for j in short}
            for r in range(max([n[j] for j in short], default=0)):
                x = {j: data[perm[so[segs[j]] + r]] for j in short
                     if r < n[j]}
                for j, v in x.items():
                    acc[j] = apply(acc[j], v)
            for j in short:
                emit(segs[j], acc[j])
            for j, s in enumerate(segs):
                if j in short:
                    continue
                if n[j] <= wide_min:
                    emit(s, walk(so[s], so[s + 1]))
                else:
                    wide[t].append(s)
        for t in range(THREADS):            # warp by warp, lane order
            for s in wide[t]:
                emit(s, warp_walk(so[s], so[s + 1]))
    assert (written == 1).all()
    return out


def _segments(kind, rng):
    """(data f32, ids int32, S) for the 1-D walk replays."""
    if kind == "one_element":               # per-cell sample counts
        S = 3000
        ids = np.repeat(np.arange(S), rng.poisson(1.0, S))
        data = np.ones(ids.shape[0], np.float32)
        return data, ids.astype(np.int32), S
    if kind == "wide":                      # wide, with short neighbours
        lens = [5, 2100, 0, 3, 2049, 2048, 700, 4100, 1]
        S = len(lens) + 2
        ids = np.repeat(np.arange(len(lens)), lens)
        rng.shuffle(ids)
    elif kind == "mixed":
        S = 900
        ids = rng.integers(-4, S + 4, 6000)
    elif kind == "tier":                    # a stacked leaf's g·P + p
        G, P = 3, 700
        g = rng.integers(0, G, 40)
        S = G * P
        ids = (g[:, None] * P + np.arange(P)[None]).reshape(-1)
    else:                                   # empty runs between segments
        S = 2500
        ids = rng.choice(np.arange(0, S, 13), 4000)
    data = rng.standard_normal(ids.shape[0]).astype(np.float32)
    if kind == "mixed":
        data[rng.integers(0, data.shape[0], 3)] = [np.nan, np.inf, -np.inf]
    return data, ids.astype(np.int32), S


@pytest.mark.parametrize("kind,K,wide_min", [
    ("one_element", 1, WIDE_MIN), ("one_element", 8, WIDE_MIN),
    ("one_element", 3, WIDE_MIN), ("wide", 1, WIDE_MIN),
    ("wide", 4, WIDE_MIN), ("wide", 2, 6), ("mixed", 8, WIDE_MIN),
    ("mixed", 5, 4), ("sparse", 2, WIDE_MIN), ("sparse", 8, 1),
    ("tier", 1, WIDE_MIN), ("tier", 4, WIDE_MIN), ("tier", 3, 12)])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_segment_kernel_walk_replay_equals_plain(kind, K, wide_min, op):
    """Several segments a thread (short ones in lockstep), segments that
    span unrolled steps, empty and out-of-range ones, NaN and inf, and
    wide segments staged by the warp (tails of every chunk length)."""
    data, ids, S = _segments(kind, np.random.default_rng(len(kind) + K))
    t_data, t_ids = torch.from_numpy(data), torch.from_numpy(ids)
    layout = sr.segment_layout(t_ids, S)
    got = _replay_1d(data, layout, op, K, wide_min)
    plain = sr.segment_sum_plain if op == "sum" else sr.segment_max_plain
    want = plain(t_data, t_ids, S).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
