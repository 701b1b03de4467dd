"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port (the machine with the card has no
JAX), so it runs there as ``python -m pytest -q tests/test_torch_kernels_cuda.py``.
Without CUDA every test skips: a CUDA kernel has no CPU mode. Policy as in
PERF.md: hash64 and voronoi_assign bitwise (the kernel repeats the plain
version's rounding), st_scan count/min/max bitwise and sum to rtol 1e-5;
flash_attention to 2e-5 in fp32 (the same online softmax, summed in another
order) and 1e-2 in bf16 (one bf16 ulp of outputs of order 1 is 0.0078; the
kernel's tensor-core sums and the plain version's differ in order), for
all three bf16 kernels (``-k "flash or sm90 or decode"`` runs these
alone). The split-KV decode kernel is also held, at 1e-2, to its own plain
version (``flash_decode_split_ref``) at the splits the wrapper chose. The sm90
kernel's layout probe is held to ``torch.matmul`` in fp32 at 1e-4 relative
(the same bf16 products, summed in another order). ``-k repair`` runs the
fail/recover/repair tests: a wrapping outage scenario on the card against
the CPU (every leaf and every repair's telemetry bitwise), deferred flips
that make no sync, and the placement kernels at a full repair's batch.
``-k "partition or pipeline"`` runs the partition flips (no sync) and the
streaming pipeline on the card: a non-blocking flush from numpy against
``ingest_rounds`` from the card (syncs), and an adversarial stream with NaN
payloads against the CPU (every leaf bitwise). ``-k chaos`` runs the chaos
engine's fault plans through a session and pipeline on the card against
the same plans on the CPU: the reference tests' smoke plan, and a cut
across the failure-domain blocks overlapping a domain loss and its
recovery (every leaf bitwise, the runners' logs byte-identical).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hashing, voronoi
from repro_torch.core.datastore import make_pred
from repro_torch.data.synthetic import CityConfig, make_sites
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_decode_split_ref)
from repro_torch.kernels.hash64 import ops as hops
from repro_torch.kernels.st_scan import ops as st_ops
from repro_torch.kernels.st_scan import ref as st_ref
from repro_torch.kernels.voronoi_assign import ops as vops
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_map
from repro_torch.train.train_loop import make_serve_steps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(rng, n):
    return rng.integers(-2**31, 2**31, n).astype(np.int32)


def test_hash64_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    hi = torch.from_numpy(_i32(rng, 100_000)).to(cuda)
    lo = torch.from_numpy(_i32(rng, 100_000)).to(cuda)
    before = hops.launches
    for n in (1, 8, 80, 65535):
        for h in (hi, None):
            assert torch.equal(hops.xxh64_mod(h, lo, n),
                               hashing.xxh64_mod_plain(h, lo, n))
    assert hops.launches == before + 8


HASH_MODS = (1, 8, 80, 65521, 65535)


def _hash_check(hi, lo, n_edges):
    """One launch (none for no keys), bitwise equal to the plain version."""
    before = hops.launches
    got = hops.xxh64_mod_cuda(hi, lo, n_edges)
    assert hops.launches == before + (lo.numel() > 0)
    want = hashing.xxh64_mod_plain(hi, lo, n_edges)
    assert got.dtype == torch.int32 and got.shape == lo.shape
    assert torch.equal(got, want), int((got != want).sum())
    return got


@pytest.mark.parametrize("n", [0, 1, 3, 400, 6400, (1 << 20) + 3])
def test_hash64_redesign_sizes(cuda, n):
    rng = np.random.default_rng(20 + n % 1000)
    hi = torch.from_numpy(_i32(rng, n)).to(cuda)
    lo = torch.from_numpy(_i32(rng, n)).to(cuda)
    for n_edges in HASH_MODS:
        _hash_check(hi, lo, n_edges)
        _hash_check(None, lo, n_edges)


def test_hash64_redesign_views_at_every_offset(cuda):
    rng = np.random.default_rng(21)
    hi = torch.from_numpy(_i32(rng, 7000)).to(cuda)
    lo = torch.from_numpy(_i32(rng, 7000)).to(cuda)
    for n_edges in HASH_MODS:
        for a in range(4):
            _hash_check(None, lo[a:a + 6401], n_edges)
            for b in range(4):          # hi and lo at their own offsets
                _hash_check(hi[b:b + 6401], lo[a:a + 6401], n_edges)
                _hash_check(hi[b:b + 3], lo[a:a + 3], n_edges)
        _hash_check(hi[1::2], lo[1::2], n_edges)       # not contiguous
        _hash_check(None, lo[:6400].reshape(400, 16).t(), n_edges)
        _hash_check(hi[:400].reshape(20, 20), lo[:400].reshape(20, 20), n_edges)


def test_hash64_redesign_converts_other_dtypes(cuda):
    rng = np.random.default_rng(22)
    wide = torch.from_numpy(rng.integers(-2**40, 2**40, 6400)).to(cuda)
    _hash_check(wide[:400], wide[400:800], 80)      # int64: the low 32 bits
    _hash_check(None, wide, 80)


def test_hash64_redesign_follows_the_current_stream(cuda):
    rng = np.random.default_rng(23)
    lo = torch.from_numpy(_i32(rng, 6400)).to(cuda)
    want = hashing.xxh64_mod_plain(None, lo, 80)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = hops.launches
    with torch.cuda.stream(side):
        got = hops.xxh64_mod_cuda(None, lo, 80)
        lo.record_stream(side)
    side.synchronize()
    assert hops.launches == before + 1
    assert torch.equal(got, want)


def test_hash64_redesign_refuses_more_keys_than_a_c_int(cuda):
    wide = torch.zeros(1, dtype=torch.int32, device=cuda).expand(1 << 31)
    before = hops.launches
    with pytest.raises(ValueError, match="2\\^31"):
        hops.xxh64_mod_cuda(None, wide, 80)
    assert hops.launches == before


def test_hash64_launch_floor_counts_nothing(cuda):
    before = hops.launches
    hops.launch_floor(6400, cuda)           # a device with no index
    torch.cuda.synchronize()
    assert hops.launches == before


def test_hash64_redesign_repeatable(cuda):
    rng = np.random.default_rng(24)
    hi = torch.from_numpy(_i32(rng, 6400)).to(cuda)
    lo = torch.from_numpy(_i32(rng, 6400)).to(cuda)
    first = hops.xxh64_mod_cuda(hi, lo, 80)
    for _ in range(3):
        assert torch.equal(hops.xxh64_mod_cuda(hi, lo, 80), first)


def test_voronoi_kernel_matches_plain(cuda):
    rng = np.random.default_rng(10)
    city = CityConfig()
    sites = torch.from_numpy(make_sites(80, city, seed=3)).to(cuda)
    pts = torch.from_numpy(rng.uniform([city.lat_min, city.lon_min],
                                       [city.lat_max, city.lon_max],
                                       (50_000, 2)).astype(np.float32)).to(cuda)
    before = vops.launches
    got = voronoi.hash_spatial(pts[:, 0], pts[:, 1], sites)
    assert vops.launches == before + 1
    assert torch.equal(got, voronoi.voronoi_assign(pts, sites))


def _vor_check(lat, lon, sites):
    """One launch, bitwise equal to the plain version on every point."""
    before = vops.launches
    got = vops.voronoi_assign_cuda(lat, lon, sites)
    assert vops.launches == before + 1
    want = voronoi.voronoi_assign(torch.stack([lat.reshape(-1), lon.reshape(-1)], -1),
                                  sites).reshape(lat.shape)
    assert torch.equal(got, want), int((got != want).sum())
    return got


def _city_points(rng, n, dev, spill=0.2):
    """Uniform over the city widened by ``spill`` of its extent each side,
    so some points fall outside the kernel's cell grid."""
    c = CityConfig()
    lo = np.array([c.lat_min, c.lon_min])
    span = np.array([c.lat_max, c.lon_max]) - lo
    pts = rng.uniform(lo - spill * span, lo + (1 + spill) * span, (n, 2))
    return torch.from_numpy(pts.astype(np.float32)).to(dev)


@pytest.mark.parametrize("e", [1, 2, 80, 1000])
@pytest.mark.parametrize("n", [1, 3, 257, 102401])
def test_voronoi_redesign_matches_plain(cuda, n, e):
    rng = np.random.default_rng(n + e)
    sites = torch.from_numpy(make_sites(e, CityConfig(), seed=e)).to(cuda)
    pts = _city_points(rng, n, cuda)
    _vor_check(pts[:, 0].contiguous(), pts[:, 1].contiguous(), sites)


def test_voronoi_redesign_reads_views_at_any_offset(cuda):
    rng = np.random.default_rng(11)
    sites = torch.from_numpy(make_sites(80, CityConfig(), seed=3)).to(cuda)
    buf = _city_points(rng, 4099, cuda)
    lat, lon = buf[:, 0].contiguous(), buf[:, 1].contiguous()
    _vor_check(lat[1:], lon[1:], sites)                # 4-byte offset
    _vor_check(lat[1:4097], lon[2:4098], sites)         # two offsets
    _vor_check(lat[3:].reshape(16, 256), lon[3:].reshape(16, 256), sites)
    grid = lat[:256].reshape(16, 16).t()                # not contiguous
    _vor_check(grid, lon[:256].reshape(16, 16), sites)
    _vor_check(lat[:1000].double(), lon[:1000].double(), sites)


def test_voronoi_redesign_duplicate_sites_lowest_index(cuda):
    rng = np.random.default_rng(12)
    sites = torch.from_numpy(make_sites(80, CityConfig(), seed=3)).to(cuda)
    sites[40] = sites[7]
    sites[79] = sites[7]
    sites[41] = sites[0]
    pts = torch.cat([_city_points(rng, 20_000, cuda), sites[[7, 0, 40, 41, 79]]])
    got = _vor_check(pts[:, 0].contiguous(), pts[:, 1].contiguous(), sites)
    assert got[-5:].tolist() == [7, 0, 7, 0, 7]


def test_voronoi_redesign_centroid_and_subnormal_products(cuda):
    rng = np.random.default_rng(13)
    # Sites near the origin at 1e-20: the centred coordinates and the points'
    # offsets multiply to subnormal products.
    tiny = torch.from_numpy(rng.normal(0, 1e-20, (80, 2)).astype(np.float32)).to(cuda)
    city = torch.from_numpy(make_sites(80, CityConfig(), seed=3)).to(cuda)
    for sites in (tiny, city):
        c, _, _ = voronoi.centred_sites(sites)
        off = torch.tensor([[0.0, 0.0], [1e-19, 0.0], [0.0, 1e-19], [-1e-19, 0.0],
                            [0.0, -1e-19], [1e-38, 1e-38]], device=cuda)
        near = c + torch.from_numpy(rng.normal(0, 3e-20, (5000, 2)).astype(np.float32)).to(cuda)
        pts = torch.cat([c + off, c.expand(3, 2), near])
        _vor_check(pts[:, 0].contiguous(), pts[:, 1].contiguous(), sites)


def test_voronoi_redesign_nan_and_infinite_points(cuda):
    rng = np.random.default_rng(14)
    sites = torch.from_numpy(make_sites(80, CityConfig(), seed=3)).to(cuda)
    pts = _city_points(rng, 300, cuda)
    pts[0, 0] = float("nan")
    pts[1, 1] = float("nan")
    pts[2] = float("nan")
    pts[3, 0], pts[4, 1], pts[5, 0] = float("inf"), -float("inf"), 3e38
    got = _vor_check(pts[:, 0].contiguous(), pts[:, 1].contiguous(), sites)
    assert got[:3].tolist() == [0, 0, 0]


def test_voronoi_redesign_repeatable(cuda):
    rng = np.random.default_rng(15)
    sites = torch.from_numpy(make_sites(80, CityConfig(), seed=3)).to(cuda)
    pts = _city_points(rng, 102_400, cuda)
    lat, lon = pts[:, 0].contiguous(), pts[:, 1].contiguous()
    assert torch.equal(vops.voronoi_assign_cuda(lat, lon, sites),
                       vops.voronoi_assign_cuda(lat, lon, sites))


def test_voronoi_redesign_follows_edited_and_new_sites(cuda):
    """The packed sites are cached per site tensor: an in-place edit and a
    new tensor must both be seen, or these answers go stale."""
    rng = np.random.default_rng(16)
    sites = torch.from_numpy(make_sites(80, CityConfig(), seed=3)).to(cuda)
    pts = _city_points(rng, 50_000, cuda)
    lat, lon = pts[:, 0].contiguous(), pts[:, 1].contiguous()
    first = _vor_check(lat, lon, sites)
    sites.copy_(sites.flip(0))                          # in place: _version moves
    second = _vor_check(lat, lon, sites)
    assert not torch.equal(first, second)
    other = torch.from_numpy(make_sites(80, CityConfig(), seed=5)).to(cuda)
    _vor_check(lat, lon, other)


@pytest.mark.parametrize("q,channels", [(3, (0,)), (9, (0, 1, 2, 3)),
                                        (5, (2, 0, 3)), (8, (0, 1, 2, 3, 4, 5))])
def test_st_scan_kernel_matches_plain(cuda, q, channels):
    rng = np.random.default_rng(q)
    e, w, c, l = 6, 9, 3000, 16
    t = lambda x: torch.from_numpy(x).to(cuda)
    args = (t(rng.uniform(0, 100, (e, w, c)).astype(np.float32)),
            t(rng.integers(0, 6, (e, 2, c)).astype(np.int32)),
            t(rng.integers(0, 2 * c, e).astype(np.int32)),
            make_pred(q=q, lat0=rng.uniform(0, 50, q), lat1=rng.uniform(50, 100, q),
                      lon0=rng.uniform(0, 50, q), lon1=rng.uniform(50, 100, q),
                      t0=rng.uniform(0, 50, q), t1=rng.uniform(50, 100, q),
                      sid_hi=rng.integers(0, 6, q), sid_lo=rng.integers(0, 6, q),
                      has_spatial=rng.random(q) < 0.7,
                      has_temporal=rng.random(q) < 0.7,
                      has_sid=rng.random(q) < 0.3, is_and=rng.random(q) < 0.7,
                      device=cuda),
            t(rng.integers(0, 6, (q, e, l, 2)).astype(np.int32)),
            t(rng.integers(-1, l + 1, (q, e)).astype(np.int32)))
    before = st_ops.launches
    got = st_ops.st_scan(*args, channels=channels, valid_c=2900)
    assert st_ops.launches == before + -(-len(channels) // st_ops.MAX_K)
    want = st_ref.st_scan_ref(*args, channels=channels, valid_c=2900)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


SHARD = 60          # records of one shard, on consecutive slots of the log


def _shard_log_problem(rng, dev, q, e=6, w=9, c=5000, l=16, roll=0,
                       nan_share=0.0):
    """A scan problem laid out as the store writes its log: each shard's 60
    records on consecutive slots under one (drone, round) sid, so the log is
    runs of 60 equal sids that every 1024-slot boundary cuts (60 divides no
    multiple of 1024 below 15360), t rising round by round (15 shards a
    round), positions near the shard's drone. ``roll`` rolls every edge's
    slots, so t falls back mid-log, as in a wrapped ring. ``nan_share`` of
    the channel words and half that share of the t/lat/lon words are NaN.
    Queries mix AND and OR predicates; their OR-lists hold sids of the
    edge's own shards and absent ones, with lengths -1, 0, 1, L and between.
    Edge 0 holds no tuple and edge 1 a count above capacity."""
    slot = np.arange(c)
    run = (slot[None, :] + rng.integers(0, SHARD, (e, 1))) // SHARD  # (E, C)
    rnd = run // 15
    drone = rng.integers(0, 40, run.max() + 1)[run]
    centre = rng.uniform(0, 100, (40, 2))
    rec = (slot[None, :] + run) % SHARD
    f = rng.uniform(0, 100, (e, w, c)).astype(np.float32)
    f[:, 0] = rnd * 300.0 + rec * 5.0 + rng.uniform(0, 1, (e, c))
    f[:, 1] = centre[drone, 0] + rng.normal(0, 2, (e, c))
    f[:, 2] = centre[drone, 1] + rng.normal(0, 2, (e, c))
    sid = np.stack([drone, rnd], 1).astype(np.int32)                 # (E, 2, C)
    if nan_share:
        f[:, 3:][rng.random((e, w - 3, c)) < nan_share] = np.nan
        f[:, :3][rng.random((e, 3, c)) < nan_share / 2] = np.nan
    f = np.roll(f, roll, axis=2)
    sid = np.roll(sid, roll, axis=2)
    count = rng.integers(c // 2, 2 * c, e).astype(np.int32)
    count[0], count[1] = 0, 3 * c

    # Each query is centred on a live slot with finite fields, whose sid
    # heads the query's list on that edge; query 0 is an AND of bbox and
    # window, so every batch matches something.
    finite = np.isfinite(f[:, :3]).all(axis=1)
    finite[:2] = False
    finite[:, c // 2:] = False
    pe, ps = np.nonzero(finite)
    pick = rng.integers(0, len(pe), q)
    pe, ps = pe[pick], ps[pick]
    win = rng.choice([300.0, 900.0, 1800.0], q)
    t0 = f[pe, 0, ps] - rng.uniform(0, 1, q) * win
    half = rng.uniform(3, 30, q)
    is_and = rng.random(q) < 0.75
    has_s, has_t = rng.random(q) < 0.8, rng.random(q) < 0.8
    is_and[0] = has_s[0] = has_t[0] = True
    pred = make_pred(q=q, lat0=f[pe, 1, ps] - half, lat1=f[pe, 1, ps] + half,
                     lon0=f[pe, 2, ps] - half, lon1=f[pe, 2, ps] + half,
                     t0=t0, t1=t0 + win, sid_hi=sid[pe, 0, ps],
                     sid_lo=sid[pe, 1, ps], has_spatial=has_s,
                     has_temporal=has_t,
                     has_sid=rng.random(q) < np.where(is_and, 0.1, 0.3),
                     is_and=is_and, device=dev)
    own = rng.integers(0, c, (q, e, l))
    subl = sid[np.arange(e)[None, :, None], :, own]                  # (Q, E, L, 2)
    absent = rng.random((q, e, l)) < 0.3
    subl[absent] = rng.integers(1000, 2000, (int(absent.sum()), 2))
    slen = rng.choice([-1, 0, 1, l, 0, 1, l // 2, l - 3], (q, e)).astype(np.int32)
    subl[np.arange(q), pe, 0] = sid[pe, :, ps]
    slen[np.arange(q), pe] = rng.choice([-1, 1, l], q)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (t(f), t(sid), t(count), pred, t(subl.astype(np.int32)), t(slen))


def _nan_in_matched(args, n_ch, valid_c):
    """NaN into a requested channel of every 5th slot some query matches."""
    hit = st_ref.matched_slots(*args, valid_c=valid_c).nonzero()[::5]
    args[0][hit[:, 0], 3 + hit[:, 1] % n_ch, hit[:, 1]] = float("nan")


def _assert_scan_policy(got, want):
    """count, vmin and vmax bitwise (NaN where the plain version has NaN),
    vsum to rtol 1e-5 (another summation order)."""
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0, equal_nan=True)
    for g, x in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, x, rtol=0, atol=0, equal_nan=True)


def _bits(out):
    return [x.view(torch.int32) for x in out]


@pytest.mark.parametrize("n_ch", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("q", [1, 7, 65])
def test_st_scan_shard_log_matches_plain(cuda, q, n_ch):
    """The store's log layout with NaN channel words in matched and
    unmatched slots; a second call gives the same bits."""
    rng = np.random.default_rng(100 * q + n_ch)
    args = _shard_log_problem(rng, cuda, q, nan_share=0.01)
    channels = tuple(range(n_ch))
    valid_c = 4963                      # C = 5000: lane padding above it
    _nan_in_matched(args, n_ch, valid_c)
    before = st_ops.launches
    got = st_ops.st_scan(*args, channels=channels, valid_c=valid_c)
    assert st_ops.launches == before + -(-n_ch // st_ops.MAX_K)
    want = st_ref.st_scan_ref(*args, channels=channels, valid_c=valid_c)
    assert int(want[0].sum()) > 0 and torch.isnan(want[2]).any()
    _assert_scan_policy(got, want)
    again = st_ops.st_scan(*args, channels=channels, valid_c=valid_c)
    assert all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(again)))


@pytest.mark.parametrize("roll", [1, 2500, 4999])
def test_st_scan_wrapped_ring_matches_plain(cuda, roll):
    """A rolled log (t falls back mid-tile) whose counts exceed capacity."""
    rng = np.random.default_rng(roll)
    args = list(_shard_log_problem(rng, cuda, 20, c=6000, roll=roll,
                                   nan_share=0.002))
    args[2] = torch.full_like(args[2], 7 * 6000)
    _nan_in_matched(args, 2, 6000)
    got = st_ops.st_scan(*args, channels=(0, 3), valid_c=6000)
    want = st_ref.st_scan_ref(*args, channels=(0, 3), valid_c=6000)
    assert int(want[0].sum()) > 0 and torch.isnan(want[2]).any()
    _assert_scan_policy(got, want)


def test_st_scan_lists_of_no_entries(cuda):
    """L = 0: a list length above 0 admits no slot, a negative one scans
    all, 0 selects nothing."""
    rng = np.random.default_rng(5)
    f, sid, count, pred, _, _ = _shard_log_problem(rng, cuda, 3)
    subl = torch.zeros((3, 6, 0, 2), dtype=torch.int32, device=cuda)
    slen = torch.tensor([[3] * 6, [-1] * 6, [0] * 6], dtype=torch.int32,
                        device=cuda)
    args = (f, sid, count, pred, subl, slen)
    got = st_ops.st_scan(*args, channels=(0, 1))
    want = st_ref.st_scan_ref(*args, channels=(0, 1))
    assert int(want[0][0].sum()) == 0 and int(want[0][1].sum()) > 0
    _assert_scan_policy(got, want)


def test_st_scan_nan_in_one_matched_slot(cuda):
    """The smallest input of the NaN contract: one matched slot holds NaN,
    so that query's min, max and sum are NaN; an empty query stays
    (0, +inf, -inf)."""
    c = 64
    f = torch.ones((1, 4, c), device=cuda)
    f[0, 3, 10] = float("nan")
    sid = torch.zeros((1, 2, c), dtype=torch.int32, device=cuda)
    count = torch.full((1,), c, dtype=torch.int32, device=cuda)
    pred = make_pred(q=2, lat0=[0, 5], lat1=[2, 6], lon0=[0, 0], lon1=[2, 2],
                     t0=[0, 0], t1=[2, 2], has_spatial=True, has_temporal=True,
                     is_and=True, device=cuda)
    subl = torch.zeros((2, 1, 4, 2), dtype=torch.int32, device=cuda)
    slen = torch.full((2, 1), -1, dtype=torch.int32, device=cuda)
    args = (f, sid, count, pred, subl, slen)
    got = st_ops.st_scan(*args, channels=(0,))
    _assert_scan_policy(got, st_ref.st_scan_ref(*args, channels=(0,)))
    assert got[0].tolist() == [[c], [0]]
    assert all(bool(torch.isnan(x[0, 0, 0])) for x in got[1:])
    assert got[2][1, 0, 0] == float("inf") and got[3][1, 0, 0] == -float("inf")


def test_wrappers_refuse_cpu_tensors_for_kernels(cuda):
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hops.xxh64_mod_cuda(None, x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        vops.voronoi_assign_cuda(x.float(), x.float(), torch.zeros(3, 2))


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _flash_case(cuda, dtype, b, sq, skv, h, kv, dh, causal, q_offset=0,
                seed=0, variant=None):
    """Kernel and plain version on the same seeded inputs; checks both the
    result and that exactly one launch was counted (of ``variant`` when it
    is forced)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, dtype) for shape in ((b, sq, h, dh), (b, skv, kv, dh),
                                              (b, skv, kv, dh)))
    before = fops.launches
    by_variant = dict(fops.launches_by_variant)
    if variant is None:
        got = fops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    else:
        got = fops.flash_attention_cuda(q, k, v, causal=causal,
                                        q_offset=q_offset, variant=variant)
        assert fops.launches_by_variant[variant] == by_variant[variant] + 1
    assert fops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == (b, sq, h, dh)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_flash_kernel_matches_plain(cuda, dtype, causal, h, kv, dh):
    _flash_case(cuda, dtype, 2, 200, 200, h, kv, dh, causal, seed=dh + h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_offset", [0, 1, 63, 64, 77, 191, 255])
def test_flash_kernel_decode_row(cuda, dtype, q_offset):
    """Sq == 1 over a 256-slot cache: attends to keys 0..q_offset. Forced
    onto the mma_sync kernel, which bf16 decode rows no longer reach by
    default, so that it stays held at Sq == 1."""
    _flash_case(cuda, dtype, 3, 1, 256, 16, 8, 128, True, q_offset, seed=q_offset,
                variant="mma_sync")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal", [(77, 131, True), (77, 131, False),
                                           (1, 1, True), (130, 5, False)])
def test_flash_kernel_ragged(cuda, dtype, sq, skv, causal):
    q_offset = max(skv - sq, 0) if causal else 0
    _flash_case(cuda, dtype, 2, sq, skv, 4, 2, 64, causal, q_offset, seed=sq)


def test_flash_kernel_reads_a_cache_slice_in_place(cuda):
    """A layer's slice of the (L, B, S, KV, d) cache goes in without a copy,
    and the kernel is bitwise deterministic across calls."""
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.standard_normal((3, 2, 96, 2, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k_l, v_l = cache[1], cache[2]
    got = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=50)
    again = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=50)
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k_l, v_l, causal=True, q_offset=50)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_flash_wrapper_refuses_what_the_kernel_lacks(cuda):
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_cuda(q, q, q, causal=True)
    for bad in (torch.zeros((1, 8, 2, 48), device=cuda),                 # d
                torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.half)):
        with pytest.raises(ValueError):
            fops.flash_attention_cuda(bad, bad, bad, causal=True)


# The smoke decoder's fp32 runs against its float64 run on the CPU. On the
# card (through the kernel) h sits 4.0e-6 from it, on the CPU (the plain
# version) 5.6e-6 (values up to 3.9; about sqrt(K) fp32 ulps a matmul
# through 4 layers); the bound is 3.6x the larger. The CPU's fp32 run is no
# reference: in 2 of 41 processes its first forward took rope's cos at
# about 11 bits for the half of the table that PyTorch's 2-thread loop gave
# one MKL vmsCos call, and ended 4.1e-4 away; none of 92 later forwards
# did (PERF.md §6). So the reference is made on one thread, after a
# forward that is thrown away.
SMOKE_F64_TOL = 2e-5


def test_smoke_model_on_card_matches_cpu(cuda):
    """The dense decoder through the kernel (forward and cached decode) in
    fp32, bitwise the same on a second forward, and within SMOKE_F64_TOL of
    the same model run in float64 on one CPU thread (its second forward)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("qwen3-14b")).replace(
        compute_dtype_str="float32")
    f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    params = f64.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    cparams = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 70)).astype(np.int32))
    before = fops.launches
    h_card, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    assert fops.launches == before + cfg.n_layers
    again, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    assert torch.equal(h_card, again)
    cg = card.init_cache(2, 70)
    for t in range(70):
        cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(cuda)}, t)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        f64.forward(params, {"tokens": toks})
        h_ref, _ = f64.forward(params, {"tokens": toks})
        cr = f64.init_cache(2, 70)
        for t in range(70):
            cr, lr = f64.decode_step(params, cr, {"tokens": toks[:, t:t + 1]}, t)
    finally:
        torch.set_num_threads(threads)
    tol = dict(rtol=SMOKE_F64_TOL, atol=SMOKE_F64_TOL)
    torch.testing.assert_close(h_card.cpu().double(), h_ref, **tol)
    torch.testing.assert_close(lg.cpu().double(), lr, **tol)


def test_sm90_probe_matches_matmul(cuda):
    """One warpgroup's S = Q K^T (K-major descriptors) and O = bf16(S) V
    (register A, MN-major V) through the kernel's TMA maps, against
    torch.matmul in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, torch.bfloat16) for shape in ((64, 128), (128, 128),
                                                       (128, 128)))
    s, o = fops.sm90_probe(q, k, v)
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(o, s.to(torch.bfloat16).float() @ v.float(),
                               rtol=1e-4, atol=1e-3)


# (b, sq, skv, h, kv, causal, q_offset), all d 128
SM90_CASES = [(1, 2048, 2048, 16, 8, True, 0),      # serve prefill, B 1
              (1, 64, 64, 4, 2, True, 0),
              (1, 128, 128, 4, 2, True, 0),
              (2, 200, 200, 4, 2, True, 0),
              (1, 2048, 2048, 4, 2, True, 0),
              (2, 77, 131, 4, 2, True, 54),         # ragged Sq and Skv
              (2, 77, 131, 4, 2, False, 0),
              (1, 100, 228, 4, 2, True, 128),       # q_offset 128
              (2, 200, 200, 4, 2, False, 0),        # bidirectional
              (2, 200, 200, 4, 4, True, 0),         # GQA group 1
              (2, 200, 200, 8, 4, True, 0),         # group 2
              (2, 200, 200, 8, 2, True, 0),         # group 4
              (2, 200, 200, 4, 1, True, 0)]         # MQA


@pytest.mark.parametrize("case", SM90_CASES, ids=str)
def test_flash_sm90_matches_plain(cuda, case):
    b, sq, skv, h, kv, causal, off = case
    _flash_case(cuda, torch.bfloat16, b, sq, skv, h, kv, 128, causal, off,
                seed=sq + h, variant="sm90")


def test_flash_sm90_cache_slice_in_place_and_repeatable(cuda):
    """A layer's slice of the (L, B, S, KV, d) cache goes in through its
    strides, and two calls give the same bits."""
    rng = np.random.default_rng(4)
    cache = torch.from_numpy(rng.standard_normal((3, 2, 256, 2, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 100, 4, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k_l, v_l = cache[1], cache[2]
    got = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=156,
                                    variant="sm90")
    again = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=156,
                                      variant="sm90")
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k_l, v_l, causal=True, q_offset=156)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_flash_sm90_matches_mma_sync(cuda):
    """Both bf16 kernels, forced, on the same inputs."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, torch.bfloat16) for shape in ((2, 333, 8, 128),
                                                       (2, 333, 2, 128),
                                                       (2, 333, 2, 128)))
    for causal in (True, False):
        a = fops.flash_attention_cuda(q, k, v, causal=causal, variant="sm90")
        b = fops.flash_attention_cuda(q, k, v, causal=causal,
                                      variant="mma_sync")
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2, atol=1e-2)


def test_flash_sm90_refuses_shapes_it_lacks(cuda):
    for dtype, sq, dh in ((torch.float32, 128, 128), (torch.bfloat16, 63, 128),
                          (torch.bfloat16, 128, 64)):
        x = torch.zeros((1, sq, 2, dh), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="sm90"):
            fops.flash_attention_cuda(x, x, x, causal=True, variant="sm90")


def test_prefill_step_sends_flash_to_sm90(cuda):
    """prefill_step on the smoke model at d_head 128 in bf16: every flash
    call goes to the sm90 kernel, and the logits are finite."""
    cfg = reduce_for_smoke(get_config("internlm2-1.8b")).replace(d_head=128)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prefill_step, _ = make_serve_steps(model)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 96)).astype(np.int32)).to(cuda)
    before = dict(fops.launches_by_variant)
    logits = prefill_step(params, {"tokens": toks})
    assert fops.launches_by_variant["sm90"] == before["sm90"] + cfg.n_layers
    assert fops.launches_by_variant["mma_sync"] == before["mma_sync"]
    assert logits.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the split-KV decode kernel
# ---------------------------------------------------------------------------

DECODE_ROWS = [(256, p) for p in (0, 1, 23, 24, 63, 64, 77, 191, 255)] \
    + [(4096, 4095)]


@pytest.mark.parametrize("skv,q_offset", DECODE_ROWS)
@pytest.mark.parametrize("g", [1, 2, 5, 8])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_decode_matches_plain(cuda, skv, q_offset, g, dh):
    """The decode kernel, as the wrapper chooses it, against the chunked
    plain version over the populated prefix of the cache."""
    before = fops.launches_by_variant["decode"]
    _flash_case(cuda, torch.bfloat16, 3, 1, skv, 2 * g, 2, dh, True, q_offset,
                seed=q_offset + g + dh)
    assert fops.launches_by_variant["decode"] == before + 1


@pytest.mark.parametrize("b,h,kv,dh,skv,q_offset", [
    (8, 16, 8, 128, 256, 191),      # internlm2-1.8b decode step
    (8, 16, 8, 128, 4096, 4095),    # long cache
    (2, 40, 8, 128, 256, 100),      # qwen3-14b heads, G 5
    (1, 16, 1, 32, 50, 7),          # G 16, d 32, 8 splits of one key
    (3, 4, 2, 64, 33, 32),          # a prefix one key past a tile
    (1, 2, 1, 128, 1, 0),           # one key
])
def test_flash_decode_matches_its_split_ref(cuda, b, h, kv, dh, skv, q_offset):
    """Against the plain version of the same partition and merge, at the
    splits the wrapper chose, and against the chunked plain version."""
    rng = np.random.default_rng(skv + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((b, 1, h, dh), (b, skv, kv, dh), (b, skv, kv, dh)))
    got = fops.flash_attention_cuda(q, k, v, causal=True, q_offset=q_offset,
                                    variant="decode")
    n_split = fops.decode_splits(b, kv, min(skv, q_offset + 1))
    split = flash_decode_split_ref(q, k, v, causal=True, q_offset=q_offset,
                                   n_split=n_split)
    torch.testing.assert_close(got.float(), split.float(), rtol=1e-2, atol=1e-2)
    want = flash_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_flash_decode_not_causal(cuda):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((2, 1, 8, 64), (2, 77, 2, 64), (2, 77, 2, 64)))
    got = fops.flash_attention_cuda(q, k, v, causal=False, variant="decode")
    want = flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_flash_decode_reads_a_cache_slice_in_place(cuda):
    """A layer's k and v slices of the (L, 2, B, max_seq, KV, d) cache and
    q of a (B, 1, 3, H, d) projection go in without a copy; two calls give
    the same bits."""
    rng = np.random.default_rng(5)
    cache = torch.from_numpy(rng.standard_normal((2, 2, 8, 256, 8, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    qkv = torch.from_numpy(rng.standard_normal((8, 1, 3, 16, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k_l, v_l = qkv[:, :, 0], cache[1, 0], cache[1, 1]
    before = fops.launches_by_variant["decode"]
    got = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=191)
    again = fops.flash_attention_cuda(q, k_l, v_l, causal=True, q_offset=191)
    assert fops.launches_by_variant["decode"] == before + 2
    assert torch.equal(got, again)
    want = flash_attention_ref(q, k_l, v_l, causal=True, q_offset=191)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_flash_decode_refuses_shapes_it_lacks(cuda):
    for sq, dtype in ((2, torch.bfloat16), (1, torch.float32)):
        x = torch.zeros((1, sq, 2, 128), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="decode"):
            fops.flash_attention_cuda(x, x, x, causal=True, variant="decode")


def test_generate_sends_decode_to_the_decode_kernel(cuda):
    """Engine.generate on the smoke model at d_head 128 in bf16: every flash
    call (Sq == 1, prompt and new tokens) goes to the decode kernel; a
    prefill_step on the same model goes to the sm90 kernel."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = reduce_for_smoke(get_config("internlm2-1.8b")).replace(d_head=128)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    engine = Engine(model, params, ServeConfig(max_new_tokens=6, max_seq=96))
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 70)).astype(np.int32)
    before = dict(fops.launches_by_variant)
    ids = engine.generate(prompts)
    after = dict(fops.launches_by_variant)
    assert after["decode"] - before["decode"] == cfg.n_layers * (70 + 6)
    assert after["mma_sync"] == before["mma_sync"]
    assert after["sm90"] == before["sm90"]
    assert np.array_equal(ids, engine.generate(prompts))
    prefill_step, _ = make_serve_steps(model)
    prefill_step(engine.params, {"tokens": torch.from_numpy(prompts).to(cuda)})
    assert fops.launches_by_variant["sm90"] == after["sm90"] + cfg.n_layers
    assert fops.launches_by_variant["decode"] == after["decode"] + cfg.n_layers * (70 + 6)


# -- the random planner's threefry draw on the card ---------------------------
# Not a kernel of its own: plain torch ops on either device, held bitwise to
# the CPU's (bits, uniforms) and, for the plans, away from near-ties of the
# gumbels (torch's log on the card and on the host may differ by ulps).

def _word_bits(x: torch.Tensor) -> torch.Tensor:
    x = x.cpu()
    return x.view(torch.int32) if x.is_floating_point() else x


def test_threefry_on_card_matches_cpu(cuda):
    from repro_torch.core import threefry
    key = threefry.key(42)
    for fn in (threefry.random_bits, threefry.uniform):
        got = fn(key, (64, 128, 3), device=cuda)
        assert got.device.type == cuda.type
        want = fn(key, (64, 128, 3), device="cpu")
        assert torch.equal(_word_bits(got), _word_bits(want))
    qkeys = threefry.fold_in(key, torch.arange(64, device=cuda))
    assert torch.equal(qkeys.cpu(), threefry.fold_in(key, torch.arange(64)))
    got = threefry.uniform(qkeys, (128, 3), threefry.F32_TINY)
    want = threefry.uniform(qkeys.cpu(), (128, 3), threefry.F32_TINY)
    assert torch.equal(_word_bits(got), _word_bits(want))
    g = threefry.gumbel(qkeys, (128, 3)).cpu()
    torch.testing.assert_close(g, threefry.gumbel(qkeys.cpu(), (128, 3)),
                               rtol=0, atol=1e-5)


def test_plan_random_on_card_matches_cpu(cuda):
    from repro_torch.core import planner, threefry
    from repro_torch.core.index import MatchedShards
    rng = np.random.default_rng(8)
    q, s, e = 64, 128, 80
    reps = rng.integers(-1, e, (q, s, 3)).astype(np.int32)
    parts = (np.zeros((q, s), np.int32), np.zeros((q, s), np.int32), reps,
             rng.random((q, s)) < 0.9, np.zeros(q, bool))
    alive = np.ones(e, bool)
    alive[rng.choice(e, 7, replace=False)] = False
    key = threefry.key(5)
    cpu = planner.plan_random(MatchedShards(*map(torch.from_numpy, parts)),
                              torch.from_numpy(alive), key)
    card = planner.plan_random(
        MatchedShards(*(torch.from_numpy(x).to(cuda) for x in parts)),
        torch.from_numpy(alive).to(cuda), key)
    assert card.dtype == torch.int32 and card.device.type == cuda.type
    ok = ((reps >= 0) & alive[np.clip(reps, 0, None)] & parts[3][..., None])
    g = threefry.gumbel(threefry.fold_in(key, torch.arange(q)), (s, 3)).numpy()
    top = np.sort(np.where(ok, g, np.float32(-1e30)), axis=-1)
    near = (ok.sum(-1) >= 2) & (top[..., -1] - top[..., -2] < 1e-5)
    np.testing.assert_array_equal(card.cpu().numpy()[~near], cpu.numpy()[~near])


def _sync_warnings(fn) -> int:
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def test_random_query_syncs_no_more_than_min_shards(cuda):
    """A random-planner query on the card: the session's split is host
    work and the fold and draw are device ops, so it syncs no more often
    than a min_shards query over the same store."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import AggSpec, StoreConfig
    from repro_torch.data.synthetic import DroneFleet
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=4096,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=60)
    db = AerialDB.open(cfg, device=cuda)
    fleet = DroneFleet(12, records_per_shard=60, seed=2)
    payloads, metas = fleet.next_rounds(4)
    db.ingest_rounds(payloads, metas)
    rnd = AerialDB(dataclasses.replace(cfg, planner="random"), db.state,
                   device=cuda, seed=3)
    pred = make_pred(q=16, lat0=12.9, lat1=13.1, lon0=77.5, lon1=77.7, t0=0.0,
                     t1=1e9, has_spatial=True, has_temporal=True, is_and=True,
                     device=cuda)
    spec = AggSpec(channels=(0, 1))
    for d in (db, rnd):                  # builds and warm-up, not counted
        d.query(pred, agg=spec)
    base = _sync_warnings(lambda: db.query(pred, agg=spec))
    assert _sync_warnings(lambda: rnd.query(pred, agg=spec)) <= base
    a, _ = rnd.query(pred, agg=spec)
    b, _ = db.query(pred, agg=spec)
    assert torch.equal(a.count, b.count) and int(a.count.sum()) > 0


def _latest_rounds(seed: int = 3):
    """A D400 fleet's first two rounds, the third reworked by
    ``latest_edge_round`` against the cache after them, and a round of
    small integer t (ties everywhere) with ids in [-3, 410) and NaN, +-inf
    and +-0.0 t: (payload, sid_hi) each, in insert order."""
    from repro_torch.data.synthetic import DroneFleet, latest_edge_round
    payloads, metas = DroneFleet(400, records_per_shard=60, n_values=4,
                                 seed=seed).next_rounds(3)
    crafted = latest_edge_round(payloads[2], metas.sid_hi[2],
                                payloads[1, :, -1, 0], 400, seed=seed)
    rng = np.random.default_rng(seed)
    wild = payloads[2].copy()
    wild[..., 0] = rng.choice(np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 2.0],
                                       np.float32), wild.shape[:2])
    wild[..., 3][rng.random(wild.shape[:2]) < 0.2] = np.nan
    wild_ids = rng.integers(-3, 410, wild.shape[0]).astype(np.int32)
    return [(payloads[0], metas.sid_hi[0]), (payloads[1], metas.sid_hi[1]),
            crafted, (wild, wild_ids)]


def test_latest_update_on_card_matches_cpu(cuda):
    """``_update_latest`` on the card, round after round at D400 width (400
    shards x 60 records, every id repeated 60 times a round; a crafted round
    and a round of ties and non-finite t), bitwise equal to the CPU's, and
    equal again on a second pass: the scatter's order does not matter."""
    from repro_torch.core.datastore import _update_latest
    rounds = _latest_rounds()
    cpu = (torch.zeros((400, 7)), torch.full((400,), -1, dtype=torch.int32))
    want = []
    for k, (p, ids) in enumerate(rounds):
        _update_latest(*cpu, torch.from_numpy(p), torch.from_numpy(ids), k + 1)
        want.append(tuple(x.clone() for x in cpu))
    for _ in range(2):
        card = (torch.zeros((400, 7), device=cuda),
                torch.full((400,), -1, dtype=torch.int32, device=cuda))
        for k, (p, ids) in enumerate(rounds):
            _update_latest(*card, torch.from_numpy(p).to(cuda),
                           torch.from_numpy(ids).to(cuda), k + 1)
            f, seen = (x.cpu() for x in card)
            assert seen.dtype == torch.int32
            assert torch.equal(f.view(torch.int32), want[k][0].view(torch.int32)), k
            assert torch.equal(seen, want[k][1]), k
    assert bool(torch.isnan(want[2][0]).any())            # NaN channels kept


def test_latest_ingest_syncs_no_more_than_without_cache(cuda):
    """A chunk of ``ingest_rounds`` into a store with ``max_drones=400``,
    its rounds already on the card, warns of no more syncs than the same
    chunk without the cache, under ``torch.cuda.set_sync_debug_mode``; the
    cache it leaves equals the CPU's."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.core.placement import ShardMeta
    from repro_torch.data.synthetic import DroneFleet
    sites = tuple(map(tuple, make_sites(80, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=80, sites=sites, tuple_capacity=1 << 15,
                      index_capacity=1 << 12, records_per_shard=60, n_values=4)
    payloads, metas = DroneFleet(400, records_per_shard=60, n_values=4,
                                 seed=2).next_rounds(8)
    on_card = (torch.from_numpy(payloads).to(cuda),
               ShardMeta(*(torch.from_numpy(np.asarray(f)).to(cuda) for f in metas)))
    plain = AerialDB.open(cfg, device=cuda)
    cached = AerialDB.open(dataclasses.replace(cfg, max_drones=400), device=cuda)
    for db in (plain, cached):                   # builds and warm-up
        db.ingest_rounds(on_card[0][:4], ShardMeta(*(f[:4] for f in on_card[1])))
    rest = (on_card[0][4:], ShardMeta(*(f[4:] for f in on_card[1])))
    base = _sync_warnings(lambda: plain.ingest_rounds(*rest))
    assert _sync_warnings(lambda: cached.ingest_rounds(*rest)) <= base
    cpu = AerialDB.open(dataclasses.replace(cfg, max_drones=400), device="cpu")
    cpu.ingest_rounds(payloads, metas)
    got, want = cached.latest(), cpu.latest()
    assert torch.equal(got.record.cpu().view(torch.int32), want.record.view(torch.int32))
    assert torch.equal(got.last_seen.cpu(), want.last_seen)
    assert bool(want.valid.all()) and int(want.last_seen.min()) == 8


def _repair_schedule(device):
    """The small wrapping outage scenario (8 edges, capacity 256, four
    failure domains) on ``device``: a domain lost and recovered with rings
    wrapping in between (the incremental repair), then overlapping edge
    outages with a partial recovery, deferred and repaired, and a full
    sweep. Returns (session, every repair's telemetry)."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.data.synthetic import DroneFleet
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=256,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4)
    db = AerialDB.open(cfg, device=device)
    fleet = DroneFleet(12, records_per_shard=8, seed=7)
    infos = []

    def ingest(n):
        for _ in range(n):
            db.insert(*fleet.next_shards())
    ingest(2)
    db.fail_device(1)
    ingest(8)
    db.recover_device(1)
    infos.append(db.last_repair)
    db.fail_edges(0)
    ingest(1)
    db.fail_edges(5)
    ingest(1)
    db.recover_edges(0, repair=False)
    infos.append(db.repair())
    ingest(1)
    db.recover_edges(5)
    infos.append(db.last_repair)
    infos.append(db.repair(full=True))
    return db, infos


def test_repair_on_card_matches_cpu(cuda):
    """Fail, ingest, recover and repair on the card equal the same schedule
    on the CPU: every state leaf and every repair's telemetry, bitwise (the
    placement kernels run inside each repair on the card)."""
    from repro_torch.convert import state_to_numpy
    before = (hops.launches, vops.launches)
    card, card_infos = _repair_schedule(cuda)
    cpu, cpu_infos = _repair_schedule("cpu")
    assert card_infos == cpu_infos
    assert card_infos[0]["shards_replaced"] > 0
    assert card.ledger() == cpu.ledger()
    got, want = state_to_numpy(card.state), state_to_numpy(cpu.state)
    for k in want:
        pairs = want[k].items() if k == "index" else [(k, want[k])]
        for name, w in pairs:
            g = got["index"][name] if k == "index" else got[name]
            assert g.dtype == w.dtype
            if w.dtype == np.float32:
                g, w = g.view(np.int32), w.view(np.int32)
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert hops.launches > before[0] and vops.launches > before[1]


def test_repair_deferred_fail_recover_makes_no_sync(cuda):
    """Failing and recovering edges and domains without a repair reads
    nothing from the card: the mask flips on the host and reaches the card
    from pinned memory, the step is the host mirror, and the drop watch
    stays unread."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.data.synthetic import DroneFleet
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=512,
                      index_capacity=256, records_per_shard=8,
                      n_failure_domains=4)
    db = AerialDB.open(cfg, device=cuda)
    fleet = DroneFleet(12, records_per_shard=8, seed=3)
    db.ingest_rounds(*fleet.next_rounds(2))
    db.fail_edges(7)                       # warm-up: pinned memory, builds
    db.recover_edges(7, repair=False)
    # set_sync_debug_mode's own "prototype feature ... synchronizing
    # operations" warning comes once a process: take it here
    _sync_warnings(lambda: None)

    def flips():
        db.fail_edges(1, 2)
        db.fail_device(2)
        db.fail_edges(1)
        db.recover_edges([1, 2], repair=False)
        db.recover_device(2, repair=False)
        db.recover_edges(0, repair=False)
    assert _sync_warnings(flips) == 0
    # the warm-up's window and the two flips', none repaired yet
    assert bool(db.alive.all()) and len(db.ledger()["closed_windows"]) == 3
    assert db.repair()["mode"] == "incremental"


@pytest.mark.parametrize("n_shards", [19_200])
def test_repair_sized_batch_placement_kernels_match_plain(cuda, n_shards):
    """``voronoi_assign`` and ``hash64`` at the batch a full repair of the
    D400 card scenario sends them: 16 x 16 cell centres a shard (4.9 M
    points) and its 16 temporal buckets and shard ids, bitwise against
    their plain versions, one launch each."""
    rng = np.random.default_rng(5)
    sites = torch.from_numpy(make_sites(80, CityConfig(), seed=3)).to(cuda)
    i0 = torch.from_numpy(rng.integers(1280, 1310, n_shards)).to(cuda)
    j0 = torch.from_numpy(rng.integers(7740, 7770, n_shards)).to(cuda)
    k = torch.arange(16, device=cuda)
    lat = ((i0[:, None] + k + 0.5) * 0.01).float()[:, :, None].expand(-1, 16, 16)
    lon = ((j0[:, None] + k + 0.5) * 0.01).float()[:, None, :].expand(-1, 16, 16)
    assert lat.numel() >= 4_900_000
    before = vops.launches
    got = vops.hash_spatial_kernel(lat, lon, sites)
    assert vops.launches == before + 1
    pts = torch.stack([lat.reshape(-1), lon.reshape(-1)], -1)
    assert torch.equal(got.reshape(-1), voronoi.voronoi_assign(pts, sites))
    buckets = torch.from_numpy(rng.integers(0, 300, (n_shards, 1))).to(cuda) + k
    hi = torch.from_numpy(_i32(rng, n_shards * 16)).to(cuda)
    for h, lo in ((None, buckets.int()), (hi, buckets.int().reshape(-1))):
        before = hops.launches
        out = hops.xxh64_mod(h, lo, 80)
        assert hops.launches == before + 1
        assert torch.equal(out, hashing.xxh64_mod_plain(h, lo, 80))


def _assert_card_state_equals_cpu(card_state, cpu_state):
    from repro_torch.convert import state_to_numpy
    got, want = state_to_numpy(card_state), state_to_numpy(cpu_state)
    for k in want:
        pairs = want[k].items() if k == "index" else [(k, want[k])]
        for name, w in pairs:
            g = got["index"][name] if k == "index" else got[name]
            assert g.dtype == w.dtype
            if w.dtype == np.float32:
                g, w = g.view(np.int32), w.view(np.int32)
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_partition_heal_flips_make_no_sync(cuda):
    """Opening and healing a partition without a repair reads nothing from
    the card, alone and composed with fail/recover flips; the effective
    mask the next insert takes is made at the flip, not at the insert."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.data.synthetic import DroneFleet
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=512,
                      index_capacity=256, records_per_shard=8,
                      n_failure_domains=4)
    db = AerialDB.open(cfg, device=cuda)
    fleet = DroneFleet(12, records_per_shard=8, seed=3)
    db.ingest_rounds(*fleet.next_rounds(2))
    db.partition([[0, 1, 2, 3, 4, 5], [6, 7]])        # warm-up
    db.heal(repair=False)
    _sync_warnings(lambda: None)

    def flips():
        db.partition([[0, 1, 2, 3], [4, 5, 6, 7]])
        db.fail_edges(1)
        db.heal(repair=False)
        db.partition([5, 6, 7])
        db.recover_edges(1, repair=False)
    assert _sync_warnings(flips) == 0
    assert db.effective_alive.device.type == "cuda"
    assert db.effective_alive.cpu().tolist() == [False] * 5 + [True] * 3
    assert db.reachable.cpu().tolist() == [False] * 5 + [True] * 3
    before = db.effective_alive
    db.insert(*fleet.next_shards())
    assert db.effective_alive is before
    db.heal(repair=False)
    assert db.effective_alive is db.alive
    assert db.repair()["mode"] == "incremental"
    assert db.ledger()["pending_sids"] == 0


def test_pipeline_flush_from_numpy_syncs_no_more_than_ingest_rounds(cuda):
    """A ``flush(block=False)`` of two dispatches (32 and 16 shards, from
    numpy through pinned memory) warns of no more syncs than the same
    chunks through ``ingest_rounds`` with their inputs already on the
    card, and the two stores end bitwise equal."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.core.placement import ShardMeta
    from repro_torch.data.synthetic import DroneFleet
    from repro_torch.ingest import IngestPipeline, group_shards
    sites = tuple(map(tuple, make_sites(80, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=80, sites=sites, tuple_capacity=1 << 15,
                      index_capacity=1 << 12, records_per_shard=60, n_values=4)
    payloads, _ = DroneFleet(48, records_per_shard=60, n_values=4,
                             seed=2).next_rounds(2)

    def records(rnd):
        n = 48 * 60
        rows = payloads[rnd].reshape(n, 7)
        return (np.repeat(np.arange(48), 60), np.tile(np.arange(60), 48) + 60 * rnd,
                rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:])
    pipe = IngestPipeline(AerialDB.open(cfg, device=cuda), batch_shards=32)
    direct = AerialDB.open(cfg, device=cuda)
    shard_seq = {}
    chunks = []
    for rnd in range(2):
        d, s, t, la, lo, v = records(rnd)
        rows = np.concatenate([np.stack([t, la, lo], 1), v], 1).astype(np.float32)
        (pay, meta, _), = group_shards(d, s, rows, 60, shard_seq, False)[0].values()
        chunks.append([(torch.from_numpy(pay[a:b][None]).to(cuda),
                        ShardMeta(*(torch.from_numpy(np.asarray(f)[a:b][None]).to(cuda)
                                    for f in meta)))
                       for a, b in ((0, 32), (32, 48))])
    pipe.submit_arrays(*records(0))                   # warm-up round
    assert pipe.flush(block=False)["dispatches"] == 2
    for c in chunks[0]:
        direct.ingest_rounds(*c)
    pipe.submit_arrays(*records(1))
    _sync_warnings(lambda: None)
    base = _sync_warnings(lambda: [direct.ingest_rounds(*c) for c in chunks[1]])
    out = {}
    assert _sync_warnings(lambda: out.update(pipe.flush(block=False))) <= base
    assert out["dispatches"] == 2 and out["latency_s"].size == 0
    assert pipe.reconcile()["ok"]
    _assert_card_state_equals_cpu(pipe.db.state, direct.state)


def _card_stream(seed, n_drones=12, max_seq=30):
    """The CPU tests' adversarial stream shape: per-drone seqs with a tenth
    never sent, a tenth NaN from a random value channel on, a tenth
    re-sent, shuffled. Returns (drone, seq, rows (N, 7))."""
    rng = np.random.default_rng(seed)
    drone, seq, rows = [], [], []
    for d in range(n_drones):
        n = int(rng.integers(1, max_seq + 1))
        for s in np.arange(n)[rng.random(n) > 0.1]:
            row = np.empty(7, np.float32)
            row[:3] = (1000.0 * s + d, 12.9 + 0.001 * d, 77.5 + 0.0005 * s)
            row[3:] = rng.normal(25, 5, 4)
            if rng.random() < 0.1:
                row[3 + int(rng.integers(0, 4)):] = np.nan
            drone.append(d), seq.append(s), rows.append(row)
    drone, seq, rows = np.asarray(drone), np.asarray(seq), np.stack(rows)
    dup = rng.integers(0, len(drone), max(len(drone) // 10, 1))
    order = rng.permutation(np.r_[np.arange(len(drone)), dup])
    return drone[order], seq[order], rows[order]


def test_pipeline_stream_on_card_matches_cpu(cuda):
    """An adversarial stream with NaN payloads through the pipeline on the
    card and on the CPU, in bursts with a flush after each and a drain:
    every flush summary (latency aside), the counters, ``latest()`` and
    every state leaf bitwise equal; the card's blocking flush stamps a
    latency for every record it ships."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.ingest import IngestPipeline
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=2048,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=4, retention_every=2, max_drones=16)
    d, s, rows = _card_stream(7)
    assert np.isnan(rows).any()
    pipes = [IngestPipeline(AerialDB.open(cfg, device=dev), batch_shards=4)
             for dev in (cuda, "cpu")]
    for part in np.array_split(np.arange(d.size), 3):
        outs = []
        for pipe in pipes:
            pipe.submit_arrays(d[part], s[part], rows[part, 0], rows[part, 1],
                               rows[part, 2], rows[part, 3:])
            outs.append(pipe.flush())
        for k in outs[1]:
            if k != "latency_s":
                assert outs[0][k] == outs[1][k], k
        assert outs[0]["latency_s"].size == outs[0]["flushed_records"]
    card_latest, cpu_latest = (p.latest() for p in pipes)
    np.testing.assert_array_equal(card_latest[1], cpu_latest[1])
    np.testing.assert_array_equal(card_latest[0].view(np.int32),
                                  cpu_latest[0].view(np.int32))
    for pipe in pipes:
        pipe.flush(drain=True)
    assert pipes[0].counters == pipes[1].counters
    assert pipes[0].reconcile() == pipes[1].reconcile()
    assert pipes[0].reconcile()["ok"]
    _assert_card_state_equals_cpu(pipes[0].db.state, pipes[1].db.state)


# The reference chaos tests' smoke plan (tests/test_chaos.py), and a cut
# across the failure-domain blocks (edges 3, 4, 6 of 8; blocks of 2) opened
# while domain 0 is down, with domain 0 recovered and an edge lost and
# recovered inside the split; (step, kind, args) rows.
CHAOS_SMOKE = ((0, "fail_edges", ((6,),)),
               (1, "partition", (((0, 1, 2, 3, 6), (4, 5, 7)),)),
               (1, "flush_fail", (2,)),
               (2, "heal", ()),
               (3, "recover_edges", ((6,),)))
CHAOS_OVERLAP = ((0, "fail_device", (0,)),
                 (1, "partition", (((0, 1, 2, 5, 7), (3, 4, 6)),)),
                 (2, "recover_device", (0,)),
                 (2, "fail_edges", ((7,),)),
                 (3, "recover_edges", ((7,),)),
                 (4, "heal", ()))


def _chaos_run(device, rows, n_steps):
    """``rows`` as a FaultPlan through ``ChaosRunner`` over a session and
    pipeline on ``device`` (8 edges, 4 failure domains, 8-record shards),
    each tick every one of 12 drones sending one full shard."""
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos import ChaosRunner, FaultPlan
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.ingest import IngestPipeline
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=2048,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4)
    db = AerialDB.open(cfg, device=device)
    pipe = IngestPipeline(db, max_retries=4, sleep=lambda s: None)
    runner = ChaosRunner(FaultPlan(events=rows, n_steps=n_steps), db, pipe)

    def tick(step):
        rng = np.random.default_rng((0, step))
        drone = np.repeat(np.arange(12), 8)
        seq = np.tile(np.arange(8), 12) + step * 8
        pipe.submit_arrays(drone, seq, seq + step * 0.25,
                           rng.uniform(12.90, 13.00, 96),
                           rng.uniform(77.50, 77.62, 96),
                           rng.normal(size=(96, 4)))
        pipe.flush()
        assert pipe.reconcile()["counters_ok"], step
    runner.run(tick)
    return db, pipe, runner


@pytest.mark.parametrize("plan", ["smoke", "overlap"])
def test_chaos_plan_on_card_matches_cpu(cuda, plan):
    """A fault plan through the runner on the card and on the CPU: every
    state leaf bitwise, the ledgers, counters and reconciles equal, the
    logs byte-identical (every logged value a plain Python value: the JSON
    encoder takes no tensor or numpy scalar), and the repairs incremental;
    the placement kernels ran on the card."""
    from repro_torch.chaos import assert_content_equal, canonical_content
    rows, n_steps = {"smoke": (CHAOS_SMOKE, 4), "overlap": (CHAOS_OVERLAP, 5)}[plan]
    before = (hops.launches, vops.launches)
    card = _chaos_run(cuda, rows, n_steps)
    assert hops.launches > before[0] and vops.launches > before[1]
    cpu = _chaos_run("cpu", rows, n_steps)
    _assert_card_state_equals_cpu(card[0].state, cpu[0].state)
    assert card[2].to_json() == cpu[2].to_json()
    assert card[0].ledger() == cpu[0].ledger()
    assert card[1].counters == cpu[1].counters
    assert card[1].reconcile() == cpu[1].reconcile()
    assert card[1].reconcile()["ok"] and card[1].counters["gave_up"] == 0
    modes = [e["repair"]["mode"] for e in card[2].log if "repair" in e]
    assert modes and set(modes) == {"incremental"}
    assert_content_equal(canonical_content(card[0]), canonical_content(cpu[0]))
