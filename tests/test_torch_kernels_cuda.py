"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port (the machine with the card has no
JAX), so it runs there as ``python -m pytest -q tests/test_torch_kernels_cuda.py``.
Without CUDA every test skips: a CUDA kernel has no CPU mode. Policy as in
PERF.md: hash64 and voronoi_assign bitwise (the kernel repeats the plain
version's rounding), st_scan count/min/max bitwise and sum to rtol 1e-5;
flash_attention to 2e-5 in fp32 (the same online softmax, summed in another
order) and 1e-2 in bf16 (one bf16 ulp of outputs of order 1 is 0.0078; the
kernel's tensor-core sums and the plain version's differ in order), for
all three bf16 kernels, at d 32, 64, 128 and 160 (``-k "flash or sm90 or
decode"`` runs these alone; ``-k d160`` the cases at stablelm-12b's head
dim, ``-k d64`` those at zamba2-1.2b's). The split-KV decode kernel is also held, at 1e-2, to its own plain
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
``-k federation`` runs the one-process edge mesh on the card: four blocks
on one card against the same mesh on the CPU and against the single store
on the card (inserts that wrap the rings, a block lost and repaired, a
4-channel batch: every leaf, the repair telemetry and the answers
bitwise), and st_scan launched once per block a batch. ``-k fleet`` runs
the same scenario on the one-process ``(2, 2)`` fleet mesh on the card
against the CPU and against the single store on the card, st_scan launched
once per tile and block (2 x 4 a batch), and the two-process smoke
(``repro_torch.launch.multihost_smoke``) with both gloo workers on the
card. ``-k examples`` runs the six ported datastore and serving examples
(``repro_torch.examples``) on the card against their CPU runs. ``-k
analysis`` runs the static-analysis counters on the card: the kernel
builds of two child processes over one empty build directory, and the two
sync counters side by side with a planted ``.item()``. ``-k ssm`` runs
falcon-mamba-7b's smoke model (plain torch ops, no kernel) in fp32 on the
card against float64 on the CPU; ``-k hybrid`` zamba2-1.2b's smoke model
the same way (its shared block through the mma_sync kernel in fp32) and
at d 64 in bf16 (every prefill site on the sm90 kernel, every decode site
on the decode kernel); ``-k sampling`` the threefry draws and
``categorical`` on the card against the CPU (bf16 bitwise) and the sampled
Engine's ids per seed; ``-k moe`` grok-1-314b's smoke model (the MoE FFN
in plain torch ops) in fp32 on the card against float64 on the CPU, at
its own capacity and at 8 slots an expert (drops), and at grok's GQA group
6 in bf16 (every prefill layer on the sm90 kernel, every decode layer on
the decode kernel). ``-k mla`` runs MLA's unequal head dims: q/k 192 with
v 128 (deepseek-v2-236b) on the sm90 and mma_sync kernels in bf16 and on
mma_sync in fp32, and q/k 48 with v 32 (its smoke config) on mma_sync, v
a strided view as MLA passes it, each against the plain version and
bitwise the same on a second call; the sm90 layout probe at (192, 128);
the smoke model in fp32 on the card against float64 on the CPU; and a
bf16 model at deepseek's head dims whose prefill goes to the sm90 kernel
and whose decode launches no flash kernel; the mma_sync backward at
both MLA pairs in fp32 and bf16 against the plain version (a strided v, a
repeat bitwise, the sm90 backward refused), and one value_and_grad of
deepseek-v2's and grok-1's smoke models in fp32 against float64 on the
CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hashing, voronoi
from repro_torch.core.datastore import make_pred
from repro_torch.data.synthetic import CityConfig, make_sites
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.examples._common import (EXAMPLES, card_vs_cpu, launch_counts,
                                          launches_since, missing_kernels)
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_decode_split_ref)
from repro_torch.kernels.hash64 import ops as hops
from repro_torch.kernels.st_scan import ops as st_ops
from repro_torch.kernels.st_scan import ref as st_ref
from repro_torch.kernels.voronoi_assign import ops as vops
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
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
@pytest.mark.parametrize("dh", [32, 64, 128, 160])
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


def test_sm90_probe_d160_matches_matmul(cuda):
    """The d 160 layout: three 64-column slabs a row, the third read at
    column 128 with TMA's zero fill past column 160, a 64-key tile, the
    m64n64 S product and PV as n128 + n64; against torch.matmul in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(8)
    keys = fops.SM90_KEYS[160]
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, torch.bfloat16) for shape in ((64, 160), (keys, 160),
                                                       (keys, 160)))
    s, o = fops.sm90_probe(q, k, v)
    assert s.shape == (64, keys) and o.shape == (64, 160)
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(o, s.to(torch.bfloat16).float() @ v.float(),
                               rtol=1e-4, atol=1e-3)


# (b, sq, skv, h, kv, causal, q_offset), all d 128
SM90_CASES = [(1, 2048, 2048, 16, 8, True, 0),      # serve prefill, B 1
              (1, 2048, 2048, 48, 8, True, 0),      # grok-1-314b prefill (G 6), B 1
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


# (b, sq, skv, h, kv, causal, q_offset), all d 160 (stablelm-12b's head dim)
SM90_D160_CASES = [(1, 2048, 2048, 32, 8, True, 0),      # stablelm prefill, B 1
                   (1, 64, 64, 4, 1, True, 0),
                   (2, 77, 131, 4, 2, True, 54),         # ragged Sq and Skv
                   (2, 77, 131, 4, 2, False, 0),
                   (1, 100, 228, 4, 2, True, 128),       # q_offset 128
                   (2, 200, 200, 8, 2, False, 0),        # bidirectional
                   (2, 200, 200, 4, 4, True, 0),         # GQA group 1
                   (2, 200, 200, 8, 2, True, 0),         # group 4
                   (2, 333, 333, 4, 1, True, 0)]         # MQA, 6 key tiles


@pytest.mark.parametrize("case", SM90_D160_CASES, ids=str)
def test_flash_sm90_d160_matches_plain(cuda, case):
    b, sq, skv, h, kv, causal, off = case
    _flash_case(cuda, torch.bfloat16, b, sq, skv, h, kv, 160, causal, off,
                seed=sq + h + 1, variant="sm90")


# (b, sq, skv, h, kv, causal, q_offset), all d 64 (zamba2-1.2b's head dim)
SM90_D64_CASES = [(1, 2048, 2048, 32, 32, True, 0),     # zamba2 prefill, B 1
                  (1, 64, 64, 4, 4, True, 0),
                  (2, 77, 131, 4, 2, True, 54),         # ragged Sq and Skv, G 2
                  (2, 77, 131, 4, 2, False, 0),
                  (1, 100, 228, 4, 4, True, 128),       # q_offset 128
                  (2, 200, 200, 8, 8, False, 0),        # bidirectional
                  (2, 200, 200, 8, 4, True, 0),         # group 2
                  (2, 333, 333, 4, 4, True, 0),         # 3 query and key tiles
                  (1040, 64, 64, 64, 32, True, 0)]      # B x H = 66,560 blocks


@pytest.mark.parametrize("case", SM90_D64_CASES, ids=str)
def test_flash_sm90_d64_matches_plain(cuda, case):
    b, sq, skv, h, kv, causal, off = case
    _flash_case(cuda, torch.bfloat16, b, sq, skv, h, kv, 64, causal, off,
                seed=sq + h + 2, variant="sm90")


def test_sm90_probe_d64_matches_matmul(cuda):
    """The d 64 layout: one 64-column slab a row, QK^T in 4 k-steps and PV
    one n64 product; against torch.matmul in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(64)
    keys = fops.SM90_KEYS[64]
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, torch.bfloat16) for shape in ((64, 64), (keys, 64),
                                                       (keys, 64)))
    s, o = fops.sm90_probe(q, k, v)
    assert s.shape == (64, keys) and o.shape == (64, 64)
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(o, s.to(torch.bfloat16).float() @ v.float(),
                               rtol=1e-4, atol=1e-3)


def test_flash_sm90_d64_matches_mma_sync_and_repeats(cuda):
    """Both bf16 kernels, forced, on the same inputs at d 64, k and v a
    cache slice read in place; two sm90 calls give the same bits."""
    rng = np.random.default_rng(640)
    cache = torch.from_numpy(rng.standard_normal((2, 2, 333, 4, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 333, 8, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k, v = cache[0], cache[1]
    for causal in (True, False):
        a = fops.flash_attention_cuda(q, k, v, causal=causal, variant="sm90")
        b = fops.flash_attention_cuda(q, k, v, causal=causal,
                                      variant="mma_sync")
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2, atol=1e-2)
        assert torch.equal(a, fops.flash_attention_cuda(
            q, k, v, causal=causal, variant="sm90"))


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


def test_flash_sm90_d160_matches_mma_sync(cuda):
    """Both bf16 kernels, forced, on the same inputs at d 160, k and v a
    cache slice read in place; two sm90 calls give the same bits."""
    rng = np.random.default_rng(160)
    cache = torch.from_numpy(rng.standard_normal((2, 2, 333, 2, 160)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 333, 8, 160)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k, v = cache[0], cache[1]
    for causal in (True, False):
        a = fops.flash_attention_cuda(q, k, v, causal=causal, variant="sm90")
        b = fops.flash_attention_cuda(q, k, v, causal=causal,
                                      variant="mma_sync")
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2, atol=1e-2)
        assert torch.equal(a, fops.flash_attention_cuda(
            q, k, v, causal=causal, variant="sm90"))


def test_flash_sm90_refuses_shapes_it_lacks(cuda):
    for dtype, sq, dh in ((torch.float32, 128, 128), (torch.bfloat16, 63, 128),
                          (torch.bfloat16, 63, 64), (torch.float32, 128, 160),
                          (torch.bfloat16, 63, 160)):
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


def test_prefill_step_d160_sends_flash_to_sm90(cuda):
    """prefill_step of stablelm-12b narrowed with its head dim kept (d 160,
    2 layers, 4 heads over 1 KV head) in bf16: every flash call goes to the
    sm90 kernel, the logits are finite and two runs give the same bits."""
    cfg = reduce_for_smoke(get_config("stablelm-12b")).replace(
        n_layers=2, d_head=160)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prefill_step, _ = make_serve_steps(model)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 150)).astype(np.int32)).to(cuda)
    before = dict(fops.launches_by_variant)
    logits = prefill_step(params, {"tokens": toks})
    assert fops.launches_by_variant["sm90"] == before["sm90"] + cfg.n_layers
    assert fops.launches_by_variant["mma_sync"] == before["mma_sync"]
    assert logits.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    assert torch.equal(logits, prefill_step(params, {"tokens": toks}))


# ---------------------------------------------------------------------------
# the split-KV decode kernel
# ---------------------------------------------------------------------------

DECODE_ROWS = [(256, p) for p in (0, 1, 23, 24, 63, 64, 77, 191, 255)] \
    + [(4096, 4095)]


@pytest.mark.parametrize("skv,q_offset", DECODE_ROWS)
@pytest.mark.parametrize("g", [1, 2, 5, 8])
@pytest.mark.parametrize("dh", [64, 128, 160])
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
    (8, 48, 8, 128, 256, 191),      # grok-1-314b decode step, G 6
    (1, 16, 1, 32, 50, 7),          # G 16, d 32, 8 splits of one key
    (8, 4, 2, 32, 128, 35),         # the lm-serve example's last decode step
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


# (batch, the splits decode_splits gives it at 8 KV heads and 192 keys)
D160_SPLITS = [(32, 1), (16, 2), (11, 3), (8, 4), (7, 5), (6, 6), (5, 7), (4, 8)]


@pytest.mark.parametrize("b,n_split", D160_SPLITS)
def test_flash_decode_d160_every_split(cuda, b, n_split):
    """stablelm-12b's decode rows (d 160, 32 heads over 8, q_offset 191 of
    a 256-slot cache) at every split count 1-8, among them 3, 6 and 7,
    which do not divide d 160's 80 column pairs: against the plain version
    of the same partition and merge and the chunked one, and two calls
    bitwise equal."""
    assert fops.decode_splits(b, 8, 192) == n_split
    rng = np.random.default_rng(b)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((b, 1, 32, 160), (b, 256, 8, 160), (b, 256, 8, 160)))
    before = fops.launches_by_variant["decode"]
    got = fops.flash_attention_cuda(q, k, v, causal=True, q_offset=191)
    assert fops.launches_by_variant["decode"] == before + 1
    assert torch.equal(got, fops.flash_attention_cuda(q, k, v, causal=True,
                                                      q_offset=191))
    split = flash_decode_split_ref(q, k, v, causal=True, q_offset=191,
                                   n_split=n_split)
    torch.testing.assert_close(got.float(), split.float(), rtol=1e-2, atol=1e-2)
    want = flash_attention_ref(q, k, v, causal=True, q_offset=191)
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


def test_generate_d160_sends_decode_to_the_decode_kernel(cuda):
    """Engine.generate on the narrow d 160 model in bf16: every flash call
    goes to the decode kernel, and a second run gives the same ids."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = reduce_for_smoke(get_config("stablelm-12b")).replace(
        n_layers=2, d_head=160)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(1))
    engine = Engine(model, params, ServeConfig(max_new_tokens=6, max_seq=64))
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    before = dict(fops.launches_by_variant)
    ids = engine.generate(prompts)
    after = dict(fops.launches_by_variant)
    assert after["decode"] - before["decode"] == cfg.n_layers * (40 + 6)
    assert after["mma_sync"] == before["mma_sync"]
    assert after["sm90"] == before["sm90"]
    assert np.array_equal(ids, engine.generate(prompts))


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


def _federation_run(device, n_blocks, n_fleet=None):
    """The small federation scenario on ``device``, on an edge mesh of
    ``n_blocks`` blocks (None: the single store), or with ``n_fleet`` on a
    fleet mesh of ``n_fleet`` fleets of ``n_blocks // n_fleet`` blocks: 8
    edges with 256-slot rings that wrap, four failure domains, block 1 lost
    for 6 rounds and recovered with the incremental repair, then a
    4-channel catch-all and box batch. Returns (session, repair telemetry,
    query answers)."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import AggSpec, StoreConfig
    from repro_torch.data.synthetic import DroneFleet
    from repro_torch.launch.mesh import make_edge_mesh, make_fleet_mesh
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=256,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4, max_drones=16)
    if n_blocks is None:
        db = AerialDB.open(cfg, device=device)
    elif n_fleet is None:
        db = AerialDB.open(cfg, make_edge_mesh(n_blocks, device=device))
    else:
        db = AerialDB.open(cfg, make_fleet_mesh(
            n_fleet, n_blocks // n_fleet, device=device))
    fleet = DroneFleet(12, records_per_shard=8, seed=7)
    pay, met = fleet.next_rounds(2)
    db.ingest_rounds(pay, met)
    db.fail_device(1)
    for _ in range(6):
        db.insert(*fleet.next_shards())
    db.recover_device(1)
    pred = make_pred(q=3, lat0=[12.85, 12.9, 12.95], lat1=[13.1, 13.0, 13.05],
                     lon0=[77.45, 77.5, 77.55], lon1=[77.75, 77.6, 77.65],
                     t0=[0.0, 200.0, 300.0], t1=[1e9, 400.0, 400.0],
                     has_spatial=[False, True, True], has_temporal=True,
                     is_and=True, device=device)
    res, info = db.query(pred, agg=AggSpec(channels=(0, 1, 2, 3)), key=(0, 7))
    return db, db.last_repair, (res, info)


def _assert_answers_equal(got, want):
    """QueryResult and QueryInfo fields bitwise, but vsum and vmean: to
    rtol 1e-5 (the kernel and the plain version sum in other orders)."""
    (r, i), (w, j) = got, want
    for f in r._fields + tuple(f"info.{f}" for f in i._fields):
        a, b = (getattr(i, f[5:]), getattr(j, f[5:])) if f.startswith("info.") \
            else (getattr(r, f), getattr(w, f))
        a, b = a.cpu(), b.cpu()
        if f in ("vsum", "vmean"):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0, equal_nan=True)
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def test_federation_mesh_on_card_matches_cpu(cuda):
    """Four blocks on one card against the same mesh on the CPU: every leaf
    of the gathered store and of each block, the repair telemetry, the
    ledger and the 4-channel answers bitwise, vsum and vmean to rtol 1e-5
    (the kernel sums in another order than the CPU's plain version)."""
    card, card_rep, card_ans = _federation_run(cuda, 4)
    cpu, cpu_rep, cpu_ans = _federation_run("cpu", 4)
    assert card_rep == cpu_rep and card_rep["shards_replaced"] > 0
    assert card.ledger() == cpu.ledger()
    assert int(card.state.tup_overwritten.sum()) > 0       # the rings wrapped
    _assert_card_state_equals_cpu(card.state, cpu.state)
    for got, want in zip(card.blocks, cpu.blocks):
        assert got.tup_f.device.type == "cuda"
        _assert_card_state_equals_cpu(got, want)
    _assert_answers_equal(card_ans, cpu_ans)


def test_federation_mesh_matches_single_store_on_card(cuda):
    """The mesh on the card against the single store on the card: the same
    leaves, telemetry, ledger and answers, bitwise (vsum and vmean to rtol
    1e-5)."""
    mesh, mesh_rep, mesh_ans = _federation_run(cuda, 4)
    one, one_rep, one_ans = _federation_run(cuda, None)
    assert mesh_rep == one_rep
    assert mesh.ledger() == one.ledger()
    _assert_card_state_equals_cpu(mesh.state, one.state)
    _assert_answers_equal(mesh_ans, one_ans)
    assert int(mesh_ans[0].count[0]) == int(one_ans[0].count[0]) > 0


def test_federation_st_scan_launches_per_block(cuda):
    """A batch of up to four channels launches st_scan once on each block of
    the mesh and once on the single store; the placement kernels run on
    every block of an insert."""
    from repro_torch.core.datastore import AggSpec
    mesh, _, _ = _federation_run(cuda, 4)
    one, _, _ = _federation_run(cuda, None)
    pred = make_pred(q=2, t0=0.0, t1=1e9, has_temporal=True, device=cuda)
    for db, per_batch in ((mesh, 4), (one, 1)):
        for spec in (AggSpec(channel=0), AggSpec(channels=(0, 1, 2, 3))):
            before = st_ops.launches
            db.query(pred, agg=spec, key=(0, 1))
            assert st_ops.launches == before + per_batch
    from repro_torch.data.synthetic import DroneFleet
    p, m = DroneFleet(12, records_per_shard=8, seed=9).next_shards()
    counts = {}
    for name, db in (("mesh", mesh), ("one", one)):
        before = (hops.launches, vops.launches)
        db.insert(p, m)
        counts[name] = (hops.launches - before[0], vops.launches - before[1])
    assert counts["mesh"] == tuple(4 * c for c in counts["one"])
    assert min(counts["one"]) > 0


def test_fleet_mesh_on_card_matches_cpu_and_single_store(cuda):
    """The (2, 2) fleet mesh on the card against the same mesh on the CPU
    and against the single store on the card: every leaf of every block,
    the repair telemetry, the ledger and the 4-channel answers bitwise
    (vsum and vmean to rtol 1e-5)."""
    card, card_rep, card_ans = _federation_run(cuda, 4, n_fleet=2)
    cpu, cpu_rep, cpu_ans = _federation_run("cpu", 4, n_fleet=2)
    one, one_rep, one_ans = _federation_run(cuda, None)
    assert card.mesh.shape == {"fleet": 2, "edge": 2}
    assert card_rep == cpu_rep == one_rep and card_rep["shards_replaced"] > 0
    assert card.ledger() == cpu.ledger() == one.ledger()
    for got, want in zip(card.blocks, cpu.blocks):
        assert got.tup_f.device.type == "cuda"
        _assert_card_state_equals_cpu(got, want)
    _assert_card_state_equals_cpu(card.state, one.state)
    _assert_answers_equal(card_ans, cpu_ans)
    _assert_answers_equal(card_ans, one_ans)
    assert int(card_ans[0].count[0]) > 0


def test_fleet_st_scan_launches_two_tiles_per_block(cuda):
    """On the fleet mesh a batch of two or more queries runs in two tiles,
    each scanned once on each block: 2 x 4 st_scan launches a batch of up
    to four channels (the edge mesh: 4); a one-query batch is one tile. The
    lookup sets are made once a batch, so the hash and locate launches are
    the edge mesh's."""
    from repro_torch.core.datastore import AggSpec
    fleet, _, _ = _federation_run(cuda, 4, n_fleet=2)
    edge, _, _ = _federation_run(cuda, 4)
    for db, per_batch in ((fleet, 8), (edge, 4)):
        for q, tiles in ((2, 2), (1, 1)):
            pred = make_pred(q=q, t0=0.0, t1=1e9, has_temporal=True,
                             device=cuda)
            for spec in (AggSpec(channel=0), AggSpec(channels=(0, 1, 2, 3))):
                before = (st_ops.launches, hops.launches, vops.launches)
                db.query(pred, agg=spec, key=(0, 1))
                want = per_batch if tiles == 2 or db is edge else 4
                assert st_ops.launches - before[0] == want
                assert (hops.launches - before[1],
                        vops.launches - before[2]) == (8, 4)


def test_fleet_two_process_smoke_on_card(cuda):
    """``python -m repro_torch.launch.multihost_smoke --device cuda``: two
    gloo processes, one a fleet, both on the card, each holding its blocks
    and answers to its single store; both exit 0 inside the limit."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost_smoke",
         "--device", "cuda"], env=env, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for w in report["workers"]:
        assert w["device"].startswith("cuda") and w["answers_checked"] == 5
        assert w["host_syncs"] == w["gloo_exchanges"] > 0
        assert min(w["launches"].values()) > 0


# ---------------------------------------------------------------------------
# The flash-attention backward kernel and the training path
# ---------------------------------------------------------------------------

# (b, sq, skv, h, kv, causal, q_offset): chip_smoke.py's flash_vs_plain
# backward cases: GQA groups 1 and 2 and 16 heads over 8, causal and not,
# Sq != Skv with a q_offset, lengths that are no tile's multiple.
BWD_CASES = [(2, 200, 200, 4, 4, True, 0), (2, 200, 200, 8, 4, False, 0),
             (1, 256, 256, 16, 8, True, 0), (2, 77, 131, 4, 2, True, 54),
             (2, 77, 131, 4, 2, False, 0)]
# Relative to each gradient's largest magnitude: fp32 is the same formula
# summed in another order; bf16 rounds P and dS to bf16 before the products.
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _bwd_inputs(cuda, dtype, case, dh, seed):
    b, sq, skv, h, kv, causal, off = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(cuda, dtype) for s in ((b, sq, h, dh), (b, skv, kv, dh),
                                              (b, skv, kv, dh), (b, sq, h, dh)))
    return q, k, v, fops.flash_attention_cuda(q, k, v, causal=causal, q_offset=off), do


def _bwd_case(cuda, dtype, case, dh, seed, variant=None):
    """The backward kernel the wrapper picks (or the forced ``variant``)
    against the plain version, each gradient within BWD_TOL of its largest
    magnitude; a second call bitwise equal. Returns the kernel that ran."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    *_, causal, off = case
    q, k, v, o, do = _bwd_inputs(cuda, dtype, case, dh, seed)
    ran = fops.resolve_bwd_variant(q, k, v, variant)
    before = fops.launches_by_variant["bwd"], fops.bwd_launches_by_variant[ran]
    got = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal, q_offset=off,
                                        variant=variant)
    assert (fops.launches_by_variant["bwd"], fops.bwd_launches_by_variant[ran]) \
        == (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_ref(q, k, v, o, do, causal=causal, q_offset=off)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        assert err <= BWD_TOL[dtype] * scale, (name, err, scale)
    again = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal, q_offset=off,
                                          variant=variant)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    return ran


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128, 160])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, dh, case):
    _bwd_case(cuda, dtype, case, dh, seed=dh + case[1])


def test_flash_bwd_reads_strided_inputs(cuda):
    """q, k, v as views of a fused projection (strided heads) and a
    non-contiguous dO: the same gradients as contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 96, 8, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    do = torch.from_numpy(rng.standard_normal((2, 4, 96, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16).transpose(1, 2)
    o = fops.flash_attention_cuda(q, k, v, causal=True)
    got = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=True)
    want = fops.flash_attention_bwd_cuda(*(x.contiguous() for x in (q, k, v, o, do)),
                                         causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d_head", [32, 128])
def test_attention_under_grad_reaches_the_weights(cuda, d_head):
    """A CUDA flash_attention under grad returns an output with a grad_fn,
    and the loss's gradient reaches every layer's wq, wk and wv through the
    backward kernel (one call a layer; remat adds forward launches only)."""
    from repro_torch.train.train_loop import loss_with_microbatch
    cfg = reduce_for_smoke(get_config("internlm2-1.8b")).replace(d_head=d_head)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tracked = tree_map(lambda a: a.detach().requires_grad_(), params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 97)).astype(np.int32)).to(cuda)
    q = torch.zeros((1, 64, 2, d_head), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    assert fops.flash_attention(q, q, q, causal=True).grad_fn is not None
    before = dict(fops.launches_by_variant)
    loss = loss_with_microbatch(model, tracked, {"tokens": toks[:, :-1],
                                                 "labels": toks[:, 1:]}, 2)
    grads = torch.autograd.grad(loss, tree_leaves(tracked))
    g = tree_unflatten(params, grads)["stack"]["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        norms = g[name].float().flatten(1).norm(dim=1)
        assert bool((norms > 0).all()) and bool(torch.isfinite(norms).all()), name
    assert fops.launches_by_variant["bwd"] == before["bwd"] + 2 * cfg.n_layers
    want = "sm90" if d_head == 128 else "mma_sync"
    assert fops.launches_by_variant[want] == before[want] + 4 * cfg.n_layers


def test_train_step_on_card_matches_cpu(cuda):
    """Two AdamW steps of the lm-8m example config in fp32 on the card,
    against the same steps in float64 compute on one CPU thread: the losses
    within 1e-5 relative, each gradient leaf within 1e-4 of its largest
    magnitude."""
    from repro_torch.examples.train_lm import LM_8M
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.train_loop import value_and_grad
    opt = optlib.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    cpu_m = Model(LM_8M.replace(compute_dtype_str="float64"), device="cpu")
    card_m = Model(LM_8M.replace(compute_dtype_str="float32"), device=cuda)
    p_cpu = cpu_m.init(torch.Generator().manual_seed(0))
    p_card = tree_map(lambda a: a.to(cuda), p_cpu)
    s_cpu, s_card = optlib.init_opt_state(opt, p_cpu), optlib.init_opt_state(opt, p_card)
    rng = np.random.default_rng(4)
    threads, tf32 = torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(2):
            toks = torch.from_numpy(rng.integers(0, 512, (8, 65)).astype(np.int32))
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            lc, gc = value_and_grad(card_m, p_card, {k: v.to(cuda) for k, v in batch.items()})
            lr_, gr = value_and_grad(cpu_m, p_cpu, batch)
            assert abs(float(lc) - float(lr_)) <= 1e-5 * abs(float(lr_))
            for a, b in zip(tree_leaves(gc), tree_leaves(gr)):
                assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
            p_card, s_card, _ = optlib.adamw_update(opt, gc, s_card, p_card)
            p_cpu, s_cpu, _ = optlib.adamw_update(opt, gr, s_cpu, p_cpu)
    finally:
        torch.set_num_threads(threads)
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("d_head", [32, 128])
def test_flash_bwd_on_the_model_tensors_matches_plain(cuda, d_head, monkeypatch):
    """Every backward call of a bf16 train step, held to the plain version
    on the very q, k, v, o and dO the model passed it (their views and
    strides), each gradient within 2e-2 of its largest magnitude."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    from repro_torch.train.train_loop import value_and_grad
    cfg = reduce_for_smoke(get_config("internlm2-1.8b")).replace(d_head=d_head)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (4, 129)).astype(np.int32)).to(cuda)
    calls, kernel = [], fops.flash_attention_bwd_cuda

    def held(q, k, v, o, do, *, causal, q_offset=0):
        got = kernel(q, k, v, o, do, causal=causal, q_offset=q_offset)
        calls.append(((q, k, v, o, do), causal, q_offset, got))
        return got

    monkeypatch.setattr(fops, "flash_attention_bwd_cuda", held)
    before = dict(fops.bwd_launches_by_variant)
    value_and_grad(model, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 2)
    assert len(calls) == 2 * cfg.n_layers
    # d 128 goes through the sm90 backward, d 32 through the mma_sync one.
    want_kernel = "sm90" if d_head == 128 else "mma_sync"
    assert {n: fops.bwd_launches_by_variant[n] - before[n] for n in before} == {
        n: 2 * cfg.n_layers if n == want_kernel else 0 for n in before}
    with torch.no_grad():
        for args, causal, off, got in calls:
            want = flash_attention_bwd_ref(*args, causal=causal, q_offset=off)
            for g, w in zip(got, want):
                assert bool(torch.isfinite(g).all())
                err = float((g.float() - w.float()).abs().max())
                assert err <= BWD_TOL[torch.bfloat16] * float(w.float().abs().max())


# The sm90 backward (bf16, d 128, Sq and Skv >= 64) across tiles in both
# directions: (b, sq, skv, h, kv, causal, q_offset). GQA groups 1, 2 and 8,
# causal and not, 1024 and 4096 rows and keys, q_offset > 0 with Sq < Skv
# (keys no row sees), ragged lengths and the least rows and keys.
BWD_SM90_CASES = [(1, 1024, 1024, 8, 8, True, 0), (1, 1024, 1024, 8, 4, False, 0),
                  (1, 1024, 1024, 16, 2, True, 0), (1, 4096, 4096, 16, 8, True, 0),
                  (1, 4096, 4096, 8, 1, False, 0), (2, 512, 1536, 4, 2, True, 1024),
                  (2, 256, 1024, 4, 2, True, 256), (2, 200, 200, 4, 4, True, 0),
                  (2, 77, 131, 4, 2, True, 54), (2, 77, 131, 4, 2, False, 0),
                  (2, 64, 64, 4, 2, True, 0), (1, 64, 200, 2, 1, False, 0)]


@pytest.mark.parametrize("case", BWD_SM90_CASES, ids=str)
def test_flash_bwd_sm90_matches_plain(cuda, case):
    assert _bwd_case(cuda, torch.bfloat16, case, 128, seed=7 + case[1]) == "sm90"


@pytest.mark.parametrize("case", BWD_SM90_CASES[:3] + BWD_SM90_CASES[5:], ids=str)
def test_flash_bwd_forced_variants_match_plain(cuda, case):
    """The sm90 and mma_sync backwards forced on the same inputs, each
    within BWD_TOL of the plain version."""
    for variant in ("sm90", "mma_sync"):
        assert _bwd_case(cuda, torch.bfloat16, case, 128, seed=11 + case[2],
                         variant=variant) == variant


def test_flash_bwd_sm90_reads_strided_inputs(cuda):
    """q, k, v as views of a fused projection (strided heads: the TMA maps'
    strides) and a non-contiguous dO at d 128: the same gradients, bitwise,
    as contiguous copies, both through the sm90 backward."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 320, 8, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    do = torch.from_numpy(rng.standard_normal((2, 4, 320, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16).transpose(1, 2)
    o = fops.flash_attention_cuda(q, k, v, causal=True)
    before = fops.bwd_launches_by_variant["sm90"]
    got = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=True)
    want = fops.flash_attention_bwd_cuda(*(x.contiguous() for x in (q, k, v, o, do)),
                                         causal=True)
    assert fops.bwd_launches_by_variant["sm90"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_bwd_forced_sm90_refuses_a_shape_it_lacks(cuda):
    q = torch.zeros((1, 128, 2, 64), device=cuda, dtype=torch.bfloat16)
    before = dict(fops.bwd_launches_by_variant)
    with pytest.raises(ValueError, match="sm90 backward"):
        fops.flash_attention_bwd_cuda(q, q, q, q, q, causal=True, variant="sm90")
    assert fops.bwd_launches_by_variant == before


# The backwards at MLA's unequal pairs (d_qk, d_v), v the strided half of
# a K/V expansion as mla_attend passes it:
# (b, sq, skv, h, kv, causal, q_offset). Ragged lengths with q_offset,
# bidirectional, GQA group 2, 1024 rows and keys over 16 heads, and
# train_dsv2's 128 heads over 128 at a short length.
MLA_BWD_CASES = [(2, 77, 131, 4, 2, True, 54), (2, 200, 200, 8, 8, False, 0),
                 (2, 200, 200, 8, 4, True, 0), (1, 1024, 1024, 16, 16, True, 0),
                 (1, 256, 256, 128, 128, True, 0)]


def _mla_bwd_inputs(cuda, dtype, case, dk, dv, seed):
    b, sq, skv, h, kv, causal, off = case
    rng = np.random.default_rng(seed)
    q, k, kvb, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     .to(cuda, dtype) for s in ((b, sq, h, dk), (b, skv, kv, dk),
                                                (b, skv, kv, 2 * dv), (b, sq, h, dv)))
    v = kvb[..., dv:]
    return q, k, v, fops.flash_attention_cuda(q, k, v, causal=causal, q_offset=off), do


@pytest.mark.parametrize("variant", [None, "mma_sync"], ids=["picked", "mma_sync"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", [(192, 128), (48, 32)])
@pytest.mark.parametrize("case", MLA_BWD_CASES, ids=str)
def test_flash_bwd_mla_matches_plain(cuda, dtype, dk, dv, case, variant):
    """The backward at an MLA pair against the plain version: the kernel
    the wrapper picks (bf16 (192, 128): the sm90 one; the rest: mma_sync)
    or the mma_sync one forced; each gradient within BWD_TOL of its largest
    magnitude and of its input's shape (dv d_v wide); one call counted on
    the kernel that ran; a second call bitwise equal."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    *_, causal, off = case
    q, k, v, o, do = _mla_bwd_inputs(cuda, dtype, case, dk, dv, seed=dk + case[1])
    ran = fops.resolve_bwd_variant(q, k, v, variant)
    picked = "sm90" if (dk, dtype) == (192, torch.bfloat16) else "mma_sync"
    assert ran == (variant or picked)
    before = dict(fops.bwd_launches_by_variant)
    got = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal, q_offset=off,
                                        variant=variant)
    assert fops.bwd_launches_by_variant == dict(before, **{ran: before[ran] + 1})
    want = flash_attention_bwd_ref(q, k, v, o, do, causal=causal, q_offset=off)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max()), (name, err)
    again = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal, q_offset=off,
                                          variant=variant)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_flash_bwd_mla_forced_sm90_raises(cuda):
    """Forcing the sm90 backward raises, and launches nothing, at (48, 32),
    in fp32 at (192, 128) and at bf16 (192, 128) with fewer than 64 rows;
    bf16 (192, 128) with 64 rows or more resolves to it. A pair outside
    MLA_HEAD_DIMS, and o and dO not d_v wide, are refused."""
    case = (1, 128, 128, 2, 2, True, 0)
    lacks = [(case, 48, 32, torch.bfloat16), (case, 192, 128, torch.float32),
             ((1, 63, 128, 2, 2, True, 0), 192, 128, torch.bfloat16)]
    inputs = [_mla_bwd_inputs(cuda, dtype, c, dk, dv, seed=1) for c, dk, dv, dtype in lacks]
    q, k, v, o, do = _mla_bwd_inputs(cuda, torch.bfloat16, case, 192, 128, seed=1)
    before = dict(fops.bwd_launches_by_variant)
    for x in inputs:
        with pytest.raises(ValueError, match="sm90 backward"):
            fops.flash_attention_bwd_cuda(*x, causal=True, variant="sm90")
    assert fops.resolve_bwd_variant(q, k, v) == "sm90"
    assert fops.resolve_bwd_variant(q, k, v, "sm90") == "sm90"
    with pytest.raises(ValueError, match="head dims"):
        fops.flash_attention_bwd_cuda(q, k, q[..., :64], o[..., :64], do[..., :64],
                                      causal=True)
    with pytest.raises(ValueError, match="d_v"):
        fops.flash_attention_bwd_cuda(q, k, v, q, q, causal=True)
    assert fops.bwd_launches_by_variant == before


@pytest.mark.parametrize("dk,dv", [(192, 128), (48, 32)])
def test_flash_bwd_mla_reads_a_strided_v(cuda, dk, dv):
    """v as the strided half of a K/V expansion and a non-contiguous dO:
    the same gradients, bitwise, as contiguous copies; (192, 128) through
    the sm90 backward (its TMA maps take v's and dO's strides), (48, 32)
    through the mma_sync one."""
    q, k, v, o, _ = _mla_bwd_inputs(cuda, torch.bfloat16, (2, 96, 96, 4, 4, True, 0),
                                    dk, dv, seed=2)
    do = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 96, dv)).astype(np.float32)).to(cuda, torch.bfloat16).transpose(1, 2)
    assert not v.is_contiguous() and not do.is_contiguous()
    ran = "sm90" if dk == 192 else "mma_sync"
    before = fops.bwd_launches_by_variant[ran]
    got = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=True)
    want = fops.flash_attention_bwd_cuda(*(x.contiguous() for x in (q, k, v, o, do)),
                                         causal=True)
    assert fops.bwd_launches_by_variant[ran] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_moe_smoke_train_step_on_card_matches_cpu(cuda, arch):
    """value_and_grad of the smoke model (deepseek-v2's: MLA at (48, 32))
    in fp32 on the card against float64 on one CPU thread, at 8 slots an
    expert (drops): the loss within 1e-5 relative and each gradient leaf
    within 1e-4 of its largest magnitude; every backward call on the
    mma_sync backward."""
    from repro_torch.train.train_loop import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    # 128 tokens at factor 0.01: int(128 * 2 / 4 * 0.01) = 0, 8 slots an expert
    cfg = reduce_for_smoke(get_config(arch)).replace(compute_dtype_str="float32",
                                                     capacity_factor=0.01)
    f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    params = f64.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 65)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    before = dict(fops.bwd_launches_by_variant)
    lc, gc = value_and_grad(card, tree_map(lambda a: a.to(cuda), params),
                            {k: v.to(cuda) for k, v in batch.items()})
    assert fops.bwd_launches_by_variant == dict(
        before, mma_sync=before["mma_sync"] + cfg.n_layers)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lr_, gr = value_and_grad(f64, params, batch)
    finally:
        torch.set_num_threads(threads)
    assert abs(float(lc) - float(lr_)) <= 1e-5 * abs(float(lr_))
    for a, b in zip(tree_leaves(gc), tree_leaves(gr)):
        assert float((a.cpu().double() - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_on_card_match_cpu(cuda, name):
    """Each ported example (``python -m repro_torch.examples.<name>``) at
    the reference's sizes on the card, against its run on the CPU
    (``examples._common.card_vs_cpu``): integers, bools, ids and the
    reconcile audit bitwise, means and sums to rtol 1e-5, serve_lm's logits
    along the card's ids within ``serve_lm.LOGIT_TOL``, every flash call
    held to its plain version on its own tensors; and every kernel the
    example runs launched at least once."""
    before = launch_counts()
    got = card_vs_cpu(name, cuda)
    launched = launches_since(before)
    assert not got["mismatches"], got
    assert not missing_kernels(name, launched), launched
    if name == "serve_lm":
        assert got["flash_calls"]["calls"] == {"decode": 144}, got["flash_calls"]


def test_examples_refuse_a_planted_decode_fault(cuda):
    """serve_lm on the card with every decode result's two KV groups
    swapped: both the per-call hold and the logits refuse it."""
    got = card_vs_cpu("serve_lm", cuda, fault=lambda o: o.roll(2, 2))
    assert got["flash_calls"]["bad_calls"] == 144, got["flash_calls"]
    assert got["mismatches"][0].startswith(".logits"), got["mismatches"][:3]


def test_analysis_builds_once_then_never(cuda, tmp_path):
    """``repro_torch.analysis.retrace.build_check``: a child process over
    an empty build directory builds and loads st_scan, hash64 and
    voronoi_assign exactly once each in its cold run and nothing warm; a
    second child over the same directory builds nothing."""
    from repro_torch.analysis import retrace
    got = retrace.build_check(str(tmp_path))
    assert got["ok"], got
    first = got["children"]["first"]
    assert first["single"]["cold"]["builds"] == {
        "st_scan": 1, "hash64": 1, "voronoi_assign": 1}, first
    assert all(not leg["cold"]["builds"]
               for leg in got["children"]["second"].values()
               if isinstance(leg, dict) and "cold" in leg)


def test_analysis_sync_counters_side_by_side(cuda):
    """The canonical workload on the card under both sync counters: every
    read the TorchFunctionMode counts is a synchronisation that
    ``set_sync_debug_mode`` also reports, so per entry point the second
    count is at least the first; a planted ``.item()`` in every insert
    raises both by one a call, and the launches do not move."""
    from repro_torch.analysis import retrace
    from repro_torch.api.session import AerialDB
    cfg = retrace.canonical_config(tuple_capacity=384 + 128 * 7)
    base = retrace.Meter(cuda)
    retrace.canonical_workload(cfg, None, cuda, retrace.Meter(cuda))   # fills
    retrace.canonical_workload(cfg, None, cuda, base)
    for entry, c in base.report().items():
        assert c["sync_debug"] >= c["syncs"], (entry, c)
    real = AerialDB.insert

    def insert(self, payload, meta):
        info = real(self, payload, meta)
        info["intake_per_edge"].sum().item()
        return info
    planted = retrace.Meter(cuda)
    AerialDB.insert = insert
    try:
        retrace.canonical_workload(cfg, None, cuda, planted)
    finally:
        AerialDB.insert = real
    a, b = base.report()["insert"], planted.report()["insert"]
    assert b["syncs"] == a["syncs"] + 2 and b["ops"]["item"] == 2, (a, b)
    assert b["sync_debug"] >= a["sync_debug"] + 2, (a, b)
    assert b["launches"] == a["launches"] and sum(a["launches"].values()) > 0


# ---------------------------------------------------------------------------
# The Mamba1 family and temperature sampling (plain torch ops on the card,
# held to the CPU): ``-k ssm``, ``-k sampling``.
# ---------------------------------------------------------------------------

def test_ssm_smoke_model_on_card_matches_cpu(cuda):
    """falcon-mamba-7b's smoke model (4 layers, d_inner 256, state 8, chunk
    16) in fp32 on the card, forward on 2 x 64 tokens bitwise the same twice
    and 40 decode steps, within SMOKE_F64_TOL of the same weights in
    float64 on one CPU thread (the scan in float32, as the reference pins
    it); no flash launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("falcon-mamba-7b")).replace(
        compute_dtype_str="float32")
    f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    params = f64.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    cparams = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    before = fops.launches
    h_card, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    again, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    assert torch.equal(h_card, again)
    cg = card.init_cache(2, 64)
    for t in range(40):
        cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(cuda)}, t)
    assert fops.launches == before
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h_ref, _ = f64.forward(params, {"tokens": toks})
        cr = f64.init_cache(2, 64)
        for t in range(40):
            cr, lr = f64.decode_step(params, cr, {"tokens": toks[:, t:t + 1]}, t)
    finally:
        torch.set_num_threads(threads)
    tol = dict(rtol=SMOKE_F64_TOL, atol=SMOKE_F64_TOL)
    torch.testing.assert_close(h_card.cpu().double(), h_ref, **tol)
    torch.testing.assert_close(lg.cpu().double(), lr, **tol)
    assert cg["h"].dtype == torch.float32 and cg["conv"].dtype == torch.float32


def test_sampling_draws_on_card_match_cpu(cuda):
    """8- and 16-bit bits and bf16 uniforms bitwise; bf16 gumbels bitwise
    over 2^20 draws (each bf16 ``log`` lies far from a rounding midpoint);
    float32 gumbels within 1e-5 (``log`` in ulps)."""
    from repro_torch.core import threefry
    key = threefry.fold_in(threefry.key(0), 3)
    for width in (8, 16):
        got = threefry.random_bits(key, (1 << 20,), device=cuda, width=width)
        assert torch.equal(got.cpu(), threefry.random_bits(key, (1 << 20,), "cpu", width))
    for fn in (threefry.uniform, threefry.gumbel):
        got = fn(key, (1 << 20,), device=cuda, dtype=torch.bfloat16)
        want = fn(key, (1 << 20,), device="cpu", dtype=torch.bfloat16)
        assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16)), fn
    torch.testing.assert_close(threefry.gumbel(key, (1 << 20,), device=cuda).cpu(),
                               threefry.gumbel(key, (1 << 20,), device="cpu"),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sampling_categorical_on_card_matches_cpu(cuda, dtype):
    """``categorical`` on the same logits (8 x 92672, internlm2-1.8b's
    padded vocab) on the card and the CPU: every row equal in bf16
    (bitwise gumbels); in float32 every row whose perturbed top-2 gap
    exceeds 1e-5."""
    from repro_torch.core import threefry
    rng = np.random.default_rng(11)
    for step in range(4):
        logits = torch.from_numpy(rng.standard_normal((8, 92672)).astype(np.float32) * 3
                                  ).to(dtype)
        key = threefry.fold_in(threefry.key(step), step)
        got = threefry.categorical(key, logits.to(cuda))
        assert got.device.type == cuda.type and got.dtype == torch.int32
        want = threefry.categorical(key, logits)
        if dtype == torch.bfloat16:
            assert torch.equal(got.cpu(), want)
            continue
        p = threefry.gumbel(key, logits.shape, "cpu") + logits
        top2 = torch.topk(p, 2, dim=-1).values
        held = (top2[:, 0] - top2[:, 1]) > 1e-5
        assert torch.equal(got.cpu()[held], want[held])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b"])
def test_sampling_ids_repeat_per_seed(cuda, arch):
    """The sampled Engine on the card (smoke size, bf16 compute): the same
    seed gives the same ids, another seed other ids, and the decode kernel
    launches as often as in the greedy run (none for the ssm family)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = reduce_for_smoke(get_config(arch))
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (4, 12)).astype(np.int32)

    def run(**kw):
        before = fops.launches_by_variant["decode"]
        ids = Engine(model, params, ServeConfig(max_new_tokens=24, max_seq=64, **kw)
                     ).generate(prompts)
        return ids, fops.launches_by_variant["decode"] - before
    greedy, n_greedy = run()
    a, n_a = run(temperature=0.7, seed=0)
    b, _ = run(temperature=0.7, seed=0)
    c, _ = run(temperature=0.7, seed=1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a, greedy)
    assert n_a == n_greedy == (cfg.n_layers * 36 if cfg.family == "dense" else 0)


# ---------------------------------------------------------------------------
# The Mamba2 hybrid family (zamba2-1.2b): ``-k hybrid``.
# ---------------------------------------------------------------------------

def test_hybrid_smoke_model_on_card_matches_cpu(cuda):
    """zamba2-1.2b's smoke model (4 Mamba2 layers, the shared block after
    layers 1 and 3, d_head 32) in fp32 on the card, forward on 2 x 64
    tokens (four SSD chunks) bitwise the same twice and 40 decode steps,
    within SMOKE_F64_TOL of the same weights in float64 on one CPU thread
    (the SSD in float32, as the reference pins it); the shared block's
    attention goes to the mma_sync kernel in fp32, once a site and call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("zamba2-1.2b")).replace(
        compute_dtype_str="float32")
    f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    params = f64.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    cparams = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    before = fops.launches_by_variant["mma_sync"]
    h_card, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    again, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    assert torch.equal(h_card, again)
    cg = card.init_cache(2, 64)
    for t in range(40):
        cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(cuda)}, t)
    assert fops.launches_by_variant["mma_sync"] == before + 2 * 2 + 2 * 40
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h_ref, _ = f64.forward(params, {"tokens": toks})
        cr = f64.init_cache(2, 64)
        for t in range(40):
            cr, lr = f64.decode_step(params, cr, {"tokens": toks[:, t:t + 1]}, t)
    finally:
        torch.set_num_threads(threads)
    tol = dict(rtol=SMOKE_F64_TOL, atol=SMOKE_F64_TOL)
    torch.testing.assert_close(h_card.cpu().double(), h_ref, **tol)
    torch.testing.assert_close(lg.cpu().double(), lr, **tol)
    assert cg["h"].dtype == torch.float32 and cg["k"].dtype == torch.float32


def test_hybrid_d64_prefill_and_generate_send_flash_to_their_kernels(cuda):
    """The smoke hybrid at zamba2-1.2b's head dim (d 64, 4 heads over 4) in
    bf16: prefill_step's two sites on the sm90 kernel, every decode site
    (prompt and new tokens) on the decode kernel, none on mma_sync; finite
    logits and the same ids twice."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = reduce_for_smoke(get_config("zamba2-1.2b")).replace(d_head=64)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    engine = Engine(model, params, ServeConfig(max_new_tokens=6, max_seq=96))
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 80)).astype(np.int32)
    prefill_step, _ = make_serve_steps(model)
    before = dict(fops.launches_by_variant)
    logits = prefill_step(engine.params, {"tokens": torch.from_numpy(prompts).to(cuda)})
    after = dict(fops.launches_by_variant)
    assert after["sm90"] == before["sm90"] + 2 and after["mma_sync"] == before["mma_sync"]
    assert logits.shape == (2, cfg.vocab_padded) and torch.isfinite(logits).all()
    ids = engine.generate(prompts)
    done = dict(fops.launches_by_variant)
    assert done["decode"] - after["decode"] == 2 * (80 + 6)
    assert done["mma_sync"] == after["mma_sync"] and done["sm90"] == after["sm90"]
    assert np.array_equal(ids, engine.generate(prompts))


# ---------------------------------------------------------------------------
# The MoE family (grok-1-314b): ``-k moe``.
# ---------------------------------------------------------------------------

# The smoke model card vs float64 CPU, as chip_smoke's moe_vs_cpu holds it;
# routes are held except at tokens whose k-th and (k+1)-th probabilities
# lie within MOE_TIE (the two runs' probabilities differ by ulps).
MOE_F64_TOL = 1e-4
MOE_TIE = 1e-5


class _Routes:
    """Records every ``moe._route`` call's expert indices and the gap
    between its k-th and (k+1)-th routing probabilities, on the CPU."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.idx, self.gap = moe, moe._route, [], []

        def route(p, x, cfg):
            out = self.orig(p, x, cfg)
            probs = torch.softmax((x @ p["gate"].to(cfg.compute_dtype)).float(), -1)
            top = torch.sort(probs, -1, descending=True).values
            self.idx.append(out[0].cpu())
            self.gap.append((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).cpu())
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig


@pytest.mark.parametrize("factor", [1.25, 0.01], ids=["full", "cap8"])
def test_moe_smoke_model_on_card_matches_cpu(cuda, factor):
    """grok-1-314b's smoke model (4 layers, 4 experts top-2, expert width
    64) in fp32 on the card, forward on 2 x 64 tokens bitwise the same
    twice and 40 decode steps, within MOE_F64_TOL of the same weights in
    float64 on one CPU thread; the routes and the kept mask of every
    forward layer equal the CPU's away from MOE_TIE. At factor 0.01 the
    forward has 8 slots an expert (int(128 * 2 / 4 * 0.01) = 0) against a
    mean load of 64, so pairs drop; a decode step (2 tokens) never does.
    Attention goes to the mma_sync kernel in fp32, once a layer and call."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("grok-1-314b")).replace(
        compute_dtype_str="float32", capacity_factor=factor)
    f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    params = f64.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    cparams = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    before = fops.launches_by_variant["mma_sync"]
    with _Routes() as rc:
        h_card, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    again, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    assert torch.equal(h_card, again)
    cg = card.init_cache(2, 64)
    for t in range(40):
        cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(cuda)}, t)
    assert fops.launches_by_variant["mma_sync"] == before + 4 * 2 + 4 * 40
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _Routes() as rr:
            h_ref, _ = f64.forward(params, {"tokens": toks})
        cr = f64.init_cache(2, 64)
        for t in range(40):
            cr, lr = f64.decode_step(params, cr, {"tokens": toks[:, t:t + 1]}, t)
    finally:
        torch.set_num_threads(threads)
    cap = moe._capacity(128, cfg)
    assert cap == (8 if factor < 1 else 128)
    dropped = 0
    for ic, ir, gap in zip(rc.idx, rr.idx, rr.gap):
        held = gap > MOE_TIE
        assert torch.equal(ic[held], ir[held])
        kc, kr = moe.slots(ic, cfg.n_experts, cap)[1], moe.slots(ir, cfg.n_experts, cap)[1]
        assert torch.equal(kc[held], kr[held])
        dropped += int((~kr).sum())
    assert len(rc.idx) == 4 and (dropped > 0) == (factor < 1)
    tol = dict(rtol=MOE_F64_TOL, atol=MOE_F64_TOL)
    torch.testing.assert_close(h_card.cpu().double(), h_ref, **tol)
    torch.testing.assert_close(lg.cpu().double(), lr, **tol)


def test_moe_prefill_and_generate_send_flash_to_their_kernels(cuda):
    """grok's smoke model at grok-1-314b's GQA group and head dim (12 heads
    over 2, G 6, d 128) in bf16: prefill_step's layers on the sm90 kernel,
    every decode layer (prompt and new tokens) on the decode kernel, none
    on mma_sync; finite logits and the same ids twice."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = reduce_for_smoke(get_config("grok-1-314b")).replace(
        n_heads=12, n_kv=2, d_head=128)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    engine = Engine(model, params, ServeConfig(max_new_tokens=6, max_seq=96))
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 80)).astype(np.int32)
    prefill_step, _ = make_serve_steps(model)
    before = dict(fops.launches_by_variant)
    logits = prefill_step(engine.params, {"tokens": torch.from_numpy(prompts).to(cuda)})
    after = dict(fops.launches_by_variant)
    assert after["sm90"] == before["sm90"] + 4 and after["mma_sync"] == before["mma_sync"]
    assert logits.shape == (2, cfg.vocab_padded) and torch.isfinite(logits).all()
    ids = engine.generate(prompts)
    done = dict(fops.launches_by_variant)
    assert done["decode"] - after["decode"] == 4 * (80 + 6)
    assert done["mma_sync"] == after["mma_sync"] and done["sm90"] == after["sm90"]
    assert np.array_equal(ids, engine.generate(prompts))


# MLA's unequal head dims: q and k of d_qk, v of d_v, v the second half of
# each head's columns of a wider tensor (as MLA's v is a view of its K/V
# expansion). (b, sq, skv, h, kv, causal, q_offset)
MLA_CASES = [(1, 2048, 2048, 128, 128, True, 0),   # deepseek-v2-236b's prefill, B 1
             (2, 77, 131, 4, 4, True, 54),         # ragged Sq and Skv, q_offset
             (2, 200, 200, 8, 8, False, 0),        # bidirectional
             (2, 200, 200, 8, 4, True, 0)]         # GQA group 2
MLA_SMOKE_CASES = [(2, 77, 131, 4, 2, True, 54), (2, 64, 64, 4, 4, False, 0),
                   (2, 1, 40, 4, 4, True, 39)]


def _mla_case(cuda, dtype, case, dk, dv, variant):
    b, sq, skv, h, kv, causal, off = case
    rng = np.random.default_rng(sq + h + dk)
    q, k, kvb = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(cuda, dtype) for shape in ((b, sq, h, dk), (b, skv, kv, dk),
                                                (b, skv, kv, 2 * dv)))
    v = kvb[..., dv:]
    before = dict(fops.launches_by_variant)
    got = fops.flash_attention_cuda(q, k, v, causal=causal, q_offset=off,
                                    variant=variant)
    assert fops.launches_by_variant[variant] == before[variant] + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == dtype and got.shape == (b, sq, h, dv)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, fops.flash_attention_cuda(q, k, v, causal=causal,
                                                      q_offset=off, variant=variant))


@pytest.mark.parametrize("variant,dtype", [("sm90", torch.bfloat16),
                                           ("mma_sync", torch.bfloat16),
                                           ("mma_sync", torch.float32)],
                         ids=["sm90", "mma_sync_bf16", "mma_sync_f32"])
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_flash_mla_d192_matches_plain(cuda, case, variant, dtype):
    _mla_case(cuda, dtype, case, 192, 128, variant)


@pytest.mark.parametrize("case", MLA_SMOKE_CASES, ids=str)
def test_flash_mla_d48_f32_matches_plain(cuda, case):
    _mla_case(cuda, torch.float32, case, 48, 32, "mma_sync")


def test_flash_mla_chooses_its_kernels(cuda):
    """Unforced: deepseek's bf16 prefill shape on sm90, its fp32 and the
    smoke dims on mma_sync; an unlisted pair raises."""
    for (sq, dk, dv, dtype), want in (((128, 192, 128, torch.bfloat16), "sm90"),
                                      ((128, 192, 128, torch.float32), "mma_sync"),
                                      ((8, 192, 128, torch.bfloat16), "mma_sync"),
                                      ((128, 48, 32, torch.bfloat16), "mma_sync")):
        q = torch.randn((1, sq, 4, dk), device=cuda).to(dtype)
        k = torch.randn((1, sq, 4, dk), device=cuda).to(dtype)
        v = torch.randn((1, sq, 4, dv), device=cuda).to(dtype)
        before = dict(fops.launches_by_variant)
        fops.flash_attention(q, k, v, causal=True)
        assert fops.launches_by_variant[want] == before[want] + 1
    bad = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fops.flash_attention_cuda(torch.zeros((1, 8, 2, 128), device=cuda,
                                              dtype=torch.bfloat16),
                                  torch.zeros((1, 8, 2, 128), device=cuda,
                                              dtype=torch.bfloat16), bad, causal=True)


def test_sm90_probe_mla_matches_matmul(cuda):
    """The (192, 128) layout: Q and K rows of three 64-column slabs (QK^T in
    12 k-steps), V rows of two (one n128 PV product), 128-key tiles;
    against torch.matmul in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(192)
    keys = fops.SM90_MLA_KEYS[(192, 128)]
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, torch.bfloat16) for shape in ((64, 192), (keys, 192),
                                                       (keys, 128)))
    s, o = fops.sm90_probe(q, k, v)
    assert s.shape == (64, keys) and o.shape == (64, 128)
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(o, s.to(torch.bfloat16).float() @ v.float(),
                               rtol=1e-4, atol=1e-3)


def test_mla_smoke_model_on_card_matches_cpu(cuda):
    """deepseek-v2-236b's smoke model (1 dense and 3 MoE layers, MLA at q/k
    48 and v 32) in fp32 on the card, forward on 2 x 64 tokens bitwise the
    same twice and 40 decode steps, within MOE_F64_TOL of the same weights
    in float64 on one CPU thread. The prefill's attention goes to the
    mma_sync kernel at (48, 32), once a layer; the decode attends in the
    latent space and launches none. Routes are held as in the moe test."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_for_smoke(get_config("deepseek-v2-236b")).replace(
        compute_dtype_str="float32")
    f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    params = f64.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    cparams = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    before = dict(fops.launches_by_variant)
    with _Routes() as rc:
        h_card, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    again, _ = card.forward(cparams, {"tokens": toks.to(cuda)})
    assert torch.equal(h_card, again)
    cg = card.init_cache(2, 64)
    for t in range(40):
        cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(cuda)}, t)
    after = dict(fops.launches_by_variant)
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), mma_sync=4 * 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _Routes() as rr:
            h_ref, _ = f64.forward(params, {"tokens": toks})
        cr = f64.init_cache(2, 64)
        for t in range(40):
            cr, lr = f64.decode_step(params, cr, {"tokens": toks[:, t:t + 1]}, t)
    finally:
        torch.set_num_threads(threads)
    for ic, ir, gap in zip(rc.idx, rr.idx, rr.gap):
        held = gap > MOE_TIE
        assert torch.equal(ic[held], ir[held])
    assert len(rc.idx) == 3
    tol = dict(rtol=MOE_F64_TOL, atol=MOE_F64_TOL)
    torch.testing.assert_close(h_card.cpu().double(), h_ref, **tol)
    torch.testing.assert_close(lg.cpu().double(), lr, **tol)


def test_mla_prefill_and_generate_send_flash_to_their_kernels(cuda):
    """deepseek's smoke model at deepseek-v2-236b's MLA head dims (q/k 128
    + 64, v 128, kv_lora 512) in bf16: prefill_step's 4 layers on the sm90
    kernel at (192, 128), and no flash launch at all in the engine's decode
    steps (the absorbed attention is torch ops); finite logits and the same
    ids twice."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = reduce_for_smoke(get_config("deepseek-v2-236b")).replace(
        kv_lora=512, mla_nope_dim=128, mla_rope_dim=64, mla_v_dim=128)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    engine = Engine(model, params, ServeConfig(max_new_tokens=6, max_seq=96))
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (2, 80)).astype(np.int32)
    prefill_step, _ = make_serve_steps(model)
    before = dict(fops.launches_by_variant)
    logits = prefill_step(engine.params, {"tokens": torch.from_numpy(prompts).to(cuda)})
    after = dict(fops.launches_by_variant)
    assert after["sm90"] == before["sm90"] + 4 and after["mma_sync"] == before["mma_sync"]
    assert logits.shape == (2, cfg.vocab_padded) and torch.isfinite(logits).all()
    ids = engine.generate(prompts)
    assert dict(fops.launches_by_variant) == after
    assert np.array_equal(ids, engine.generate(prompts))
