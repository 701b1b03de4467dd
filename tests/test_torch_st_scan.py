"""Port of the st_scan plain version (``repro_torch.kernels.st_scan.ref``)
and wrapper held against the JAX package's jnp reference and its Pallas
kernel in interpret mode, over the scenarios of ``tests/test_kernels.py``.
Policy: count, vmin and vmax bitwise; vsum to rtol 1e-5 (reduction order).
On the CPU the wrapper runs the plain version; the kernel itself is tested
on the card in ``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.datastore import make_pred as j_make_pred
from repro.kernels.st_scan import ops as j_ops
from repro.kernels.st_scan import ref as j_ref
from repro_torch.core.datastore import make_pred as t_make_pred
from repro_torch.kernels.st_scan import ops as t_ops
from repro_torch.kernels.st_scan import ref as t_ref


def problem(rng, e=4, c=1024, q=3, l=8, w=7):
    """Random column-major scan problem as numpy arrays (test_kernels.py)."""
    p = dict(
        tup_f=rng.uniform(0, 100, (e, w, c)).astype(np.float32),
        tup_sid=rng.integers(0, 6, (e, 2, c)).astype(np.int32),
        tup_count=rng.integers(0, c + 1, (e,)).astype(np.int32),
        sublists=rng.integers(0, 6, (q, e, l, 2)).astype(np.int32),
        sublist_len=rng.integers(-1, l + 1, (q, e)).astype(np.int32))
    p["pred"] = dict(
        q=q,
        lat0=rng.uniform(0, 50, q).astype(np.float32),
        lat1=rng.uniform(50, 100, q).astype(np.float32),
        lon0=rng.uniform(0, 50, q).astype(np.float32),
        lon1=rng.uniform(50, 100, q).astype(np.float32),
        t0=rng.uniform(0, 50, q).astype(np.float32),
        t1=rng.uniform(50, 100, q).astype(np.float32),
        sid_hi=rng.integers(0, 6, q).astype(np.int32),
        sid_lo=rng.integers(0, 6, q).astype(np.int32),
        has_spatial=rng.random(q) < 0.7,
        has_temporal=rng.random(q) < 0.7,
        has_sid=rng.random(q) < 0.3,
        is_and=rng.random(q) < 0.7)
    return p


def jax_args(p):
    return (jnp.asarray(p["tup_f"]), jnp.asarray(p["tup_sid"]),
            jnp.asarray(p["tup_count"]), j_make_pred(**p["pred"]),
            jnp.asarray(p["sublists"]), jnp.asarray(p["sublist_len"]))


def torch_args(p, device="cpu"):
    t = lambda k: torch.from_numpy(p[k]).to(device)
    return (t("tup_f"), t("tup_sid"), t("tup_count"),
            t_make_pred(**p["pred"], device=device), t("sublists"),
            t("sublist_len"))


def assert_policy(got, want):
    got = [np.asarray(g.cpu()) if isinstance(g, torch.Tensor) else np.asarray(g)
           for g in got]
    want = [np.asarray(x) for x in want]
    for g, x, name in zip(got, want, ("count", "vsum", "vmin", "vmax")):
        assert g.shape == x.shape and g.dtype == x.dtype, name
        if name == "vsum":
            np.testing.assert_allclose(g, x, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, x, err_msg=name)


def check(p, pallas=False, **kw):
    got = t_ops.st_scan(*torch_args(p), **kw)
    assert_policy(got, j_ref.st_scan_ref(*jax_args(p), **kw))
    if pallas:
        assert_policy(got, j_ops.st_scan(*jax_args(p), block_c=128,
                                         interpret=True, **kw))
    return got


@pytest.mark.parametrize("seed,c", [(0, 512), (1, 1024), (2, 1536), (3, 640)])
def test_matches_jax_ref_and_pallas(seed, c):
    check(problem(np.random.default_rng(seed), c=c), pallas=seed == 0)


def test_scan_all_sentinel():
    p = problem(np.random.default_rng(7))
    p["sublist_len"][:] = -1
    check(p, pallas=True)


def test_ring_count_clamp():
    """A count above capacity behaves exactly like a full log."""
    rng = np.random.default_rng(11)
    p = problem(rng)
    c = p["tup_f"].shape[2]
    p["tup_count"] = rng.integers(c + 1, 5 * c, 4).astype(np.int32)
    over = check(p)
    p["tup_count"] = np.full(4, c, np.int32)
    full = t_ops.st_scan(*torch_args(p))
    for a, b in zip(over, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("count", ["zero", "capacity"])
def test_empty_and_full_edges(count):
    rng = np.random.default_rng(21)
    p = problem(rng, c=512)
    p["tup_count"] = np.full(4, 0 if count == "zero" else 512, np.int32)
    got = check(p, pallas=count == "capacity")
    if count == "zero":
        assert int(got[0].sum()) == 0
        assert torch.isinf(got[2]).all() and torch.isinf(got[3]).all()


@pytest.mark.parametrize("c", [100, 129, 384])
def test_capacity_not_lane_multiple(c):
    check(problem(np.random.default_rng(c), c=c), pallas=c == 129)


@pytest.mark.parametrize("channel", [1, 3])
def test_channel_selection(channel):
    p = problem(np.random.default_rng(31 + channel))
    got = check(p, channels=(channel,))
    swapped = dict(p, tup_f=p["tup_f"].copy())
    swapped["tup_f"][:, 3] = p["tup_f"][:, 3 + channel]
    base = t_ops.st_scan(*torch_args(swapped))
    for a, b in zip(got, base):
        assert torch.equal(a, b)


def test_multi_channel_fused_equals_single_scans():
    p = problem(np.random.default_rng(41), c=640)
    channels = (0, 2, 3)
    got = check(p, pallas=True, channels=channels)
    assert got[1].shape == (3, 3, 4)
    for k, ch in enumerate(channels):
        one = t_ops.st_scan(*torch_args(p), channels=(ch,))
        assert torch.equal(got[0], one[0])
        for i in (1, 2, 3):
            assert torch.equal(got[i][:, k], one[i][:, 0])


def test_channel_out_of_range():
    args = torch_args(problem(np.random.default_rng(5), w=7))
    for chans, msg in (((4,), "channel=4"), ((-1,), "channel=-1"),
                       ((1, 1), "duplicates"), ((), "empty")):
        with pytest.raises(ValueError, match=msg):
            t_ops.st_scan(*args, channels=chans)


@pytest.mark.parametrize("q", [1, 3, 5, 9])
def test_query_counts_not_a_tile_multiple(q):
    got = check(problem(np.random.default_rng(q * 10), q=q, c=512))
    assert got[0].shape == (q, 4) and got[1].shape == (q, 1, 4)


def test_lane_padded_capacity_post_wrap():
    """Garbage in lane-padding slots above valid_c is never admitted."""
    rng = np.random.default_rng(55)
    cap, pad = 500, 140
    p = problem(rng, c=cap)
    unpadded = dict(p, tup_count=np.full(4, cap, np.int32))
    want = j_ref.st_scan_ref(*jax_args(unpadded))
    padded = dict(p)
    padded["tup_f"] = np.concatenate(
        [p["tup_f"], rng.uniform(0, 100, (4, 7, pad)).astype(np.float32)], 2)
    padded["tup_sid"] = np.concatenate(
        [p["tup_sid"], rng.integers(0, 6, (4, 2, pad)).astype(np.int32)], 2)
    padded["tup_count"] = rng.integers(cap + 1, 7 * cap, 4).astype(np.int32)
    assert_policy(t_ops.st_scan(*torch_args(padded), valid_c=cap), want)


def test_chunked_or_list_matches_single_chunk(monkeypatch):
    """The plain version's chunking over the tuple axis changes nothing."""
    p = problem(np.random.default_rng(61), c=1000, l=16)
    whole = t_ref.st_scan_ref(*torch_args(p))
    monkeypatch.setattr(t_ref, "_CHUNK_ELEMS", 4 * 16 * 7)
    chunked = t_ref.st_scan_ref(*torch_args(p))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_pack_pred_layout():
    p = problem(np.random.default_rng(3), q=5)["pred"]
    pf, pi = t_ops.pack_pred(t_make_pred(**p, device="cpu"))
    assert pf.shape == (5, 8) and pi.shape == (5, 8)
    assert pf.dtype == torch.float32 and pi.dtype == torch.int32
    np.testing.assert_array_equal(pf[:, 4].numpy(), p["t0"])
    np.testing.assert_array_equal(pi[:, 5].numpy(), p["is_and"].astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nan_values_match_jax_ref_and_pallas(seed):
    """NaN channel words in matched and unmatched slots, and NaN t/lat/lon:
    the port gives NaN sums, minima and maxima exactly where the JAX
    reference and the Pallas kernel do, and the same bits elsewhere."""
    rng = np.random.default_rng(300 + seed)
    p = problem(rng, c=512, q=9)
    f = p["tup_f"]
    f[:, 3:][rng.random(f[:, 3:].shape) < 0.02] = np.nan
    f[:, :3][rng.random(f[:, :3].shape) < 0.01] = np.nan
    got = check(p, pallas=True, channels=(0, 1, 2, 3))
    nan_min = torch.isnan(got[2])
    assert nan_min.any() and not nan_min.all()
    assert torch.equal(nan_min, torch.isnan(got[3]))
    assert torch.equal(nan_min, torch.isnan(got[1]))


def test_nan_in_one_matched_slot_matches_jax():
    """One matched slot holds NaN: min, max and sum of that query are NaN in
    the JAX reference, the Pallas kernel and the port; an empty query
    stays (0, +inf, -inf)."""
    p = problem(np.random.default_rng(9), e=1, c=128, q=2, l=4)
    p["tup_f"][:] = 1.0
    p["tup_f"][0, 3, 17] = np.nan
    p["tup_count"][:] = 128
    p["sublist_len"][:] = -1
    p["pred"].update(lat0=np.float32([0, 5]), lat1=np.float32([2, 6]),
                     lon0=np.float32([0, 0]), lon1=np.float32([2, 2]),
                     has_spatial=np.array([True, True]),
                     has_temporal=np.array([False, False]),
                     has_sid=np.array([False, False]),
                     is_and=np.array([True, True]))
    count, vsum, vmin, vmax = check(p, pallas=True)
    assert count.tolist() == [[128], [0]]
    assert all(bool(torch.isnan(x[0, 0, 0])) for x in (vsum, vmin, vmax))
    assert float(vmin[1, 0, 0]) == float("inf")
    assert float(vmax[1, 0, 0]) == -float("inf")


def test_matched_slots_is_the_union_of_the_query_masks():
    """matched_slots marks exactly the slots some query aggregates: a scan
    restricted to them gives the same counts, and so does none outside."""
    p = problem(np.random.default_rng(71), c=640, q=5)
    args = torch_args(p)
    m = t_ref.matched_slots(*args)
    count = t_ref.st_scan_ref(*args)[0]
    assert m.shape == (4, 640) and m.dtype == torch.bool
    assert 0 < int(m.sum()) <= int(count.sum())
    f = torch.from_numpy(p["tup_f"]).clone()
    f[:, 0][~m] = float("nan")          # a NaN time matches no query
    got = t_ref.st_scan_ref(f, *args[1:])
    masked_pred = p["pred"]["has_temporal"] & p["pred"]["is_and"]
    assert torch.equal(got[0][torch.from_numpy(masked_pred)],
                       count[torch.from_numpy(masked_pred)])


@pytest.mark.parametrize("valid_c,splits", [(0, 1), (1, 1), (1024, 1), (1025, 2),
                                            (4963, 5), (8192, 8), (262144, 8)])
def test_scan_splits(valid_c, splits):
    """One block an edge per 1024 slots of the ring, at most 8 (the
    portable cluster size)."""
    assert t_ops.scan_splits(valid_c) == splits
