"""Port of the shard index and the planners (``repro_torch.core.index`` /
``planner``) held bitwise against the JAX package: every IndexState leaf
after inserts (including capacity overflow), retirement and compaction;
every MatchedShards slot of ``dedup_matched``/``lookup`` (valid or not);
and the ``min_shards`` / ``min_edges`` / ``random`` assignments under alive
masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as ji
from repro.core import planner as jpl
from repro.core.placement import ShardMeta as JMeta
from repro_torch import convert
from repro_torch.core import index as ti
from repro_torch.core import planner as tpl
from repro_torch.core.placement import ShardMeta as TMeta


def _meta(rng, b):
    lat = rng.uniform(0, 10, (b, 2)).astype(np.float32)
    t = rng.uniform(0, 1000, (b, 2)).astype(np.float32)
    return dict(sid_hi=rng.integers(-3, 3, b).astype(np.int32),
                sid_lo=rng.integers(0, 50, b).astype(np.int32),
                lat0=lat.min(1), lat1=lat.max(1), lon0=lat.min(1) + 1,
                lon1=lat.max(1) + 1, t0=t.min(1), t1=t.max(1))


def assert_index_equal(t, j):
    for name, a, b in zip(ti.IndexState._fields, t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def build_pair(seed, e=5, cap=24, rounds=4, b=9):
    """The same random insert stream through both packages."""
    rng = np.random.default_rng(seed)
    jst = ji.init_index(e, cap)
    tst = ti.init_index(e, cap)
    for step in range(1, rounds + 1):
        m = _meta(rng, b)
        reps = rng.integers(-1, e, (b, 3)).astype(np.int32)
        mask = rng.random((b, e)) < 0.6
        jst = ji.insert_entries(jst, JMeta(**{k: jnp.asarray(v) for k, v in m.items()}),
                                jnp.asarray(reps), jnp.asarray(mask), step=step)
        ti.insert_entries(tst, TMeta(**{k: torch.from_numpy(v) for k, v in m.items()}),
                          torch.from_numpy(reps), torch.from_numpy(mask), step=step)
    return tst, jst


@pytest.mark.parametrize("seed,cap", [(0, 64), (1, 24), (2, 7)])
def test_insert_entries_matches_jax(seed, cap):
    tst, jst = build_pair(seed, cap=cap)
    assert_index_equal(tst, jst)
    if cap < 10:
        assert int(tst.dropped.sum()) > 0          # capacity overflow covered


def test_retire_and_compact_match_jax():
    tst, jst = build_pair(3, cap=40, rounds=5)
    wm = np.array([-np.inf, 300.0, 700.0, -np.inf, 2000.0], np.float32)
    jst = ji.retire_entries(jst, jnp.asarray(wm))
    ti.retire_entries(tst, torch.from_numpy(wm))
    assert_index_equal(tst, jst)
    assert int(tst.retired.sum()) > 0
    jst = ji.compact_index(jst)
    ti.compact_index(tst)
    assert_index_equal(tst, jst)
    # Freed slots are reused by the next insert exactly as in the reference.
    rng = np.random.default_rng(9)
    m = _meta(rng, 6)
    reps = rng.integers(0, 5, (6, 3)).astype(np.int32)
    mask = rng.random((6, 5)) < 0.7
    jst = ji.insert_entries(jst, JMeta(**{k: jnp.asarray(v) for k, v in m.items()}),
                            jnp.asarray(reps), jnp.asarray(mask), step=9)
    ti.insert_entries(tst, TMeta(**{k: torch.from_numpy(v) for k, v in m.items()}),
                      torch.from_numpy(reps), torch.from_numpy(mask), step=9)
    assert_index_equal(tst, jst)


def _candidates(rng, q, n):
    m = rng.random((q, n)) < 0.4
    hi = rng.integers(-2, 3, (q, n)).astype(np.int32)
    hi[:, :3] = [-2**31, 2**31 - 1, -1]          # extreme keys sort right
    lo = rng.integers(-5, 40, (q, n)).astype(np.int32)
    reps = rng.integers(-1, 8, (q, n, 3)).astype(np.int32)
    m[0] = False                                  # a query matching nothing
    return m, hi, lo, reps


def assert_matched_equal(t, j):
    for name, a, b in zip(ti.MatchedShards._fields, t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("s", [4, 32, 200])
def test_dedup_matched_matches_jax(s):
    rng = np.random.default_rng(s)
    m, hi, lo, reps = _candidates(rng, 6, 300)
    got = ti.dedup_matched(*(torch.from_numpy(x) for x in (m, hi, lo, reps)), s)
    want = ji.dedup_matched(*(jnp.asarray(x) for x in (m, hi, lo, reps)), s)
    assert_matched_equal(got, want)
    if s == 4:
        assert got.overflow.any()


def test_dedup_query_blocks_change_nothing(monkeypatch):
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(x) for x in _candidates(rng, 7, 120)]
    whole = ti.dedup_matched(*args, 16)
    monkeypatch.setattr(ti, "_DEDUP_BLOCK", 250)   # two queries per block
    assert_matched_equal(ti.dedup_matched(*args, 16), whole)


def test_lookup_matches_jax():
    tst, jst = build_pair(6, e=5, cap=64, rounds=6, b=12)
    rng = np.random.default_rng(6)
    q = 6
    pred = dict(lat0=rng.uniform(0, 5, q), lat1=rng.uniform(5, 10, q),
                lon0=rng.uniform(1, 6, q), lon1=rng.uniform(6, 11, q),
                t0=rng.uniform(0, 500, q), t1=rng.uniform(500, 1000, q))
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    ints = dict(sid_hi=rng.integers(-3, 3, q).astype(np.int32),
                sid_lo=rng.integers(0, 50, q).astype(np.int32))
    flags = dict(has_spatial=rng.random(q) < 0.7, has_temporal=rng.random(q) < 0.7,
                 has_sid=rng.random(q) < 0.4, is_and=rng.random(q) < 0.5)
    lookup_mask = rng.random((q, 5)) < 0.7
    allf = {**pred, **ints, **flags}
    jp_ = ji.QueryPred(**{k: jnp.asarray(v) for k, v in allf.items()})
    tp_ = ti.QueryPred(**{k: torch.from_numpy(v) for k, v in allf.items()})
    np.testing.assert_array_equal(ti.entry_matches(tst, tp_).numpy(),
                                  np.asarray(ji.entry_matches(jst, jp_)))
    for s in (3, 16):
        assert_matched_equal(
            ti.lookup(tst, tp_, torch.from_numpy(lookup_mask), s),
            ji.lookup(jst, jp_, jnp.asarray(lookup_mask), s))


def _matched(rng, q=8, s=24, e=10):
    valid = rng.random((q, s)) < 0.8
    reps = rng.integers(-1, e, (q, s, 3)).astype(np.int32)
    hi = rng.integers(0, 100, (q, s)).astype(np.int32)
    lo = rng.integers(0, 100, (q, s)).astype(np.int32)
    valid[0] = False
    ovf = np.zeros(q, bool)
    return hi, lo, reps, valid, ovf


@pytest.mark.parametrize("planner", ["min_shards", "min_edges", "random"])
@pytest.mark.parametrize("n_dead", [0, 3, 10])
def test_planners_match_jax(planner, n_dead):
    """Every planner with the same JAX key on both sides (the two greedy
    ones ignore it). The random planner's picks are held bitwise away from
    near-ties: shards whose top two reference gumbels among their alive
    replicas are under 1e-5 apart (the gumbels differ by the ulps of
    ``log``)."""
    rng = np.random.default_rng(n_dead)
    parts = _matched(rng)
    alive = np.ones(10, bool)
    alive[rng.choice(10, n_dead, replace=False)] = False
    jkey = jax.random.key(n_dead)
    got = tpl.plan(planner, ti.MatchedShards(*(torch.from_numpy(x) for x in parts)),
                   torch.from_numpy(alive),
                   convert.key_from_numpy(jax.random.key_data(jkey)))
    want = np.asarray(jpl.plan(planner, ji.MatchedShards(*(jnp.asarray(x) for x in parts)),
                               jnp.asarray(alive), jkey))
    assert got.dtype == torch.int32
    a = got.numpy()
    near = np.zeros(a.shape, bool)
    if planner == "random":
        reps, valid = parts[2], parts[3]
        ok = (reps >= 0) & alive[np.clip(reps, 0, None)] & valid[..., None]
        qkeys = jax.vmap(jax.random.fold_in, (None, 0))(jkey, jnp.arange(a.shape[0]))
        g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, reps.shape[1:]))(qkeys))
        top = np.sort(np.where(ok, g, np.float32(-1e30)), axis=-1)
        near = (ok.sum(-1) >= 2) & (top[..., -1] - top[..., -2] < 1e-5)
    np.testing.assert_array_equal(a[~near], want[~near])
    assert (a[0] == -1).all()          # no usable replica: nothing assigned
    if n_dead == 10:
        assert (a == -1).all()


def test_random_planner_needs_a_key():
    """As the reference: the random planner without a key is refused."""
    parts = _matched(np.random.default_rng(0))
    with pytest.raises(ValueError, match="random planner needs a PRNG key"):
        tpl.plan("random", ti.MatchedShards(*(torch.from_numpy(x) for x in parts)),
                 torch.ones(10, dtype=torch.bool))
