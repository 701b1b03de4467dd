"""Port of H_s, placement and slicing (``repro_torch.core.{voronoi,
placement,slicing}`` and the ``voronoi_assign`` kernel wrapper) held against
the JAX package: integer outputs bitwise; Voronoi assignments bitwise on
every point whose float64 top-2 distance gap exceeds 1e-6 relative (closer
points sit on a cell boundary within float32 rounding). On the CPU the
wrapper runs the plain version; the kernel itself is tested on the card in
``test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import placement as jp
from repro.core import slicing as js
from repro.core.voronoi import voronoi_assign as j_voronoi
from repro.data.synthetic import CityConfig, make_sites
from repro_torch.core import placement as tp
from repro_torch.core import slicing as ts
from repro_torch.core import voronoi as tv
from repro_torch.kernels.voronoi_assign import ops as vops
from repro_torch.kernels.voronoi_assign import ref as vref

CITY = CityConfig()


def _points(rng, n):
    return rng.uniform([CITY.lat_min, CITY.lon_min], [CITY.lat_max, CITY.lon_max],
                       (n, 2)).astype(np.float32)


def _meta(rng, n, e_sid=100):
    lat = rng.uniform(CITY.lat_min, CITY.lat_max, (n, 2)).astype(np.float32)
    lon = rng.uniform(CITY.lon_min, CITY.lon_max, (n, 2)).astype(np.float32)
    t = rng.uniform(0, 86400, (n, 2)).astype(np.float32)
    return dict(sid_hi=rng.integers(-e_sid, e_sid, n).astype(np.int32),
                sid_lo=rng.integers(-2**31, 2**31, n).astype(np.int32),
                lat0=lat.min(1), lat1=lat.max(1), lon0=lon.min(1),
                lon1=lon.max(1), t0=t.min(1), t1=t.max(1))


def _tmeta(m):
    return tp.ShardMeta(**{k: torch.from_numpy(v) for k, v in m.items()})


def _jmeta(m):
    return jp.ShardMeta(**{k: jnp.asarray(v) for k, v in m.items()})


@pytest.mark.parametrize("n,e", [(64, 8), (1000, 20), (4096, 80)])
def test_voronoi_matches_jax_and_oracle(n, e):
    rng = np.random.default_rng(e)
    sites = make_sites(e, CITY, seed=3)
    pts = _points(rng, n)
    clear = vref.top2_relative_gap(pts, sites) > 1e-6
    assert clear.mean() > 0.99          # the seeded data meets the precondition
    got = tv.voronoi_assign(torch.from_numpy(pts), torch.from_numpy(sites)).numpy()
    assert got.dtype == np.int32
    want = np.asarray(j_voronoi(jnp.asarray(pts), jnp.asarray(sites)))
    np.testing.assert_array_equal(got[clear], want[clear])
    np.testing.assert_array_equal(got[clear],
                                  vref.voronoi_assign_ref(pts, sites)[clear])


def test_voronoi_ties_go_to_lowest_index():
    sites = torch.tensor([[0.0, 1.0], [0.0, -1.0], [0.0, 1.0]])
    pts = torch.tensor([[0.0, 0.0], [0.0, 2.0]])
    np.testing.assert_array_equal(tv.voronoi_assign(pts, sites).numpy(), [0, 0])


def test_hash_spatial_keeps_shape_and_skips_launch_on_cpu():
    rng = np.random.default_rng(4)
    sites = torch.from_numpy(make_sites(12, CITY, seed=3))
    pts = torch.from_numpy(_points(rng, 60))
    before = vops.launches
    out = tv.hash_spatial(pts[:, 0].reshape(3, 4, 5), pts[:, 1].reshape(3, 4, 5),
                          sites)
    assert out.shape == (3, 4, 5) and out.dtype == torch.int32
    assert vops.launches == before
    np.testing.assert_array_equal(out.reshape(-1).numpy(),
                                  tv.voronoi_assign(pts, sites).numpy())


def test_successor_resolve_matches_jax():
    rng = np.random.default_rng(5)
    start = rng.integers(0, 16, 300).astype(np.int32)
    forbidden = rng.random((300, 16)) < 0.8
    forbidden[:5] = True                                # all forbidden -> -1
    got = tp.successor_resolve(torch.from_numpy(start), torch.from_numpy(forbidden))
    want = jp.successor_resolve(jnp.asarray(start), jnp.asarray(forbidden))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:5] == -1).all()


def test_successor_resolve_wraps():
    forbidden = torch.tensor([[False, True, True, True]])
    assert int(tp.successor_resolve(torch.tensor([2], dtype=torch.int32),
                                    forbidden)[0]) == 0


@pytest.mark.parametrize("n_domains", [1, 2])
@pytest.mark.parametrize("n_alive", [12, 5, 3, 2, 1, 0])
def test_place_replicas_matches_jax(n_alive, n_domains):
    e = 12
    rng = np.random.default_rng(n_alive * 10 + n_domains)
    sites = make_sites(e, CITY, seed=3)
    m = _meta(rng, 200)
    alive = np.zeros(e, bool)
    alive[rng.choice(e, n_alive, replace=False)] = True
    got = tp.place_replicas(_tmeta(m), torch.from_numpy(sites),
                            torch.from_numpy(alive), 300.0, n_domains=n_domains)
    want = jp.place_replicas(_jmeta(m), jnp.asarray(sites), jnp.asarray(alive),
                             300.0, n_domains=n_domains)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = got.numpy()
    for row in got:                       # the mass-failure contract
        real = [r for r in row if r >= 0]
        assert len(real) == min(3, n_alive) and len(set(real)) == len(real)
        assert all(alive[r] for r in real)


def test_parent_edge_matches_jax():
    rng = np.random.default_rng(6)
    sites = make_sites(12, CITY, seed=3)
    pts = _points(rng, 100)
    alive = np.ones(12, bool)
    alive[[0, 3, 7]] = False
    got = tp.parent_edge(torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]),
                         torch.from_numpy(sites), torch.from_numpy(alive))
    want = jp.parent_edge(jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
                          jnp.asarray(sites), jnp.asarray(alive))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_edge_domains_validation():
    np.testing.assert_array_equal(tp.edge_domains(6, 3).numpy(),
                                  [0, 0, 1, 1, 2, 2])
    for bad in (0, 4):
        with pytest.raises(ValueError, match="divide"):
            tp.edge_domains(6, bad)


def test_temporal_slices_match_jax():
    rng = np.random.default_rng(7)
    t0 = rng.uniform(-1000, 86400, 300).astype(np.float32)
    t1 = (t0 + rng.choice([0, 100, 1000, 4000, 6000], 300)).astype(np.float32)
    cfg = ts.SliceConfig()
    got_m, got_o = ts.temporal_slice_edges(torch.from_numpy(t0),
                                           torch.from_numpy(t1), 16, cfg)
    want_m, want_o = js.temporal_slice_edges(jnp.asarray(t0), jnp.asarray(t1),
                                             16, js.SliceConfig())
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    assert got_o.any() and not got_o.all()


def test_spatial_slices_match_jax():
    rng = np.random.default_rng(8)
    sites = make_sites(16, CITY, seed=3)
    lat0 = rng.uniform(CITY.lat_min, CITY.lat_max, 300).astype(np.float32)
    lon0 = rng.uniform(CITY.lon_min, CITY.lon_max, 300).astype(np.float32)
    ext = rng.choice([0.0, 0.004, 0.03, 0.2], (2, 300)).astype(np.float32)
    lat1, lon1 = lat0 + ext[0], lon0 + ext[1]
    got_m, got_o = ts.spatial_slice_edges(
        *(torch.from_numpy(x) for x in (lat0, lat1, lon0, lon1)),
        torch.from_numpy(sites), ts.SliceConfig())
    want_m, want_o = js.spatial_slice_edges(
        *(jnp.asarray(x) for x in (lat0, lat1, lon0, lon1)),
        jnp.asarray(sites), js.SliceConfig())
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_o.any() and not got_o.all()


def test_slices_match_jitted_jax_at_cell_and_bucket_boundaries():
    """Ranges starting and ending on exact slice boundaries (k x 0.01
    degrees, the city's edges among them, and k x 300 s), and on the floats
    beside them: the port's slices equal the reference's under ``jax.jit``,
    as its insert and query run them, where XLA multiplies by the float32
    reciprocal of the cell and bucket widths (a longitude of 77.45 floors
    one cell below its true quotient)."""
    sites = make_sites(16, CITY, seed=3)
    k = np.arange(1284, 7776)
    k = k[(k <= 1311) | (k >= 7744)]
    edge = (k * np.float32(0.01)).astype(np.float32)
    near = np.concatenate([edge, np.nextafter(edge, np.float32(0)),
                           np.nextafter(edge, np.float32(100))])
    lat = near[near < 20]
    lon = near[near > 20]
    n = min(lat.size, lon.size)
    lat0, lon0 = lat[:n], lon[:n]
    lat1, lon1 = lat0 + np.float32(0.02), lon0[::-1] + np.float32(0.0)
    lon0 = np.minimum(lon0, lon1)
    lon1 = np.maximum(lon0, lon1)
    got_m, got_o = ts.spatial_slice_edges(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (lat0, lat1, lon0, lon1)),
        torch.from_numpy(sites), ts.SliceConfig())
    want_m, want_o = jax.jit(js.spatial_slice_edges, static_argnums=5)(
        *(jnp.asarray(x) for x in (lat0, lat1, lon0, lon1)), jnp.asarray(sites),
        js.SliceConfig())
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    t = (np.arange(1, 60000) * np.float32(300)).astype(np.float32)
    t0 = np.concatenate([t, np.nextafter(t, np.float32(0)),
                         np.nextafter(t, np.float32(1e9))])
    t1 = (t0 + np.float32(1200)).astype(np.float32)
    got_m, got_o = ts.temporal_slice_edges(torch.from_numpy(t0),
                                           torch.from_numpy(t1), 16, ts.SliceConfig())
    want_m, want_o = jax.jit(js.temporal_slice_edges, static_argnums=(2, 3))(
        jnp.asarray(t0), jnp.asarray(t1), 16, js.SliceConfig())
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_overlapping_ranges_share_a_slice_edge():
    """The index-correctness invariant: ranges around a shared point slice
    onto intersecting edge sets (unless over budget)."""
    rng = np.random.default_rng(9)
    sites = torch.from_numpy(make_sites(16, CITY, seed=3))
    pt = rng.uniform([CITY.lat_min, CITY.lon_min, 0], [CITY.lat_max,
                                                       CITY.lon_max, 86400],
                     (200, 3))
    ext = rng.uniform(0, [0.05, 0.05, 2000], (4, 200, 3))
    f = lambda x: torch.from_numpy(x.astype(np.float32))
    s = [f(pt[:, i] - ext[0, :, i]) for i in range(3)], \
        [f(pt[:, i] + ext[1, :, i]) for i in range(3)]
    q = [f(pt[:, i] - ext[2, :, i]) for i in range(3)], \
        [f(pt[:, i] + ext[3, :, i]) for i in range(3)]
    cfg = ts.SliceConfig()
    sm, so = ts.spatial_slice_edges(s[0][0], s[1][0], s[0][1], s[1][1], sites, cfg)
    qm, qo = ts.spatial_slice_edges(q[0][0], q[1][0], q[0][1], q[1][1], sites, cfg)
    ok = ~(so | qo)
    assert ok.sum() > 50 and (sm & qm).any(-1)[ok].all()
    sm, so = ts.temporal_slice_edges(s[0][2], s[1][2], 16, cfg)
    qm, qo = ts.temporal_slice_edges(q[0][2], q[1][2], 16, cfg)
    ok = ~(so | qo)
    assert ok.sum() > 50 and (sm & qm).any(-1)[ok].all()
