"""The voronoi_assign kernel's packed inputs (``ops.packed_sites``), on the
CPU: the site rows are ``centred_sites``' own bits, made once per site set
and afresh after an in-place edit or for another tensor, held only weakly;
and each cell's list of sites holds the plain version's argmin for every
point the kernel's cell arithmetic puts in the cell, so the first minimum
over the list is the plain version's answer bit for bit. The kernel itself
is held to the plain version on the card in ``test_torch_kernels_cuda.py``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import voronoi
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.kernels.voronoi_assign import ops as vops

CITY = CityConfig()


def _rows_match_centred_sites(sites):
    packed, _ = vops.packed_sites(sites)
    c, s, snorm = voronoi.centred_sites(sites)
    e = sites.shape[0]
    assert packed.dtype == torch.float32
    assert torch.equal(packed[:e, :2], s) and torch.equal(packed[:e, 2], snorm)
    assert torch.equal(packed.view(torch.int32)[:e, 3], torch.arange(e, dtype=torch.int32))
    assert torch.equal(vops.grid(sites).centre, c)


@pytest.mark.parametrize("e", [1, 2, 80])
def test_packed_sites_hold_centred_sites_bitwise(e):
    sites = torch.from_numpy(make_sites(e, CITY, seed=3))
    _rows_match_centred_sites(sites)
    packed, cells = vops.packed_sites(sites)
    assert vops.packed_sites(sites)[0] is packed           # made once
    assert vops.packed_sites(sites)[1] is cells


def test_packed_sites_follow_an_in_place_edit_and_a_new_tensor():
    sites = torch.from_numpy(make_sites(80, CITY, seed=3))
    first = vops.packed_sites(sites)[0]
    sites[5] += 0.01                                        # _version moves
    assert vops.packed_sites(sites)[0] is not first
    _rows_match_centred_sites(sites)
    sites[:, 1].mul_(1.0001)                                # an edit through a view
    _rows_match_centred_sites(sites)
    other = sites.clone()
    assert vops.packed_sites(other)[0] is not vops.packed_sites(sites)[0]
    _rows_match_centred_sites(other)


def test_packed_sites_keep_no_dropped_tensor_alive():
    sites = torch.from_numpy(make_sites(12, CITY, seed=4))
    vops.packed_sites(sites)
    key, ref = id(sites), weakref.ref(sites)
    assert key in vops._PACKED
    del sites
    gc.collect()
    assert ref() is None and key not in vops._PACKED


@pytest.mark.parametrize("bad", [float("nan"), 1e30])
def test_sites_that_may_overflow_get_no_grid(bad):
    sites = torch.from_numpy(make_sites(8, CITY, seed=3))
    sites[3, 0] = bad
    packed, cells = vops.packed_sites(sites)
    assert packed.shape == (8 + 2, 4) and cells.shape == (1,)
    g = vops.grid(sites)
    assert (g.across, g.down, g.lists.shape[0]) == (0, 0, 0)


def _kernel_rule(lat, lon, sites):
    """The kernel's answer for each point, from the packed inputs, in the
    kernel's float32 arithmetic: a point whose cell indices fall inside the
    grid takes the first minimum over its cell's list; any other point
    visits every site (the plain rule). Also returns which points were
    inside."""
    g = vops.grid(sites)
    px, py, inside, cell = vops.locate(lat, lon, sites)
    start, end = g.cells[cell].long(), g.cells[cell + inside.long()].long()
    width = int((g.cells[1:] - g.cells[:-1]).max()) if g.cells.numel() > 1 else 1
    slot = start[:, None] + torch.arange(width)
    rows = g.lists[slot.clamp(max=g.lists.shape[0] - 1)]
    cross = px[:, None] * rows[..., 0] + py[:, None] * rows[..., 1]
    d = torch.where(slot < end[:, None], rows[..., 2] - 2.0 * cross,
                    torch.tensor(float("inf")))
    pick = torch.argmin(d, 1)
    got = rows.view(torch.int32)[torch.arange(len(pick)), pick, 3]
    plain = voronoi.voronoi_assign(torch.stack([lat, lon], -1), sites)
    return torch.where(inside, got, plain), plain, inside


def _slice_grid(shards=200):
    _, metas = DroneFleet(shards, CITY, records_per_shard=60, n_values=4,
                          seed=1).next_rounds(1)
    i0 = torch.floor(torch.from_numpy(metas.lat0[0]) / 0.01)
    j0 = torch.floor(torch.from_numpy(metas.lon0[0]) / 0.01)
    k = torch.arange(16, dtype=torch.float32)
    lat = ((i0[:, None] + k + 0.5) * 0.01)[:, :, None].expand(-1, 16, 16)
    lon = ((j0[:, None] + k + 0.5) * 0.01)[:, None, :].expand(-1, 16, 16)
    return lat.reshape(-1), lon.reshape(-1)


def _hard_points(sites, rng, n=20_000):
    """Points on cell boundaries (as the kernel computes them), at the
    midpoints of site pairs (on Voronoi edges), on the sites, and uniform
    over the grid and beyond it."""
    g = vops.grid(sites)
    c, corner, inv, side = g.centre, g.corner, g.inv, max(g.across, 1)
    e = sites.shape[0]
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    k = f32(rng.integers(0, side + 1, (n, 2)))
    edge = corner + k / inv + c                               # cell boundaries
    i, j = rng.integers(0, e, n), rng.integers(0, e, n)
    mid = 0.5 * (sites[i] + sites[j]) + f32(rng.normal(0, 1e-6, (n, 2)))
    span = f32(side / inv)
    uni = corner + c + f32(rng.uniform(-0.2, 1.2, (n, 2))) * span
    pts = torch.cat([edge, mid, sites.clone(), uni])
    return pts[:, 0].contiguous(), pts[:, 1].contiguous()


@pytest.mark.parametrize("e,dup", [(1, False), (2, False), (3, True),
                                   (80, False), (80, True)])
def test_cell_lists_hold_the_argmin(e, dup):
    rng = np.random.default_rng(e + dup)
    sites = torch.from_numpy(make_sites(e, CITY, seed=3))
    if dup:
        sites[-1] = sites[0]                 # a duplicate: the lower index wins
    lat, lon = _hard_points(sites, rng)
    if e == 80:
        glat, glon = _slice_grid()
        lat, lon = torch.cat([lat, glat]), torch.cat([lon, glon])
    got, plain, inside = _kernel_rule(lat, lon, sites)
    assert inside.float().mean() > 0.5
    assert torch.equal(got, plain)


def test_cell_lists_are_short_on_the_d400_slice_grid():
    """The design's premise: the 80-site D400 deployment's slice grid visits
    a few sites a point, not 80."""
    sites = torch.from_numpy(make_sites(80, CITY, seed=3))
    lat, lon = _slice_grid()
    visits = vops.listed_sites(lat.reshape(-1, 16), lon.reshape(-1, 16), sites)
    assert visits.shape == (lat.numel() // 16, 16) and visits.dtype == torch.int32
    assert visits.float().mean() < 3 and int(visits.max()) <= 12
    nan = vops.listed_sites(torch.tensor([float("nan"), 1e30]),
                            torch.tensor([77.6, 77.6]), sites)
    assert nan.tolist() == [80, 80]
