"""The write-ahead journal of ``repro_torch.ingest`` held against the JAX
package's: the port of ``tests/test_journal.py``, case by case, on the
port's journal and pipeline (over a CPU session), plus two cross-package
cases: both packages' pipelines write byte-identical journals for one
stream, and each package replays the other's file into the same store.

Nothing is left for federation: every reference case runs on one device.
"""

import numpy as np
import pytest

from repro.api import AerialDB as JaxDB
from repro.core import datastore as jds
from repro.ingest import IngestPipeline as JaxPipeline
from repro.ingest import WriteAheadJournal as JaxJournal
from repro_torch.api import AerialDB
from repro_torch.core import datastore as tds
from repro_torch.data.synthetic import CityConfig, make_sites
from repro_torch.ingest import IngestPipeline, WriteAheadJournal
from test_torch_repair import _assert_states_identical

E = 8
WIDTH = 7      # t, lat, lon + 4 value channels
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
CFG_KW = dict(n_edges=E, sites=SITES, tuple_capacity=2048, index_capacity=512,
              max_shards_per_query=64, records_per_shard=8,
              retention_every=1 << 20, n_failure_domains=4)


def _open():
    return AerialDB.open(tds.StoreConfig(**CFG_KW), seed=0, device="cpu")


def _open_jax():
    return JaxDB.open(jds.StoreConfig(**CFG_KW), seed=0)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, WIDTH)).astype(np.float32)
    rows[:, 0] = np.arange(n, dtype=np.float32)          # finite t
    return rows


# ---------------------------------------------------------------------------
# the raw file format
# ---------------------------------------------------------------------------


def test_journal_roundtrip_bit_exact(tmp_path):
    """Append/replay round-trips ids and float32 rows bit for bit, NaN
    payload channels included."""
    path = tmp_path / "wal.bin"
    rows = _rows(50, seed=1)
    rows[7, 4] = np.nan
    rows[12, 3:] = np.nan
    drone = np.arange(50, dtype=np.int64) % 5
    seq = np.arange(50, dtype=np.int64)
    with WriteAheadJournal(path, WIDTH) as j:
        assert j.append(drone[:30], seq[:30], rows[:30]) == 30
        assert j.append(drone[30:], seq[30:], rows[30:]) == 20
        assert j.n_records == 50
    with WriteAheadJournal(path, WIDTH) as j:
        d, s, r, info = j.replay()
    assert info["records"] == 50 and info["torn_bytes"] == 0
    np.testing.assert_array_equal(d, drone)
    np.testing.assert_array_equal(s, seq)
    np.testing.assert_array_equal(r.view(np.int32), rows.view(np.int32))


def test_journal_truncates_torn_tail(tmp_path):
    """A partial trailing record is reported and truncated on reopen; every
    whole record stays byte-identical and appends stay frame-aligned."""
    path = tmp_path / "wal.bin"
    rows = _rows(10)
    with WriteAheadJournal(path, WIDTH) as j:
        j.append(np.arange(10, dtype=np.int64),
                 np.arange(10, dtype=np.int64), rows)
        rec_size = j.itemsize
    full = path.read_bytes()
    path.write_bytes(full[:len(full) - rec_size + rec_size // 2])
    with WriteAheadJournal(path, WIDTH) as j:
        assert j.n_records == 9
        d, s, r, info = j.replay()
    assert d.shape[0] == 9
    assert info["torn_bytes"] == 0
    np.testing.assert_array_equal(r.view(np.int32), rows[:9].view(np.int32))
    with WriteAheadJournal(path, WIDTH) as j:
        j.append(np.array([99]), np.array([0]), _rows(1))
        assert j.n_records == 10


def test_journal_width_mismatch_raises(tmp_path):
    path = tmp_path / "wal.bin"
    with WriteAheadJournal(path, WIDTH) as j:
        j.append(np.array([1]), np.array([0]), _rows(1))
    with pytest.raises(ValueError, match="width"):
        WriteAheadJournal(path, WIDTH + 2)


def test_journal_rejects_foreign_file(tmp_path):
    path = tmp_path / "not_a_wal.bin"
    path.write_bytes(b"definitely not a journal header" * 4)
    with pytest.raises(ValueError, match="magic"):
        WriteAheadJournal(path, WIDTH)


def test_journal_fresh_and_empty_files(tmp_path):
    for name in ("fresh.bin", "empty.bin"):
        with WriteAheadJournal(tmp_path / name, WIDTH) as j:
            d, s, r, info = j.replay()
        assert d.size == s.size == 0 and r.shape == (0, WIDTH)
        assert info["records"] == 0


# ---------------------------------------------------------------------------
# the pipeline journals exactly the accepted set; replay is idempotent
# ---------------------------------------------------------------------------


def _accepted_set_stream(pipe):
    """The reference test's submissions: 30 records, 5 re-sends, a NaN t,
    and a batch that overflows ``max_pending=40``."""
    n = 30
    drone = np.zeros(n, np.int64)
    seq = np.arange(n, dtype=np.int64)
    rows = _rows(n)
    pipe.submit_arrays(drone, seq, rows[:, 0], rows[:, 1], rows[:, 2],
                       rows[:, 3:])
    dup = pipe.submit_arrays(drone[:5], seq[:5], rows[:5, 0], rows[:5, 1],
                             rows[:5, 2], rows[:5, 3:])
    assert dup["duplicate"] == 5
    pipe.submit_arrays(np.array([3]), np.array([0]), np.array([np.nan]),
                       np.array([1.0]), np.array([2.0]))
    big = 30
    pipe.submit_arrays(np.full(big, 1, np.int64),
                       np.arange(big, dtype=np.int64),
                       np.arange(big, dtype=np.float64),
                       np.zeros(big), np.zeros(big))


def test_pipeline_journals_exactly_the_accepted_set(tmp_path):
    """Duplicates, malformed records and backpressure drops never reach
    the journal."""
    pipe = IngestPipeline(_open(), max_pending=40, journal=tmp_path / "wal.bin")
    _accepted_set_stream(pipe)
    c = pipe.counters
    assert c["dropped_malformed"] == 1 and c["dropped_backpressure"] > 0
    assert pipe.journal.n_records == c["accepted"]
    d, s, r, _ = pipe.journal.replay()
    assert len(set(zip(d.tolist(), s.tolist()))) == c["accepted"]
    pipe.close()


def test_journal_replay_is_idempotent(tmp_path):
    """Replay into a fresh pipeline recovers every accepted record once; a
    second replay accepts nothing and writes nothing."""
    path = tmp_path / "wal.bin"
    pipe = IngestPipeline(_open(), journal=path)
    n = 64
    rows = _rows(n, seed=4)
    pipe.submit_arrays(np.arange(n, dtype=np.int64) % 4,
                       np.arange(n, dtype=np.int64) // 4,
                       rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:])
    pipe.flush(drain=True)
    assert pipe.counters["accepted"] == n
    pipe.close()

    pipe2 = IngestPipeline(_open(), journal=path)
    rep = pipe2.replay_journal()
    assert rep == {"journal_records": n, "torn_bytes": 0,
                   "accepted": n, "already_seen": 0}
    assert pipe2.counters["replayed"] == n
    assert pipe2.journal.n_records == n
    again = pipe2.replay_journal()
    assert again["accepted"] == 0 and again["already_seen"] == n
    pipe2.flush(drain=True)
    rec = pipe2.reconcile()
    assert rec["ok"], rec
    assert rec["flushed_records"] == n
    _assert_states_identical(pipe2.db.state, pipe.db.state)
    pipe2.close()


# ---------------------------------------------------------------------------
# across packages: one file format
# ---------------------------------------------------------------------------


def _mixed_stream(seed=9):
    """Ragged records of 6 drones with re-sends, gaps and NaN channels."""
    rng = np.random.default_rng(seed)
    n = 120
    drone = rng.integers(0, 6, n).astype(np.int64)
    seq = rng.integers(0, 40, n).astype(np.int64)
    rows = _rows(n, seed)
    rows[:, 1] = rng.uniform(12.85, 13.1, n)
    rows[:, 2] = rng.uniform(77.45, 77.75, n)
    rows[rng.random(n) < 0.2, 5:] = np.nan
    return drone, seq, rows


def test_journal_files_byte_identical_across_packages(tmp_path):
    """One stream (in three bursts, with a backpressure bound) through the
    port's pipeline and the reference's writes the same bytes."""
    drone, seq, rows = _mixed_stream()
    paths = {k: tmp_path / f"{k}.bin" for k in ("port", "jax")}
    pipes = {"port": IngestPipeline(_open(), max_pending=90,
                                    journal=paths["port"]),
             "jax": JaxPipeline(_open_jax(), max_pending=90,
                                journal=paths["jax"])}
    for pipe in pipes.values():
        for part in np.array_split(np.arange(drone.size), 3):
            pipe.submit_arrays(drone[part], seq[part], rows[part, 0],
                               rows[part, 1], rows[part, 2], rows[part, 3:])
        pipe.close()
    assert pipes["port"].counters == pipes["jax"].counters
    assert pipes["port"].counters["accepted"] > 0
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_replays_the_others_journal(tmp_path, writer):
    """A journal written by one package replays in the other: the same
    records, and the two replaying pipelines' stores bitwise equal."""
    drone, seq, rows = _mixed_stream(11)
    path = tmp_path / "wal.bin"
    make = IngestPipeline if writer == "port" else JaxPipeline
    src = make(_open() if writer == "port" else _open_jax(), journal=path)
    src.submit_arrays(drone, seq, rows[:, 0], rows[:, 1], rows[:, 2],
                      rows[:, 3:])
    accepted = src.counters["accepted"]
    src.close()
    with WriteAheadJournal(path, WIDTH) as tj, JaxJournal(path, WIDTH) as jj:
        got, want = tj.replay(), jj.replay()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.ascontiguousarray(g).view(np.uint8),
                                      np.ascontiguousarray(w).view(np.uint8))
    port, ref = IngestPipeline(_open(), journal=path), JaxPipeline(
        _open_jax(), journal=path)
    for pipe in (port, ref):
        rep = pipe.replay_journal()
        assert rep["accepted"] == accepted and rep["torn_bytes"] == 0
        pipe.flush(drain=True)
        assert pipe.reconcile()["ok"]
        pipe.close()
    assert port.counters == ref.counters
    _assert_states_identical(port.db.state, ref.db.state)
