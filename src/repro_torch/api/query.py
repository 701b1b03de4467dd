"""Composable query builder: fluent clauses -> ``(QueryPred, AggSpec)``.

Port of ``repro.api.query``: the same clauses, combinators and eager
validation. ``build`` and ``batch`` take a ``device`` (default ``"cuda"``)
for the predicate tensors; validation runs on the host first.

The engine (``core.datastore.query_local`` + the st_scan engines) evaluates a
*batch* of predicates, each a single AND or OR over at most one spatial bbox,
one temporal range, and one shard-id clause (paper Fig 6, §3.5.1). ``Query``
is the ergonomic, *validating* front door to that shape:

    Query().bbox(12.9, 13.0, 77.5, 77.6).time(0, 600).agg("mean", channel=2)
    Query().time(0, 600).agg("mean", channels=(0, 2))   # K channels, ONE scan
    Query().bbox(...) | Query().time(...)          # OR combinator
    Query().shard(3, 1) & Query().time(0, 300)     # AND combinator
    Query.batch(q1, q2, q3)                        # one batched QueryPred

Builders are immutable — every method returns a new ``Query`` — so partial
queries can be shared and extended without aliasing. ``build()`` compiles to
the engine's ``QueryPred`` (q=1) plus the static ``AggSpec``; ``Query.batch``
stacks several built queries into one (Q,) predicate batch (they must share
one AggSpec, which is compiled into the scan).

Validation happens eagerly, at build time, with concrete Python scalars:
inverted ranges (``lat1 < lat0``, ``t1 < t0``) raise immediately instead of
silently matching nothing, and clause combinations the engine cannot express
((A AND B) OR C) are rejected with an explanation rather than mis-compiled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.datastore import AGG_OPS, AggSpec, make_pred
from repro_torch.core.index import QueryPred

__all__ = ["Query"]

_CLAUSES = ("spatial", "temporal", "sid")


def _scalar(name: str, x) -> float:
    try:
        return float(x)
    except (TypeError, ValueError):
        raise TypeError(
            f"{name}={x!r} is not a scalar: the Query builder takes concrete "
            "per-query bounds (batch many queries with Query.batch, or build "
            "array workloads directly with core.datastore.make_pred).")


@dataclasses.dataclass(frozen=True)
class Query:
    """One spatio-temporal/id range-aggregation query, under construction.

    Fields hold the clauses added so far; ``mode`` is fixed to "and"/"or" by
    chaining a second clause (AND) or by the ``&``/``|`` combinators.
    """
    spatial: Optional[Tuple[float, float, float, float]] = None
    temporal: Optional[Tuple[float, float]] = None
    sid: Optional[Tuple[int, int]] = None
    mode: Optional[str] = None          # "and" | "or"; None until fixed
    spec: Optional[AggSpec] = None      # None -> AggSpec() at build time
    want_latest: bool = False           # latest-per-drone hot-cache read

    # -- clauses ------------------------------------------------------------

    def _n_clauses(self) -> int:
        return sum(getattr(self, c) is not None for c in _CLAUSES)

    def _no_latest(self, what: str) -> None:
        if self.want_latest:
            raise ValueError(
                f"cannot add {what} to a latest() query: the latest-per-drone "
                "read is a whole-cache O(drones) fast path with no predicate "
                "or aggregation — filter the returned (D, 3+V) records on the "
                "host, or issue a separate range query.")

    def _with_clause(self, kind: str, value) -> "Query":
        self._no_latest(f"a {kind} clause")
        if getattr(self, kind) is not None:
            raise ValueError(
                f"query already has a {kind} clause: the engine evaluates at "
                f"most one spatial, one temporal, and one shard-id clause per "
                "predicate — issue two queries (Query.batch) to cover "
                "disjoint ranges.")
        mode = self.mode
        if mode is None and self._n_clauses() >= 1:
            mode = "and"                # chaining clauses means AND
        return dataclasses.replace(self, **{kind: value, "mode": mode})

    def bbox(self, lat0, lat1, lon0, lon1) -> "Query":
        """Spatial clause: inclusive [lat0, lat1] x [lon0, lon1] box."""
        lat0, lat1 = _scalar("lat0", lat0), _scalar("lat1", lat1)
        lon0, lon1 = _scalar("lon0", lon0), _scalar("lon1", lon1)
        if lat0 > lat1:
            raise ValueError(
                f"inverted latitude range: lat0={lat0} > lat1={lat1}. "
                "Inverted ranges match nothing; pass bbox(lat_min, lat_max, "
                "lon_min, lon_max) with lat_min <= lat_max.")
        if lon0 > lon1:
            raise ValueError(
                f"inverted longitude range: lon0={lon0} > lon1={lon1}. "
                "Inverted ranges match nothing; pass bbox(lat_min, lat_max, "
                "lon_min, lon_max) with lon_min <= lon_max.")
        return self._with_clause("spatial", (lat0, lat1, lon0, lon1))

    def time(self, t0, t1) -> "Query":
        """Temporal clause: inclusive [t0, t1] window."""
        t0, t1 = _scalar("t0", t0), _scalar("t1", t1)
        if t0 > t1:
            raise ValueError(
                f"inverted time range: t0={t0} > t1={t1}. Inverted ranges "
                "match nothing; pass time(t_start, t_end) with "
                "t_start <= t_end.")
        return self._with_clause("temporal", (t0, t1))

    def shard(self, sid_hi, sid_lo) -> "Query":
        """Shard-id point clause (drone id, collection round)."""
        return self._with_clause(
            "sid", (int(sid_hi), int(sid_lo)))

    def latest(self) -> "Query":
        """Latest-per-drone hot-cache read (paper §4.4 near-real-time path):
        ``AerialDB.query(Query().latest())`` returns the O(drones)
        ``LatestResult`` — last (max-t) record + last-seen step per drone —
        straight from the replicated cache, bypassing the log scan, the
        index, and the planner entirely. Terminal: takes no clauses and no
        aggregation (requires ``StoreConfig.max_drones > 0``)."""
        if self._n_clauses() or self.spec is not None:
            raise ValueError(
                "latest() is a whole-cache read and cannot be combined with "
                "clauses or aggregation: the hot path answers 'newest record "
                "per drone' only — filter the returned records on the host, "
                "or issue a separate range query for historical windows.")
        return dataclasses.replace(self, want_latest=True)

    # -- aggregation --------------------------------------------------------

    def agg(self, *ops: str, channel: Optional[int] = None,
            channels: Optional[Tuple[int, ...]] = None) -> "Query":
        """Request aggregates of one or more sensor channels: any of
        {"count", "sum", "min", "max", "mean"}. Pass ``channel=`` for the
        single-channel case or ``channels=`` for a static tuple aggregated
        in the SAME single scan (multi-channel results are (Q, K)-shaped,
        one column per channel). Calls accumulate ops, but the channel set
        is fixed once chosen — it is compiled into the scan."""
        self._no_latest("aggregation")
        if channel is not None and channels is not None:
            raise ValueError(
                "pass channel= (single) OR channels= (batched), not both.")
        if isinstance(channels, int):     # bare int normalizes like AggSpec
            channels = (channels,)
        new_channels = (tuple(channels) if channels is not None
                        else (channel,) if channel is not None else None)
        if (self.spec is not None and new_channels is not None
                and self.spec.channels != new_channels):
            raise ValueError(
                f"query already aggregates channels {self.spec.channels}; "
                f"the channel set is fixed per query (got {new_channels}). "
                "Request every channel in one .agg(channels=...) call, or "
                "issue a second query.")
        if new_channels is None:
            new_channels = self.spec.channels if self.spec is not None else (0,)
        prev = self.spec.ops if self.spec is not None else ()
        merged = prev + tuple(op for op in ops if op not in prev)
        return dataclasses.replace(
            self, spec=AggSpec(channels=new_channels, ops=merged or AGG_OPS))

    # -- combinators --------------------------------------------------------

    def _combine(self, other: "Query", mode: str) -> "Query":
        if not isinstance(other, Query):
            return NotImplemented
        sym = "&" if mode == "and" else "|"
        for side in (self, other):
            side._no_latest(f"the {sym} combinator")
        for side in (self, other):
            if side.mode is not None and side.mode != mode \
                    and side._n_clauses() >= 2:
                raise ValueError(
                    f"cannot {sym}-combine a query already fixed to "
                    f"{side.mode.upper()}: each predicate is a single AND or "
                    "OR over its clauses — (A AND B) OR C is not expressible "
                    "in one predicate. Run the two sides as separate batched "
                    "queries and combine the results.")
        merged = {}
        for kind in _CLAUSES:
            a, b = getattr(self, kind), getattr(other, kind)
            if a is not None and b is not None and a != b:
                raise ValueError(
                    f"both sides of {sym} carry a {kind} clause: the engine "
                    f"evaluates at most one {kind} clause per predicate — "
                    "issue two batched queries to cover both ranges.")
            merged[kind] = a if a is not None else b
        if self.spec is not None and other.spec is not None \
                and self.spec != other.spec:
            raise ValueError(
                "both sides carry a different AggSpec: the aggregation spec "
                "is static (compiled into the scan); set it once, on the "
                "combined query.")
        return Query(mode=mode, spec=self.spec or other.spec, **merged)

    def __and__(self, other: "Query") -> "Query":
        """AND-combine: tuples must satisfy every clause."""
        return self._combine(other, "and")

    def __or__(self, other: "Query") -> "Query":
        """OR-combine: tuples may satisfy any clause."""
        return self._combine(other, "or")

    @staticmethod
    def all_of(*queries: "Query") -> "Query":
        out = queries[0]
        for q in queries[1:]:
            out = out & q
        return out

    @staticmethod
    def any_of(*queries: "Query") -> "Query":
        out = queries[0]
        for q in queries[1:]:
            out = out | q
        return out

    # -- compilation --------------------------------------------------------

    def build(self, device="cuda") -> Tuple[QueryPred, AggSpec]:
        """Compile to the engine's ``(QueryPred, AggSpec)`` (q=1)."""
        if self.want_latest:
            raise ValueError(
                "a latest() query does not compile to a QueryPred: it never "
                "touches the scan engine. Run it through AerialDB.query(...) "
                "(or AerialDB.latest() directly) to read the hot cache.")
        if self._n_clauses() == 0:
            raise ValueError(
                "empty query: add at least one clause (bbox / time / shard). "
                "For a catch-all scan use .time(0, big) or the broadcast "
                "baseline config.")
        lat0, lat1, lon0, lon1 = self.spatial or (0.0, 0.0, 0.0, 0.0)
        t0, t1 = self.temporal or (0.0, 0.0)
        sid_hi, sid_lo = self.sid or (-1, -1)
        pred = make_pred(
            q=1, lat0=lat0, lat1=lat1, lon0=lon0, lon1=lon1, t0=t0, t1=t1,
            sid_hi=sid_hi, sid_lo=sid_lo,
            has_spatial=self.spatial is not None,
            has_temporal=self.temporal is not None,
            has_sid=self.sid is not None,
            is_and=self.mode != "or", device=device)
        return pred, self.spec if self.spec is not None else AggSpec()

    @staticmethod
    def batch(*queries: "Query", device="cuda") -> Tuple[QueryPred, AggSpec]:
        """Stack several built queries into one batched (Q,) QueryPred.

        All queries must resolve to the same ``AggSpec`` — the spec is static
        (one compiled scan serves the whole batch); split differing specs
        into separate ``AerialDB.query`` calls.
        """
        if not queries:
            raise ValueError("Query.batch needs at least one query.")
        built = [q.build(device) for q in queries]
        specs = {spec for _, spec in built}
        if len(specs) > 1:
            raise ValueError(
                f"queries in a batch must share one AggSpec, got {specs}: "
                "the spec is compiled into the scan; run differing specs as "
                "separate AerialDB.query calls.")
        preds = [p for p, _ in built]
        pred = QueryPred(*(torch.cat([getattr(p, f) for p in preds])
                           for f in QueryPred._fields))
        return pred, built[0][1]
