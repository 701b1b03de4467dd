"""Public API of the port: the ``AerialDB`` session facade, the ``Query``
builder and the types they take and return (as ``repro.api``).

    from repro_torch.api import AerialDB, Query

    db = AerialDB.open(cfg)                       # on the card
    db.ingest_rounds(payloads, metas)
    res, info = db.query(Query().bbox(12.9, 13.0, 77.5, 77.6).time(0, 600)
                         .agg("mean", channel=2))

``repro_torch.ingest`` sits above this package and drives only the facade.
"""

from repro_torch.api.query import Query
from repro_torch.api.session import AerialDB
from repro_torch.core.datastore import (AGG_OPS, AggSpec, LatestResult,
                                        QueryInfo, QueryResult, StoreConfig,
                                        make_pred)
from repro_torch.core.index import QueryPred
from repro_torch.core.placement import ShardMeta

__all__ = ["AerialDB", "Query", "AggSpec", "AGG_OPS", "QueryPred",
           "QueryResult", "QueryInfo", "LatestResult", "ShardMeta",
           "StoreConfig", "make_pred"]
