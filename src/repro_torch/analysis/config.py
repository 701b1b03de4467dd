"""aeriallint configuration of the port: ``analysis/aeriallint.toml``.

Port of ``repro.analysis.config``. The rules' data lives in one TOML file
beside this module, read with the standard library's ``tomllib``: the scan
roots, the hot functions, the allowlist (every entry with its reason), the
sync and launch budgets of the canonical workload and the collective
contract, so that a change of contract is a reviewable change of data.
Schema:

    roots = ["src/repro_torch", "chip_smoke.py"]     # files or directories
    hot_functions = ["src/repro_torch/core/datastore.py::insert_body", ...]

    [[allow]]
    rule = "R3"                               # the rule the entry silences
    path = "src/repro_torch/kernels/build.py" # fnmatch glob, repo-relative
    match = "time.perf_counter"               # optional substring
    reason = "why this is intentional"        # REQUIRED: reasonless = R0

    [retrace.budgets.cpu.single.insert]       # device, leg, entry point
    syncs = 0
    [retrace.budgets.cuda.single.insert]
    syncs = 0
    launches = {hash64 = 6, voronoi_assign = 4}
    [retrace.budgets.cuda.single.insert.fills]   # once a process
    syncs = 3

    [collectives]
    insert = ["watermark"]
    query = ["merge1", "merge2", "combine"]
    capacities = [384, 1024]
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Optional, Tuple

#: The configuration file, beside this module.
CONFIG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "aeriallint.toml")


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    """One allowlist row: silences ``rule`` findings in files matching the
    ``path`` glob (narrowed by a ``match`` substring of the finding's message
    or source line, where given). ``reason`` is mandatory policy."""
    rule: str
    path: str
    reason: str = ""
    match: str = ""


@dataclasses.dataclass(frozen=True)
class AeriallintConfig:
    roots: Tuple[str, ...] = ("src/repro_torch", "chip_smoke.py")
    hot_functions: Tuple[str, ...] = ()
    allow: Tuple[AllowEntry, ...] = ()
    # Layer 2: the canonical workload's budgets, as nested dicts
    # {device: {leg: {entry: {"syncs": n, "launches": {...}, "fills": {...}}}}}.
    retrace_budgets: dict = dataclasses.field(default_factory=dict,
                                              hash=False, compare=False)
    # Layer 3: the kinds each operation may move across blocks, and the two
    # capacities whose traffic must be identical.
    insert_collectives: Tuple[str, ...] = ("watermark",)
    query_collectives: Tuple[str, ...] = ("merge1", "merge2", "combine")
    contract_capacities: Tuple[int, int] = (384, 1024)

    def budgets(self, device: str, leg: str) -> dict:
        """{entry: {"syncs", "launches", "fills"}} of one device and leg."""
        return self.retrace_budgets.get(device, {}).get(leg, {})


def find_repo_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: this file) to the directory holding
    pyproject.toml: every path the linter reports is relative to it."""
    d = os.path.abspath(start or os.path.dirname(__file__))
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise FileNotFoundError(
                f"no pyproject.toml above {start or os.path.dirname(__file__)}"
                ": aeriallint reports paths relative to the repository root.")
        d = parent


def load_config(path: Optional[str] = None) -> AeriallintConfig:
    """Read the port's aeriallint TOML (``CONFIG_PATH`` by default). A
    missing key falls back to the default."""
    with open(path or CONFIG_PATH, "rb") as fh:
        tbl = tomllib.load(fh)
    allow = tuple(
        AllowEntry(rule=str(e.get("rule", "")), path=str(e.get("path", "")),
                   reason=str(e.get("reason", "")),
                   match=str(e.get("match", "")))
        for e in tbl.get("allow", ()))
    retr = tbl.get("retrace", {})
    coll = tbl.get("collectives", {})
    dflt = AeriallintConfig()
    return AeriallintConfig(
        roots=tuple(tbl.get("roots", dflt.roots)),
        hot_functions=tuple(tbl.get("hot_functions", ())),
        allow=allow,
        retrace_budgets=retr.get("budgets", {}),
        insert_collectives=tuple(coll.get("insert", dflt.insert_collectives)),
        query_collectives=tuple(coll.get("query", dflt.query_collectives)),
        contract_capacities=tuple(
            int(c) for c in coll.get("capacities", dflt.contract_capacities)),
    )
