"""aeriallint of the port (``repro_torch.analysis``), on the CPU: the
counterpart of ``tests/test_analysis.py``, class for class.

Layer 1 (AST rules): a positive and a negative fixture for each of R0-R6,
the pragma and allowlist policy, the port's code lint-clean, the JSON CLI,
and on shared fixtures the port's R0, R2, R3 (numpy and stdlib RNG) and R6
findings held to the reference linter's (rule, line) findings.
Layer 2 (sync, launch and build budget): the canonical workload meets its
exact CPU budgets cold and warm on the single store and the (4,) and (2, 2)
meshes; the counters catch a planted ``.item()`` and a weak config hash;
the workload leaves a state and answers bitwise equal to the JAX package
driven through the same steps on the same three legs (vsum / vmean to rtol
1e-5).
Layer 3 (collective contract): what crosses blocks on both meshes has its
contracted kinds and counts, does not move with ``tuple_capacity``, and
ingest keeps every leaf in place; a hook that gathers the log and a
``clone_state`` inside ingest are both refused.

The counts on the card and the builds are ``-k analysis`` in
``tests/test_torch_kernels_cuda.py``.
"""

import ast
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.analysis import lint as jlint
from repro.analysis import retrace as jretrace
from repro.analysis.config import AeriallintConfig as JConfig
from repro.api import AerialDB as JaxDB
from repro.api import AggSpec as JAggSpec
from repro.api import Query as JQuery
from repro.data.synthetic import DroneFleet as JFleet
from repro.launch.mesh import make_edge_mesh as j_make_edge_mesh
from repro.launch.mesh import make_fleet_mesh as j_make_fleet_mesh
from repro_torch.analysis import collective_contract as cc
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis import retrace
from repro_torch.analysis.config import (CONFIG_PATH, AeriallintConfig,
                                         AllowEntry, find_repo_root,
                                         load_config)
from repro_torch.analysis.lint import config_policy_findings, run_lint
from repro_torch.analysis.rules import lint_source
from repro_torch.api import AerialDB, StoreConfig
from repro_torch.core.datastore import clone_state
from repro_torch.distributed import federation as fed
from repro_torch.kernels import build
from test_torch_repair import (_assert_query_equal, _assert_states_identical,
                               bucketed_reference_placement)  # noqa: F401

HOT = AeriallintConfig(hot_functions=(
    "src/repro_torch/core/datastore.py::insert_body",))
DS = "src/repro_torch/core/datastore.py"


def _rules(src, path, cfg=None, status="open"):
    return [f.rule for f in lint_source(src, path, cfg) if f.status == status]


# ---------------------------------------------------------------------------
# Layer 1: rule fixtures
# ---------------------------------------------------------------------------

class TestR1Layering:
    def test_runtime_importing_facade_flagged(self):
        src = "from repro_torch.api import AerialDB\nAerialDB\n"
        assert "R1" in _rules(src, DS)
        assert "R1" in _rules(src.replace("repro_torch.api", "repro_torch.chaos"),
                              "src/repro_torch/distributed/federation.py")
        assert "R1" in _rules("import repro_torch.ingest.pipeline\n",
                              "src/repro_torch/kernels/st_scan/ops.py")

    def test_facade_importing_runtime_ok(self):
        src = "from repro_torch.core.datastore import StoreConfig\nStoreConfig\n"
        assert _rules(src, "src/repro_torch/api/session.py") == []

    def test_ingest_reaching_runtime_flagged(self):
        src = "from repro_torch.core.index import QueryPred\nQueryPred\n"
        assert "R1" in _rules(src, "src/repro_torch/ingest/coalesce.py")

    def test_ingest_over_facade_ok(self):
        src = ("from repro_torch.api import ShardMeta\n"
               "from repro_torch.ingest.journal import WriteAheadJournal\n"
               "import numpy as np\nShardMeta, WriteAheadJournal, np\n")
        assert _rules(src, "src/repro_torch/ingest/pipeline.py") == []

    @pytest.mark.parametrize("src", [
        "import jax\njax\n", "import jax.numpy as jnp\njnp\n",
        "from jaxlib import xla_client\nxla_client\n",
        "from repro.core.datastore import StoreConfig\nStoreConfig\n",
        "import repro.api\nrepro\n"])
    @pytest.mark.parametrize("path", ["src/repro_torch/api/session.py",
                                      "chip_smoke.py"])
    def test_foreign_import_flagged(self, src, path):
        assert _rules(src, path) == ["R1"]

    def test_repro_torch_is_not_the_reference(self):
        src = "import repro_torch.api\nfrom repro_torch import convert\nrepro_torch, convert\n"
        assert _rules(src, "chip_smoke.py") == []

    def test_runtime_importing_analysis_flagged(self):
        src = "from repro_torch.analysis import retrace\nretrace\n"
        assert _rules(src, "src/repro_torch/api/session.py") == ["R1"]
        assert _rules(src, "src/repro_torch/analysis/collective_contract.py") == []
        assert _rules(src, "chip_smoke.py") == []


class TestR2Deprecation:
    SRC = ("from repro_torch.core.datastore import insert_step\n"
           "s, i = insert_step(cfg, state, p, m, alive)\n")

    def test_shim_import_and_call_flagged(self):
        assert _rules(self.SRC, "src/repro_torch/data/pipeline.py").count("R2") == 2

    def test_method_call_spelling_flagged(self):
        assert "R2" in _rules("import repro_torch.core.datastore as ds\n"
                              "ds.query_step(cfg)\n", "chip_smoke.py")

    def test_facade_calls_ok(self):
        assert _rules("db.insert(p, m)\ndb.query(q)\n", "chip_smoke.py") == []


class TestR3Determinism:
    def test_wall_clock_in_the_port_flagged(self):
        assert "R3" in _rules("import time\nt = time.time()\n",
                              "src/repro_torch/ingest/pipeline.py")
        assert "R3" in _rules("import time\ntime.sleep(1)\n",
                              "src/repro_torch/api/session.py")
        assert "R3" in _rules("import datetime\ndatetime.datetime.now()\n",
                              "src/repro_torch/core/repair.py")

    def test_wall_clock_in_the_smoke_script_ok(self):
        assert _rules("import time\nt = time.perf_counter()\n",
                      "chip_smoke.py") == []

    @pytest.mark.parametrize("call", [
        "torch.rand(3)", "torch.randn(2, 3)", "torch.randint(0, 5, (3,))",
        "torch.randperm(4)", "torch.normal(0.0, 1.0, (3,))",
        "torch.bernoulli(p)", "torch.multinomial(p, 2)"])
    def test_global_torch_draw_flagged(self, call):
        assert _rules(f"import torch\nx = {call}\n", "chip_smoke.py") == ["R3"]
        seeded = call[:-1] + ", generator=g)"
        assert _rules(f"import torch\nx = {seeded}\n", "chip_smoke.py") == []

    def test_aliased_torch_draw_flagged(self):
        assert _rules("import torch as T\nx = T.randn(3)\n",
                      "src/repro_torch/models/layers.py") == ["R3"]
        assert _rules("from torch import randn\nx = randn(3)\n",
                      "chip_smoke.py") == ["R3"]

    @pytest.mark.parametrize("method", ["uniform_", "normal_", "random_",
                                        "bernoulli_", "exponential_"])
    def test_inplace_draw_flagged(self, method):
        assert _rules(f"x.{method}()\n", "chip_smoke.py") == ["R3"]
        assert _rules(f"x.{method}(generator=g)\n", "chip_smoke.py") == []

    def test_global_seed_flagged(self):
        assert _rules("import torch\ntorch.manual_seed(0)\n",
                      "chip_smoke.py") == ["R3"]
        assert _rules("import torch\ntorch.cuda.manual_seed_all(0)\n",
                      "chip_smoke.py") == ["R3"]
        assert _rules("import torch\ng = torch.Generator().manual_seed(0)\n",
                      "chip_smoke.py") == []

    def test_unseeded_np_random_flagged(self):
        src = "import numpy as np\nx = np.random.rand(3)\n"
        assert "R3" in _rules(src, "chip_smoke.py")
        assert "R3" in _rules(src, "src/repro_torch/data/synthetic.py")

    def test_seeded_constructs_ok(self):
        src = ("import numpy as np\nrng = np.random.default_rng(0)\n"
               "ss = np.random.SeedSequence(7)\n")
        assert _rules(src, "src/repro_torch/chaos/plan.py") == []

    def test_bare_stdlib_random_flagged(self):
        assert "R3" in _rules("import random\nx = random.random()\n",
                              "chip_smoke.py")


class TestR4HostSync:
    @pytest.mark.parametrize("expr", [
        "x.sum().item()", "x.tolist()", "x.cpu()", "x.numpy()", 'x.to("cpu")',
        "np.asarray(x)", "np.array(x)", "torch.cuda.synchronize()",
        "x.nonzero()", "torch.nonzero(x)", "torch.unique(x)", "x.unique()",
        "x.masked_select(m)", "torch.masked_select(x, m)", "int(x[0])",
        "float(x.max())", "bool(x.any())"])
    def test_sync_in_hot_function_flagged(self, expr):
        src = (f"import numpy as np\nimport torch\nnp, torch\n"
               f"def insert_body(x, m):\n    return {expr}\n")
        assert _rules(src, DS, HOT) == ["R4"]

    def test_host_side_sync_ok(self):
        src = ("def telemetry(info):\n    return info['drops'].item()\n"
               "def insert_body(x):\n    return int(3), float(1.5)\n")
        assert _rules(src, DS, HOT) == []

    def test_hot_function_is_keyed_by_path(self):
        src = "def insert_body(x):\n    return x.item()\n"
        assert _rules(src, DS, HOT) == ["R4"]
        assert _rules(src, "src/repro_torch/core/index.py", HOT) == []

    def test_nested_def_flagged_once(self):
        src = ("def insert_body(x):\n    def inner():\n"
               "        return x.tolist()\n    return inner\n")
        assert _rules(src, DS, HOT) == ["R4"]

    def test_the_configured_hot_functions_exist(self):
        """Every hot function the TOML names is a def of its file, so the
        rule cannot go quiet by a rename."""
        root = find_repo_root()
        for spec in load_config().hot_functions:
            path, name = spec.split("::")
            with open(os.path.join(root, path)) as fh:
                tree = ast.parse(fh.read())
            assert name in {n.name for n in ast.walk(tree)
                            if isinstance(n, ast.FunctionDef)}, spec


class TestR5TensorBranch:
    @pytest.mark.parametrize("test", ["torch.any(x > 0)", "x.any()",
                                      "(x > 0).all()", "torch.equal(x, y)"])
    def test_branch_on_tensor_flagged(self, test):
        src = (f"import torch\ntorch\ndef insert_body(x, y):\n    if {test}:\n"
               "        return x\n    return y\n")
        assert _rules(src, DS, HOT) == ["R5"]

    def test_while_on_tensor_flagged(self):
        src = ("def insert_body(x):\n    while x.any():\n"
               "        x = x - 1\n    return x\n")
        assert _rules(src, DS, HOT) == ["R5"]

    def test_static_branch_ok(self):
        src = ("def insert_body(cfg, x, steps):\n"
               "    if steps % cfg.retention_every == 0 and cfg.max_drones:\n"
               "        return x\n    return -x\n")
        assert _rules(src, DS, HOT) == []


class TestR6DeadImports:
    def test_dead_import_flagged(self):
        assert "R6" in _rules("import numpy as np\nx = 1\n",
                              "src/repro_torch/models/model.py")

    def test_used_import_ok(self):
        assert _rules("import numpy as np\nx = np.zeros(1)\n",
                      "src/repro_torch/models/model.py") == []

    def test_future_and_all_exempt(self):
        src = ("from __future__ import annotations\n"
               "from repro_torch.models.attention import attention\n"
               "__all__ = ['attention']\n")
        assert _rules(src, "src/repro_torch/kernels/flash_attention/ref.py") == []

    def test_init_py_exempt(self):
        assert _rules("from repro_torch.api.session import AerialDB\n",
                      "src/repro_torch/api/__init__.py") == []


class TestR0AndSuppression:
    SRC = "import time\nt = time.time()  # aeriallint: disable=R3{suffix}\n"
    PATH = "src/repro_torch/launch/mesh.py"

    def test_reasoned_pragma_disables(self):
        out = lint_source(self.SRC.format(suffix=" -- timing telemetry only"),
                          self.PATH)
        assert [f.status for f in out if f.rule == "R3"] == ["disabled"]
        assert all(f.status != "open" for f in out)

    def test_reasonless_pragma_is_a_finding(self):
        out = lint_source(self.SRC.format(suffix=""), self.PATH)
        assert {f.rule for f in out if f.status == "open"} == {"R0", "R3"}

    def test_pragma_on_line_above(self):
        src = ("import time\n# aeriallint: disable=R3 -- measured, not stored\n"
               "t = time.time()\n")
        out = lint_source(src, self.PATH)
        assert [f.status for f in out if f.rule == "R3"] == ["disabled"]

    def test_pragma_for_another_rule_does_not_disable(self):
        src = "import time\nt = time.time()  # aeriallint: disable=R4 -- no\n"
        assert _rules(src, self.PATH) == ["R3"]

    def test_reasoned_allowlist_entry_applies(self):
        cfg = AeriallintConfig(allow=(AllowEntry(
            rule="R3", path="src/repro_torch/launch/*.py", match="time.time",
            reason="the smoke reports wall durations"),))
        out = lint_source("import time\nt = time.time()\n", self.PATH, cfg)
        assert [f.status for f in out if f.rule == "R3"] == ["allowlisted"]

    def test_allowlist_match_narrows(self):
        cfg = AeriallintConfig(allow=(AllowEntry(
            rule="R3", path="src/repro_torch/launch/*.py", match="time.sleep",
            reason="an injectable default"),))
        assert _rules("import time\nt = time.time()\n", self.PATH, cfg) == ["R3"]

    def test_reasonless_allowlist_entry_ignored_and_reported(self):
        cfg = AeriallintConfig(allow=(AllowEntry(
            rule="R3", path="src/repro_torch/launch/*.py", reason=""),))
        out = lint_source("import time\nt = time.time()\n", self.PATH, cfg)
        assert [f.status for f in out if f.rule == "R3"] == ["open"]
        assert [f.rule for f in config_policy_findings(cfg)] == ["R0"]
        assert config_policy_findings(AeriallintConfig(allow=(AllowEntry(
            rule="R3", path="x.py", reason="why"),))) == []

    def test_unparsable_file_is_a_finding(self):
        assert _rules("def (:\n", "chip_smoke.py") == ["R0"]


# Shared fixtures: the port's R0, R2, R3 (numpy and stdlib RNG) and R6 give
# the reference linter's findings, at a path both treat alike.
SHARED = {
    "dead_and_used": "import numpy as np\nimport os\nos.getcwd()\n",
    "numpy_rng": ("import numpy as np\na = np.random.rand(3)\n"
                  "b = np.random.default_rng(0).random(3)\n"
                  "c = np.random.normal(0, 1)\n"),
    "stdlib_rng": "import random\nx = random.random()\ny = random.choice([1])\n",
    "shims": ("from somewhere import insert_step\ninsert_step(1)\n"
              "db.query_step(q)\n"),
    "pragmas": ("import numpy as np  # aeriallint: disable=R6\n"
                "import os  # aeriallint: disable=R6 -- kept for callers\n"
                "x = 1\n"),
    "future_all": ("from __future__ import annotations\nfrom a import b, c\n"
                   "__all__ = ['b']\n"),
}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_rules_match_the_reference(name):
    path = "benchmarks/fixture.py"
    mine = sorted((f.rule, f.line, f.status) for f in
                  lint_source(SHARED[name], path)
                  if f.rule in ("R0", "R2", "R3", "R6"))
    ref = sorted((f.rule, f.line, f.status) for f in
                 jlint.lint_source(SHARED[name], path, JConfig())
                 if f.rule in ("R0", "R2", "R3", "R6"))
    assert mine == ref and mine


class TestRepoSelfAudit:
    def test_port_is_clean(self):
        report = run_lint()
        open_f = [f for f in report["findings"] if f["status"] == "open"]
        assert report["ok"], "\n".join(
            f"{f['path']}:{f['line']}: {f['rule']}: {f['message']}"
            for f in open_f)
        assert report["files_scanned"] > 70
        scanned = {f["path"] for f in report["findings"]}
        assert "src/repro_torch/ingest/pipeline.py" in scanned

    def test_every_suppression_has_a_reason(self):
        report = run_lint()
        for f in report["findings"]:
            if f["status"] in ("allowlisted", "disabled"):
                assert f["reason"].strip(), f
        for e in load_config().allow:
            assert e.reason.strip() and e.rule and e.path, e

    def test_roots_cover_the_port_and_the_smoke_script(self):
        root = find_repo_root()
        files = lint_mod.iter_py_files(root, load_config().roots)
        rel = {os.path.relpath(f, root) for f in files}
        assert "chip_smoke.py" in rel
        assert "src/repro_torch/analysis/retrace.py" in rel

    def test_cli_json_output(self, tmp_path, capsys):
        out = tmp_path / "lint.json"
        assert lint_mod.main(["--json", "-o", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["tool"] == "aeriallint.port" and report["ok"]
        assert json.loads(capsys.readouterr().out)["ok"]

    def test_cli_exits_1_on_a_finding(self, tmp_path, capsys):
        bad = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
        bad.parent.mkdir(parents=True)
        bad.write_text("from repro_torch.api import AerialDB\nAerialDB.open()\n")
        (tmp_path / "pyproject.toml").write_text("")
        assert lint_mod.main(["--json", "--root", str(tmp_path), str(bad)]) == 1
        report = json.loads(capsys.readouterr().out)
        assert [(f["rule"], f["path"]) for f in report["findings"]] == [
            ("R1", "src/repro_torch/core/bad.py")]

    def test_config_file_is_the_package_toml(self):
        assert CONFIG_PATH.endswith("src/repro_torch/analysis/aeriallint.toml")
        cfg = load_config()
        for device in ("cpu", "cuda"):
            assert set(cfg.retrace_budgets[device]) == set(retrace.LEGS)


# ---------------------------------------------------------------------------
# Layer 2: the sync, launch and build budget
# ---------------------------------------------------------------------------

class TestRetraceBudget:
    def test_canonical_workload_is_the_references(self):
        assert retrace._CANON_KWARGS == jretrace._CANON_KWARGS
        assert retrace._N_DRONES == jretrace._N_DRONES

    def test_canonical_workload_meets_budgets(self):
        """Exact CPU budgets cold and warm on the single store, (4,) and
        (2, 2), no build and no load (tier-1 gate)."""
        report = retrace.run_retrace("cpu")
        assert report["ok"], "\n".join(v["message"] for v in report["violations"])
        assert [r["leg"] for r in report["runs"]] == list(retrace.LEGS)
        for r in report["runs"]:
            assert r["cold"] == r["warm"], r["leg"]
            assert set(r["cold"]) == {"open", "insert", "ingest_rounds",
                                      "query[0]", "query[0,1]", "fail_edges",
                                      "recover_edges"}
            for c in r["warm"].values():
                assert not c["launches"] and not c["builds"] and not c["loads"]

    def test_cli_json_output(self, tmp_path, capsys):
        out = tmp_path / "retrace.json"
        assert retrace.main(["--device", "cpu", "--json", "-o", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["ok"] and report["device"] == "cpu"
        assert json.loads(capsys.readouterr().out)["tool"] == "aeriallint.retrace"

    def test_planted_item_in_insert_is_flagged(self, monkeypatch):
        real = AerialDB.insert

        def insert(self, payload, meta):
            info = real(self, payload, meta)
            info["intake_per_edge"].sum().item()      # the planted sync
            return info
        monkeypatch.setattr(AerialDB, "insert", insert)
        report = retrace.run_retrace("cpu", legs=("single",))
        bad = {(v["phase"], v["entry"], v["what"], v["want"], v["got"])
               for v in report["violations"]}
        assert bad == {("cold", "insert", "syncs", 0, 2),
                       ("warm", "insert", "syncs", 0, 2)}
        ops = report["runs"][0]["warm"]["insert"]["ops"]
        assert ops == {"item": 2}

    def test_counter_catches_weak_config_hash(self):
        """The regression the harness exists for: a per-configuration cache
        keyed by a config whose equal values do not hash equal fills again
        on every call, here a boolean-mask read each time."""
        @dataclasses.dataclass(frozen=True, eq=False)     # identity hash
        class WeakCfg:
            n: int = 3

        @dataclasses.dataclass(frozen=True)               # value hash
        class StrongCfg:
            n: int = 3

        @functools.lru_cache(maxsize=None)
        def packed(cfg):
            x = torch.arange(cfg.n)
            return x[x > 0]

        meter = retrace.Meter("cpu")
        for cfg_cls in (WeakCfg, StrongCfg):
            with meter(cfg_cls.__name__):
                packed(cfg_cls())
                packed(cfg_cls())
        assert meter.counts["WeakCfg"]["syncs"] == 2
        assert meter.counts["StrongCfg"]["syncs"] == 1

    def test_store_config_is_value_hashed(self):
        a, b = retrace.canonical_config(), retrace.canonical_config()
        assert a is not b and a == b and hash(a) == hash(b)
        assert a.sites_array("cpu") is b.sites_array("cpu")   # one cache entry
        c = StoreConfig(n_edges=8, tuple_capacity=512)
        assert hash(c) == hash(StoreConfig(n_edges=8, tuple_capacity=512))

    @pytest.mark.parametrize("expr,op", [
        ("x[0].item()", "item"), ("x.tolist()", "tolist"), ("x.cpu()", "cpu"),
        ("x.numpy()", "numpy"), ("np.asarray(x)", "__array__"),
        ("bool(x.any())", "__bool__"), ("int(x[0])", "__int__"),
        ("float(x[0])", "__float__"), ("[1, 2, 3, 4][x[0]]", "__index__"),
        ("x.nonzero()", "nonzero"), ("torch.unique(x)", "unique"),
        ("x.masked_select(x > 1)", "masked_select"), ("x[x > 1]", "mask_index"),
        ("torch.where(x > 1)", "where"), ("torch.equal(x, x)", "equal")])
    def test_sync_counter_kinds(self, expr, op):
        x = torch.arange(4)
        with retrace.SyncCounter("cpu") as counter:
            eval(expr, {"x": x, "torch": torch, "np": np})
        assert dict(counter.ops) == {op: 1}

    def test_sync_counter_ignores_device_work(self):
        x = torch.arange(6)
        with retrace.SyncCounter("cpu") as counter:
            y = torch.where(x > 2, x, 0).sum(dim=0)
            x[torch.tensor([1, 2])] = y
        assert counter.syncs == 0
        with retrace.SyncCounter("cuda") as counter:    # no CPU tensor counts
            x.sum().item()
        assert counter.syncs == 0

    def test_meter_attributes_builds_and_the_warm_check_refuses_them(self):
        meter = retrace.Meter("cpu")
        try:
            with meter("insert"):
                build.builds["st_scan"] += 1
                build.loads["st_scan"] += 1
        finally:
            build.builds["st_scan"] -= 1
            build.loads["st_scan"] -= 1
        got = meter.report()
        assert got["insert"]["builds"] == {"st_scan": 1}
        bad = retrace._check({"insert": {"syncs": 0}}, got, "warm", "single",
                             card=False)
        assert [v["what"] for v in bad] == ["builds/loads"]
        assert retrace._check({"insert": {"syncs": 0}}, got, "cold", "single",
                              card=False) == []


LEG_MESHES = {"single": None,
              "edge4": lambda: j_make_edge_mesh(4, n_edges=8),
              "fleet2x2": lambda: j_make_fleet_mesh(2, 2, n_edges=8)}


def _jax_canonical(mesh):
    """The reference API driven through ``canonical_workload``'s steps."""
    cfg = jretrace.canonical_config()
    db = JaxDB.open(cfg, mesh=mesh, seed=0)
    fleet = JFleet(jretrace._N_DRONES, records_per_shard=cfg.records_per_shard,
                   n_values=cfg.n_values, seed=7)
    db.insert(*fleet.next_shards())
    db.ingest_rounds(*fleet.next_rounds(2))
    window = JQuery().bbox(12.0, 14.0, 77.0, 79.0).time(0.0, 1e5)
    single = window.agg("mean", channel=0)
    pred, _ = window.build()
    pair = JAggSpec(channels=(0, 1))
    answers = [db.query(single), db.query(pred, agg=pair)]
    db.fail_edges(1)
    answers.append(db.query(single))
    db.recover_edges(1)
    db.insert(*fleet.next_shards())
    answers.append(db.query(pred, agg=pair))
    return db, answers


@pytest.mark.usefixtures("bucketed_reference_placement")
@pytest.mark.parametrize("leg", retrace.LEGS)
def test_canonical_workload_matches_the_reference(leg):
    if leg != "single" and jax.device_count() < 4:
        pytest.skip("needs 4 host devices (conftest forces them)")
    jdb, janswers = _jax_canonical(LEG_MESHES[leg] and LEG_MESHES[leg]())
    cfg = retrace.canonical_config()
    tdb, tanswers = retrace.canonical_workload(
        cfg, retrace.mesh_for(leg, cfg.n_edges, "cpu"), "cpu")
    _assert_states_identical(tdb.state, jdb.state, f"{leg}: ")
    assert len(tanswers) == len(janswers) == 4
    for (tres, tinfo), (jres, jinfo) in zip(tanswers, janswers):
        _assert_query_equal(tres, tinfo, jres, jinfo)
    assert tdb.ledger() == jdb.ledger()
    assert int(tanswers[-1][0].count.sum()) > 0


# ---------------------------------------------------------------------------
# Layer 3: the collective contract
# ---------------------------------------------------------------------------

class TestCollectiveContract:
    def test_contract_holds_on_both_meshes(self):
        report = cc.run_collective_contract("cpu")
        assert report["ok"], "\n".join(report["violations"])
        assert [r["leg"] for r in report["runs"]] == ["single", "edge4", "fleet2x2"]
        single, edge, fleet = report["runs"]
        assert single["traffic"] == {"insert": {}, "ingest": {}, "query": {}}
        for r in (edge, fleet):
            assert r["sweeps"] == {"insert": 1, "ingest": 1}
            assert r["traffic"]["insert"] == r["traffic"]["ingest"] == {
                "watermark [('float32', (8,))]": 1}
        kinds = {k.split()[0] for k in fleet["traffic"]["query"]}
        assert kinds == {"merge1", "merge2", "combine"}
        assert {k.split()[0] for k in edge["traffic"]["query"]} == {"merge1", "combine"}

    def test_cli_json_output(self, tmp_path, capsys):
        out = tmp_path / "contract.json"
        assert cc.main(["--device", "cpu", "--json", "-o", str(out)]) == 0
        assert json.loads(out.read_text())["ok"]
        assert json.loads(capsys.readouterr().out)["ok"]

    def test_hook_gathering_the_log_is_refused(self, monkeypatch):
        """A watermark hook that also gathers every block's ``tup_f``: the
        traffic now grows with ``tuple_capacity``, and the watermark count
        doubles."""
        real_step, real_gather = fed.federated_insert_step, fed._gather_watermark

        def leaky_step(cfg, blocks, *a, **kw):
            def gather(parts):
                log = torch.cat([b.tup_f.to(parts[0].device) for b in blocks])
                fed._record("watermark", (log,))
                return real_gather(parts)
            monkeypatch.setattr(fed, "_gather_watermark", gather)
            try:
                return real_step(cfg, blocks, *a, **kw)
            finally:
                monkeypatch.setattr(fed, "_gather_watermark", real_gather)
        monkeypatch.setattr(fed, "federated_insert_step", leaky_step)
        v = cc.run_collective_contract("cpu")["violations"]
        for leg in ("edge4", "fleet2x2"):
            assert any(x.startswith(f"[{leg}/ingest] traffic depends on "
                                    "tuple_capacity") for x in v), v
            assert any(x.startswith(f"[{leg}/insert] 2 watermark") for x in v), v

    def test_clone_inside_ingest_is_refused(self, monkeypatch):
        real_local, real_step = fed.insert_local, fed.federated_insert_step
        monkeypatch.setattr(fed, "insert_local", lambda cfg, state, *a, **kw:
                            real_local(cfg, clone_state(state), *a, **kw))
        monkeypatch.setattr(
            fed, "federated_insert_step", lambda cfg, blocks, *a, **kw:
            real_step(cfg, tuple(clone_state(b) for b in blocks), *a, **kw))
        v = cc.run_collective_contract("cpu")["violations"]
        assert sorted(x.split("]")[0] for x in v) == [
            "[edge4/ingest", "[fleet2x2/ingest", "[single/ingest"], v
        assert all("not updated in place" in x for x in v)

    def test_contraband_kind_and_count_are_refused(self):
        cfg = retrace.canonical_config()
        mesh = retrace.mesh_for("edge4", cfg.n_edges, "cpu")
        run = {"traffic": {
            "insert": {("watermark", (("float32", (8,)),)): 1},
            "ingest": {("watermark", (("float32", (8,)),)): 2,
                       ("all_to_all", (("float32", (8, 384)),)): 1},
            "query": {("merge1", ()): 2, ("combine", ()): 2}},
            "sweeps": {"insert": 1, "ingest": 1}, "queries": 2}
        v = cc.check_kinds(run, mesh, 8, 4, load_config(), "x")
        assert v == ["[x/ingest] moves ['all_to_all'], contract "
                     "['watermark', 'world']",
                     "[x/ingest] 2 watermark gathers for 1 sweep step(s)"]

    def test_traffic_record_is_shape_and_dtype(self):
        fed.traffic.clear()
        fed._record("merge1", (torch.zeros(2, 3, dtype=torch.bool),
                               torch.zeros(4, dtype=torch.int32)))
        assert fed.traffic == {("merge1", (("bool", (2, 3)),
                                           ("int32", (4,)))): 1}
        fed.traffic.clear()
