"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/*.py``), on the CPU, as a user runs them.

Each reference example is loaded from its file and its ``main()`` run once
a module, its standard output captured; the port's ``main(device="cpu")``
is run once a module too, its lines captured through ``log``. The two
outputs are held line by line:

- Timing fields are taken out of both first, and only they:
  ``TIMING`` (``insert=…ms``, ``query(8)=…ms``, ``in …s (… tok/s on …)``).
  The federated example's device note, ``(4 host devices)`` in the
  reference and ``(4 blocks on cpu)`` in the port, is reduced to its count
  by ``DEVICES``.
- Printed integers and strings are equal. A printed float may differ by at
  most one unit in its last printed digit: the print resolution of the
  rtol 1e-5 policy for ``vmean`` and ``vsum`` (their reduction order
  differs), which can move a rounded digit by one.
- serve_lm runs both packages on the JAX weights (``jax.random.key(0)``,
  converted with ``params_from_numpy``): its printed sample is row 0's
  first 12 ids, so they are held bitwise. Beside it, all 8 x 24 steps
  along one sequence (``serve_lm.compare``): JAX's ``Engine`` fed the
  port's ids, every logit within ``serve_lm.LOGIT_TOL`` (0.1) of the
  port's, and the ids equal wherever JAX's two largest logits lie more
  than 0.2 apart. Left to pick their own ids, the two packages' runs part
  in 3 of the 8 rows, each at a near tie (JAX's two largest logits 0 or
  0.0156 apart), because they round their bf16 logits at different
  places; along one sequence the logits differ by at most 0.078 (5 bf16
  ulps at their size, 2 to 4) and the ids at 4 of 192 steps, all at such
  ties. So the ids are not bitwise over the whole run.

Per-example results are checked on the returned dicts: the disaster
mission's completeness 1.0 in every round with 1 and 2 edges down in rounds
2 and 3, the federated store's ``state_equal``, the streaming pipeline's
reconcile audit.
"""

import contextlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest

from repro_torch.examples._common import EXAMPLES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = re.compile(r"insert=\s*[\d.]+ms|query\(8\)=\s*[\d.]+ms"
                    r"|in [\d.]+s \(\d+ tok/s on [^)]*\)")
DEVICES = re.compile(r"\((\d+) (?:host devices|blocks on \w+)\)")
FLOAT = re.compile(r"-?\d+\.(\d+)|nan")


def _lm_serve_jax():
    """The reference example's model and weights, as its ``main`` makes
    them."""
    import jax
    from repro.configs.base import ModelConfig
    from repro.models.model import Model
    cfg = ModelConfig(name="lm-serve", family="dense", n_layers=4, d_model=128,
                      n_heads=4, n_kv=2, d_head=32, d_ff=512, vocab=512,
                      attn_chunk_kv=64)
    model = Model(cfg)
    return model, model.init(jax.random.key(0))


class _Runs:
    """Each example run once a module by either package, on demand."""

    def __init__(self):
        self._ref, self._port = {}, {}

    def reference(self, name: str) -> list:
        if name not in self._ref:
            spec = importlib.util.spec_from_file_location(
                f"reference_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                mod.main()
            self._ref[name] = out.getvalue().splitlines()
        return self._ref[name]

    def port(self, name: str) -> tuple:
        if name not in self._port:
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            kw = {}
            if name == "serve_lm":
                from repro_torch.convert import params_from_numpy
                kw["params"] = params_from_numpy(_lm_serve_jax()[1], device="cpu")
            out = []
            result = mod.main(device="cpu", log=out.append, **kw)
            self._port[name] = ("\n".join(out).splitlines(), result)
        return self._port[name]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _normalise(line: str) -> str:
    return DEVICES.sub(r"(\1 devices)", TIMING.sub("<time>", line))


def _assert_lines_match(got: str, want: str) -> None:
    got, want = _normalise(got), _normalise(want)
    assert FLOAT.split(got)[::2] == FLOAT.split(want)[::2], (got, want)
    g_f = [m.group(0) for m in FLOAT.finditer(got)]
    w_f = [m.group(0) for m in FLOAT.finditer(want)]
    assert len(g_f) == len(w_f), (got, want)
    for g, w in zip(g_f, w_f):
        if "nan" in (g, w):
            assert g == w, (got, want)
            continue
        digits = len(w.split(".")[1])
        assert len(g.split(".")[1]) == digits, (got, want)
        assert abs(float(g) - float(w)) <= 1.5 * 10.0 ** -digits, (got, want)


@pytest.mark.parametrize("name", EXAMPLES)
def test_printed_lines_match_the_reference(runs, name):
    want = runs.reference(name)
    got, _ = runs.port(name)
    assert len(got) == len(want), ("\n".join(got), "\n".join(want))
    for g, w in zip(got, want):
        _assert_lines_match(g, w)


def test_line_comparison_refuses_a_moved_digit():
    """The comparison's own control: one unit in the last printed digit
    passes, two do not, nor does a changed integer or word."""
    _assert_lines_match("count=122 mean_v=24.27", "count=122 mean_v=24.26")
    for bad in ("count=122 mean_v=24.28", "count=123 mean_v=24.26",
                "count=122 mean_w=24.26", "count=122 mean_v=24.3"):
        with pytest.raises(AssertionError):
            _assert_lines_match(bad, "count=122 mean_v=24.26")
    _assert_lines_match("round 0 [all-up] insert=  784.6ms query(8)= 2742.4ms",
                        "round 0 [all-up] insert= 1483.7ms query(8)=  987.1ms")


def test_disaster_stays_exact_under_two_failures(runs):
    rounds = runs.port("disaster_analytics")[1]["rounds"]
    assert [r["completeness"] for r in rounds] == [1.0] * 5
    assert [r["edges_down"] for r in rounds] == [0, 0, 1, 2, 2]
    assert [r["phase"] for r in rounds][2:4] == ["1 edge down", "2 edges down"]


def test_federated_state_equals_the_single_store(runs):
    result = runs.port("federated_quickstart")[1]
    assert result["state_equal"] is True
    assert result["count"] == result["single_count"]


def test_streaming_reconciles(runs):
    audit = runs.port("streaming_ingest_demo")[1]["reconcile"]
    assert audit["ok"] and audit["counters_ok"] and audit["stored_ok"]
    assert audit["accepted"] == audit["flushed_records"] + audit["pending"]
    assert audit["pending"] == 0
    assert audit["stored_tuples"] == 3 * audit["flushed_records"]


def _jax_along(ids: np.ndarray, prompts: np.ndarray) -> dict:
    """JAX's ``Engine`` on the reference's weights, fed ``ids`` after the
    prompts: its own pick and its logits at every step."""
    import jax
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import ServeConfig as JServeConfig

    class Forced(JEngine):
        def __init__(self, *args):
            super().__init__(*args)
            self.logits, self.picks = [], []

        def _sample(self, logits, key, i):
            self.logits.append(np.asarray(logits, np.float32))
            self.picks.append(np.asarray(super()._sample(logits, key, i)))
            return jax.numpy.asarray(ids[:, min(i, ids.shape[1] - 1)])

    model, params = _lm_serve_jax()
    engine = Forced(model, params, JServeConfig(max_new_tokens=ids.shape[1],
                                                max_seq=128))
    engine.generate(prompts)
    n = ids.shape[1]
    return {"ids": np.stack(engine.picks[:n], 1),
            "logits": np.stack(engine.logits[:n], 1), "prompts": prompts}


def test_serve_lm_logits_match_the_jax_engine(runs):
    """The port's 8 x 24 steps against JAX's ``Engine`` on the same weights
    and prompts, fed the port's ids (``serve_lm.compare``): every logit
    within ``LOGIT_TOL`` (largest difference read: 0.078), and the ids
    equal wherever JAX's two largest logits lie more than twice that
    apart (109 of the 192 steps)."""
    from repro_torch.examples.serve_lm import compare
    result = runs.port("serve_lm")[1]
    assert result["ids"].shape == (8, 24) and result["logits"].shape == (8, 24, 512)
    got = compare(result, _jax_along(result["ids"], result["prompts"]))
    assert got["mismatches"] == [], got
    assert got["ids_held"] >= 100, got


def test_serve_lm_fed_its_own_ids_repeats_its_run(runs):
    """The teacher forcing's control: the port fed the ids it picked gives
    the same ids and logits, bitwise."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.examples import serve_lm
    result = runs.port("serve_lm")[1]
    again = serve_lm.main(device="cpu", log=lambda _: None, forced=result["ids"],
                          params=params_from_numpy(_lm_serve_jax()[1], device="cpu"))
    assert np.array_equal(again["ids"], result["ids"])
    assert np.array_equal(again["logits"], result["logits"])


def test_serve_lm_compare_refuses_swapped_heads(runs, monkeypatch):
    """``serve_lm.compare`` against a run whose attention swaps its two KV
    groups' outputs (a planted fault, fed the good run's ids): its logits
    are refused."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.examples import serve_lm
    from repro_torch.models import attention
    result = runs.port("serve_lm")[1]
    plain = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: plain(*a, **kw).roll(2, 2))
    faulty = serve_lm.main(device="cpu", log=lambda _: None, forced=result["ids"],
                           params=params_from_numpy(_lm_serve_jax()[1], device="cpu"))
    got = serve_lm.compare(result, faulty)
    assert got["logits_max_diff"] > serve_lm.LOGIT_TOL
    assert got["mismatches"][0].startswith(".logits"), got


def test_serve_lm_compare_refuses_what_the_policy_refuses():
    """``serve_lm.compare``'s own control on made-up runs: an id may part
    only where the reference's two largest logits lie within twice the
    tolerance, a logit may move within the tolerance and no further, and NaN is
    refused."""
    from repro_torch.examples.serve_lm import compare
    logits = np.zeros((1, 3, 4), np.float32)
    logits[0, :, 0] = [3.0, 3.0, 3.0]
    logits[0, :, 1] = [2.0, 2.9, 2.5]          # gaps 1.0, 0.1, 0.5
    want = {"ids": np.zeros((1, 3), np.int32), "logits": logits,
            "prompts": np.ones((1, 2), np.int32)}
    assert compare(want, want) == {
        "mismatches": [], "logits_max_diff": 0.0, "ids_held": 2,
        "ids_parted": 0, "parted_max_gap": 0.0}
    near = dict(want, ids=np.array([[0, 1, 0]], np.int32))
    assert compare(near, want)["mismatches"] == []
    far = dict(want, ids=np.array([[0, 0, 1]], np.int32))
    assert compare(far, want)["mismatches"] == [".ids[0, 2]"]
    moved = logits.copy()
    moved[0, 1, 3] = 0.09375
    assert compare(dict(want, logits=moved), want)["mismatches"] == []
    moved[0, 1, 3] = 0.109375
    assert compare(dict(want, logits=moved), want)["mismatches"][0] \
        .startswith(".logits")
    moved[0, 1, 3] = np.nan
    assert compare(dict(want, logits=moved), want)["mismatches"][0] \
        .startswith(".logits")
    assert compare(dict(want, prompts=want["prompts"] + 1), want)["mismatches"] == [".prompts"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_the_host_run_launches_no_kernel(runs, name):
    """On the CPU every kernel wrapper takes its plain version: an example's
    launches, as its result reports them, are all 0."""
    launches = runs.port(name)[1]["launches"]
    assert launches and not any(launches.values()), launches


def test_hold_refuses_what_the_policy_refuses():
    """``examples._common.hold``, the card phase's comparison: a sum or mean
    within rtol 1e-5 passes; outside it, a moved min, count or id, another
    message, or a NaN against a number does not."""
    from repro_torch.examples._common import hold
    want = {"vmean": [25.0, float("nan")], "shown": {"x": {"sum": 1e4, "min": 9.5}},
            "ids": np.arange(6, dtype=np.int32).reshape(2, 3), "msg": "inverted",
            "audit": {"ok": True, "pending": 0}, "launches": {"st_scan": 3}}
    assert hold(dict(want, launches={}), want) == []
    assert hold(dict(want, vmean=[25.0 * (1 + 5e-6), float("nan")]), want) == []
    ids = want["ids"].copy()
    ids[1, 2] += 1
    for bad, path in (({"vmean": [25.0 * (1 + 2e-5), float("nan")]}, ".vmean[0]"),
                      ({"vmean": [25.0, 0.0]}, ".vmean[1]"),
                      ({"shown": {"x": {"sum": 1e4, "min": 9.500001}}}, ".shown.x.min"),
                      ({"ids": ids}, ".ids[1, 2]"),
                      ({"msg": "inverted "}, ".msg"),
                      ({"audit": {"ok": False, "pending": 0}}, ".audit.ok")):
        assert hold(dict(want, **bad), want) == [path]


@pytest.mark.parametrize("name", ["quickstart", "serve_lm"])
def test_card_vs_cpu_runs_on_the_host(name):
    """The card phase's comparison, with both runs on the CPU: two runs of the
    plain path agree (serve_lm's along one sequence, to the bit), and no
    flash kernel call is held."""
    from repro_torch.examples._common import card_vs_cpu
    got = card_vs_cpu(name, "cpu")
    assert got["mismatches"] == [], got
    assert got["flash_calls"] == {"calls": {}, "max_abs_err": 0.0, "bad_calls": 0}
    assert got.get("logits_max_diff", 0.0) == 0.0
    assert got["lines"][-1].startswith(
        "2 edges down" if name == "quickstart" else "sample continuation ids")


def test_missing_kernels_names_what_did_not_launch():
    from repro_torch.examples._common import launch_counts, missing_kernels
    none = dict.fromkeys(launch_counts(), 0)
    assert missing_kernels("quickstart", none) == ["st_scan", "hash64", "voronoi_assign"]
    assert missing_kernels("streaming_ingest_demo",
                           dict(none, hash64=3, voronoi_assign=1)) == []
    assert missing_kernels("serve_lm", dict(none, flash_bwd=4)) == ["flash"]
    assert missing_kernels("serve_lm", dict(none, flash_decode=144)) == []
