"""aeriallint rule engine of the port: AST rules over one source file.

Port of ``repro.analysis.rules``, rewritten for ``repro_torch``'s code: the
rule ids, the pragma form and the allowlist policy are the reference's.

  R0  meta: a ``# aeriallint: disable=`` pragma or an allowlist entry
      without a reason string.
  R1  layering: ``repro_torch.{core,distributed,kernels}`` never import
      ``repro_torch.{api,ingest,chaos}``; ``repro_torch.ingest`` imports
      only the facade (``repro_torch.api``) and itself; no runtime module
      (``src/repro_torch`` outside ``analysis/``) imports
      ``repro_torch.analysis``, which sits outside the runtime; and nothing
      scanned imports ``jax``, ``jaxlib`` or the JAX package ``repro`` (the
      port keeps its own copies).
  R2  deprecation: no ``insert_step`` / ``query_step`` import or call (the
      port has no such shims; the facade is the API).
  R3  determinism: no wall-clock read (``time.time`` / ``monotonic`` /
      ``perf_counter`` / ``sleep``, ``datetime.now`` ...) in
      ``src/repro_torch``, and no global-state randomness anywhere scanned:
      ``torch.rand/randn/randint/randperm/normal/bernoulli/multinomial``
      and the in-place ``Tensor.uniform_/normal_/random_/bernoulli_/
      exponential_`` without ``generator=``, ``torch.manual_seed``,
      unseeded ``np.random.*``, bare stdlib ``random.*``.
  R4  host sync inside a configured hot function (``hot_functions``, and
      the defs nested in one): ``.item()``, ``.tolist()``, ``.cpu()``,
      ``.numpy()``, ``.to("cpu")``, ``np.asarray`` / ``np.array``,
      ``torch.cuda.synchronize``, ``.nonzero()``, ``torch.unique``,
      ``masked_select``, and ``int`` / ``float`` / ``bool`` of a
      non-literal: on the card each waits for the device.
  R5  hidden sync by branching: a Python ``if`` / ``while`` in a hot
      function whose test calls ``torch.*`` or a ``.any()`` / ``.all()``
      method (on the card the branch reads the tensor back).
  R6  dead imports: a module-level import never referenced in the module
      (``__init__.py`` re-export surfaces and names in ``__all__`` exempt).

Escape hatch: ``# aeriallint: disable=R4 -- <reason>`` on the finding line
or the line directly above. The reason is mandatory (R0 otherwise).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from fnmatch import fnmatch
from typing import List, Optional, Tuple

from repro_torch.analysis.config import AeriallintConfig

PORT = "src/repro_torch/"

# R1: the runtime layers that must never see the layers above them.
_RUNTIME_LAYERS = tuple(PORT + p for p in ("core/", "distributed/", "kernels/"))
_UPPER_LAYERS = ("repro_torch.api", "repro_torch.ingest", "repro_torch.chaos")
_INGEST_OK = ("repro_torch.api", "repro_torch.ingest")
_FOREIGN = ("jax", "jaxlib", "repro")
_ANALYSIS = ("repro_torch.analysis",)

_DEPRECATED = ("insert_step", "query_step")

# R3: wall-clock reads (src/repro_torch only: scripts legitimately time).
_CLOCK_CALLS = {("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
                ("time", "monotonic_ns"), ("time", "perf_counter"),
                ("time", "perf_counter_ns"), ("time", "sleep"),
                ("datetime", "now"), ("datetime", "utcnow"),
                ("datetime", "today")}
_SEEDED_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "PCG64DXSM",
              "Philox", "MT19937", "SFC64", "BitGenerator", "RandomState"}
# R3: torch's draws from the global generator unless given ``generator=``.
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                "multinomial"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_", "cauchy_", "log_normal_", "geometric_"}
_GLOBAL_SEEDS = {("torch", "manual_seed"), ("torch", "seed"),
                 ("torch", "random", "manual_seed"),
                 ("torch", "cuda", "manual_seed"),
                 ("torch", "cuda", "manual_seed_all")}

# R4: reads that wait for the device.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero", "masked_select",
                 "unique"}
_SYNC_TORCH = {("torch", "cuda", "synchronize"), ("torch", "nonzero"),
               ("torch", "unique"), ("torch", "masked_select")}

_PRAGMA_RE = re.compile(
    r"#\s*aeriallint:\s*disable=([A-Za-z0-9,\s]+?)\s*(?:--\s*(.*))?$")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    snippet: str = ""
    status: str = "open"   # open | disabled (pragma) | allowlisted (config)
    reason: str = ""       # the pragma / allowlist justification

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        tag = "" if self.status == "open" else f" [{self.status}]"
        return f"{self.path}:{self.line}: {self.rule}{tag}: {self.message}"


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _ModuleScan(ast.NodeVisitor):
    """One pass collecting imports (and what each local name binds), every
    name read, ``__all__`` and the function defs by name."""

    def __init__(self):
        self.imports: List[Tuple[ast.AST, str, str]] = []  # (node, module, local)
        self.import_binds: dict = {}       # local name -> canonical dotted
        self.used_names: set = set()
        self.func_defs: dict = {}          # name -> [def nodes]
        self.all_exports: set = set()

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            local = a.asname or a.name.split(".")[0]
            self.imports.append((node, a.name, a.asname or a.name))
            self.import_binds[local] = a.name if a.asname else \
                a.name.split(".")[0]
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = node.module or ""
        for a in node.names:
            local = a.asname or a.name
            full = f"{mod}.{a.name}" if mod else a.name
            self.imports.append((node, full, local))
            self.import_binds[local] = full
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            self.used_names.add(node.id)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == "__all__":
                for el in ast.walk(node.value):
                    if isinstance(el, ast.Constant) and isinstance(
                            el.value, str):
                        self.all_exports.add(el.value)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        self.func_defs.setdefault(node.name, []).append(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def _canonical(d: str, scan: _ModuleScan) -> Tuple[str, ...]:
    """A dotted call name with its first part resolved through the module's
    imports: ``F.normal`` after ``import torch.nn.functional as F`` is
    ('torch', 'nn', 'functional', 'normal')."""
    head, *rest = d.split(".")
    return tuple(scan.import_binds.get(head, head).split(".")) + tuple(rest)


def _collect_pragmas(source: str):
    """line number -> (set of rule ids, reason)."""
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = (rules, (m.group(2) or "").strip())
    return out


def _hot_functions(scan: _ModuleScan, path: str,
                   cfg: AeriallintConfig) -> List[ast.AST]:
    """The configured hot functions of this file and every def nested in
    one (they run on the same path)."""
    names = set()
    for spec in cfg.hot_functions:
        if "::" in spec:
            glob, fname = spec.rsplit("::", 1)
            if fnmatch(path, glob):
                names.add(fname)
    stack = [fn for name in names for fn in scan.func_defs.get(name, ())]
    seen, out = set(), []
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.append(fn)
        stack.extend(sub for sub in ast.walk(fn) if sub is not fn and isinstance(
            sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))
    return out


def _is_module(module: str, names) -> bool:
    return any(module == n or module.startswith(n + ".") for n in names)


def _r1_layering(scan, path, add):
    in_runtime = path.startswith(_RUNTIME_LAYERS)
    in_ingest = path.startswith(PORT + "ingest/")
    in_runtime_pkg = path.startswith(PORT) and \
        not path.startswith(PORT + "analysis/")
    for node, module, _local in scan.imports:
        if in_runtime_pkg and _is_module(module, _ANALYSIS):
            add("R1", node.lineno,
                f"layering violation: {path} imports '{module}': the "
                "analysis package sits outside the runtime and only reads "
                "it; no runtime module may depend on it.")
        if _is_module(module, _FOREIGN):
            add("R1", node.lineno,
                f"foreign import '{module}' in {path}: the port imports "
                "neither JAX nor the JAX package (not even a module of it "
                "that needs no JAX); keep a copy in repro_torch.")
        if in_runtime and _is_module(module, _UPPER_LAYERS):
            add("R1", node.lineno,
                f"layering violation: {path} (runtime layer) imports "
                f"'{module}': core/distributed/kernels must never see the "
                "facade, ingest or chaos layers above them.")
        if in_ingest and module.startswith("repro_torch") and not \
                _is_module(module, _INGEST_OK):
            add("R1", node.lineno,
                f"layering violation: repro_torch.ingest imports '{module}'"
                ": the ingest pipeline sits OVER the facade (repro_torch.api)"
                " and must not reach runtime internals.")


def _r2_deprecation(tree, scan, add):
    for node, module, _local in scan.imports:
        leaf = module.split(".")[-1]
        if leaf in _DEPRECATED:
            add("R2", node.lineno,
                f"deprecated shim import: '{leaf}': go through "
                "repro_torch.api.AerialDB (insert/ingest_rounds/query).")
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name in _DEPRECATED:
                add("R2", node.lineno,
                    f"deprecated shim call: '{name}(...)': use the AerialDB "
                    "facade.")


def _r3_determinism(tree, scan, path, add):
    check_clock = path.startswith(PORT)
    stdlib_random = scan.import_binds.get("random") == "random"
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        kwargs = {kw.arg for kw in node.keywords}
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _INPLACE_DRAWS and "generator" not in kwargs:
            add("R3", node.lineno,
                f"'.{node.func.attr}(...)' without generator= draws from "
                "torch's global generator: pass a seeded torch.Generator so "
                "a run is pure in its seeds.")
            continue
        d = _dotted(node.func)
        if d is None:
            continue
        raw = tuple(d.split("."))
        parts = _canonical(d, scan)
        if check_clock and len(raw) >= 2 and raw[-2:] in _CLOCK_CALLS \
                and raw[0] in ("time", "datetime"):
            add("R3", node.lineno,
                f"wall-clock read '{d}()' in src/repro_torch: replay must be "
                "pure in its seeds (pass clocks in, or allowlist telemetry "
                "with a reason).")
        if parts[0] == "torch" and len(parts) == 2 and \
                parts[1] in _TORCH_DRAWS and "generator" not in kwargs:
            add("R3", node.lineno,
                f"'{d}(...)' without generator= draws from torch's global "
                "generator: pass a seeded torch.Generator.")
        if parts in _GLOBAL_SEEDS:
            add("R3", node.lineno,
                f"'{d}(...)' seeds torch's global generator, which every "
                "caller in the process shares: seed a torch.Generator and "
                "pass it.")
        if len(raw) >= 3 and raw[0] in ("np", "numpy") \
                and raw[1] == "random" and raw[2] not in _SEEDED_OK:
            add("R3", node.lineno,
                f"unseeded global-state RNG '{d}()': use "
                "np.random.default_rng(seed) (or a passed-in Generator).")
        if stdlib_random and len(raw) == 2 and raw[0] == "random":
            add("R3", node.lineno,
                f"bare stdlib RNG '{d}()' draws from hidden global state: "
                "use np.random.default_rng(seed).")


def _sync_call(node: ast.Call, scan, np_aliases) -> Optional[str]:
    """The name of the device->host read ``node`` makes, or None."""
    d = _dotted(node.func)
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in _SYNC_METHODS and (d is None or d.split(".")[0]
                                      not in np_aliases):
            return f".{attr}()"
        if attr == "to" and any(isinstance(a, ast.Constant) and a.value == "cpu"
                                for a in list(node.args) + [
                                    kw.value for kw in node.keywords]):
            return '.to("cpu")'
    if d is None:
        return None
    parts = _canonical(d, scan)
    if parts[0] in np_aliases | {"numpy"} and parts[-1] in ("asarray", "array"):
        return f"{d}(...)"
    if parts in _SYNC_TORCH:
        return f"{d}(...)"
    if isinstance(node.func, ast.Name) and node.func.id in ("int", "float",
                                                             "bool") \
            and node.args and not isinstance(node.args[0], ast.Constant):
        return f"{node.func.id}(...) of a non-literal"
    return None


def _r4_r5_hot(scan, path, cfg, add):
    np_aliases = {local for local, mod in scan.import_binds.items()
                  if mod == "numpy"} | {"np"}
    seen = set()

    def once(rule, node, message):
        # a def nested in a hot function is walked with it and on its own
        if (rule, node.lineno, node.col_offset) not in seen:
            seen.add((rule, node.lineno, node.col_offset))
            add(rule, node.lineno, message)
    for fn in _hot_functions(scan, path, cfg):
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        fname = getattr(fn, "name", "<lambda>")
        for node in (n for b in body for n in ast.walk(b)):
            if isinstance(node, ast.Call):
                what = _sync_call(node, scan, np_aliases)
                if what:
                    once("R4", node,
                        f"{what} inside hot function '{fname}': on the card "
                        "it waits for the device, serializing the launch "
                        "queue (read telemetry lazily, outside the path).")
            if isinstance(node, (ast.If, ast.While)):
                for sub in ast.walk(node.test):
                    if not isinstance(sub, ast.Call):
                        continue
                    d = _dotted(sub.func) or ""
                    torch_call = _canonical(d, scan)[0] == "torch" if d \
                        else False
                    reduce_call = isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in ("any", "all")
                    if torch_call or reduce_call:
                        once("R5", node,
                            f"Python branch on a tensor ('{d or '...'}' in "
                            f"the test) inside hot function '{fname}': on "
                            "the card the test reads the tensor back, a "
                            "hidden sync; use torch.where, or decide on the "
                            "host.")
                        break


def _r6_dead_imports(scan, path, add):
    if path.endswith("__init__.py"):
        return
    for node, module, local in scan.imports:
        base = local.split(".")[0]
        if base.startswith("_") or module.startswith("__future__"):
            continue
        if base in scan.used_names or base in scan.all_exports:
            continue
        add("R6", node.lineno,
            f"dead import: '{local}' (from '{module}') is never used in "
            "this module.")


def lint_source(source: str, path: str,
                cfg: Optional[AeriallintConfig] = None) -> List[Finding]:
    """Lint one file's source text. ``path`` is repo-relative with forward
    slashes: rules key their scope off it. Returns ALL findings, those a
    pragma or the allowlist suppresses with status 'disabled' /
    'allowlisted' (callers gate on status == 'open')."""
    cfg = cfg or AeriallintConfig()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("R0", path, e.lineno or 1,
                        f"file does not parse: {e.msg}")]
    scan = _ModuleScan()
    scan.visit(tree)
    lines = source.splitlines()
    findings: List[Finding] = []

    def add(rule: str, line: int, message: str):
        snippet = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        findings.append(Finding(rule, path, line, message, snippet=snippet))

    _r1_layering(scan, path, add)
    _r2_deprecation(tree, scan, add)
    _r3_determinism(tree, scan, path, add)
    _r4_r5_hot(scan, path, cfg, add)
    _r6_dead_imports(scan, path, add)

    # Pragmas suppress findings on their line or the line below an own-line
    # pragma; a pragma without a reason is itself a finding.
    pragmas = _collect_pragmas(source)
    for pline, (rules, reason) in pragmas.items():
        if not reason:
            findings.append(Finding(
                "R0", path, pline,
                "aeriallint disable pragma without a reason: write "
                "'# aeriallint: disable=Rn -- <why this is intentional>'.",
                snippet=lines[pline - 1].strip()))
    for f in findings:
        for pline in (f.line, f.line - 1):
            pr = pragmas.get(pline)
            if pr and f.rule in pr[0] and pr[1]:
                f.status, f.reason = "disabled", pr[1]
                break

    # The allowlist (reasonless entries are reported once, by
    # lint.config_policy_findings).
    for f in findings:
        if f.status != "open":
            continue
        for e in cfg.allow:
            if e.rule != f.rule or not e.reason or not fnmatch(f.path, e.path):
                continue
            if e.match and e.match not in f.message and \
                    e.match not in f.snippet:
                continue
            f.status, f.reason = "allowlisted", e.reason
            break
    return findings
