"""aeriallint over the port, its command line: walk the configured roots,
apply the rule engine, report the findings.

    python -m repro_torch.analysis.lint            # human-readable, exit 1 on open
    python -m repro_torch.analysis.lint --json     # machine-readable findings
    python -m repro_torch.analysis.lint --json -o LINT.json

Port of ``repro.analysis.lint``. Exit status is 0 iff every finding is
suppressed by a *reasoned* pragma or allowlist entry. The JSON report
carries every finding (open, disabled, allowlisted) and the R0 findings of
the configuration itself (reasonless allowlist entries), so the
suppressions stay reviewable. Roots may be directories or single files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis.config import (AeriallintConfig, find_repo_root,
                                         load_config)
from repro_torch.analysis.rules import Finding, lint_source

_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", ".ruff_cache", "node_modules"}
_CONFIG_NAME = "src/repro_torch/analysis/aeriallint.toml"


def iter_py_files(repo_root: str, roots) -> List[str]:
    out = []
    for r in roots:
        base = os.path.join(repo_root, r)
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            out.extend(os.path.join(dirpath, fn) for fn in sorted(filenames)
                       if fn.endswith(".py"))
    return out


def _relpath(path: str, repo_root: str) -> str:
    return os.path.relpath(os.path.abspath(path), repo_root).replace(
        os.sep, "/")


def lint_files(paths, repo_root: str,
               cfg: Optional[AeriallintConfig] = None) -> List[Finding]:
    """Lint explicit files (absolute or repo-relative); returns every
    finding, suppressed ones included."""
    cfg = cfg or load_config()
    findings: List[Finding] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(repo_root, p)
        with open(full, encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), _relpath(full, repo_root),
                                        cfg))
    return findings


def config_policy_findings(cfg: AeriallintConfig) -> List[Finding]:
    """R0 findings for allowlist entries missing their reason, rule or path
    (the rule engine skips reasonless entries; here they are errors)."""
    out = []
    for i, e in enumerate(cfg.allow):
        if not e.reason.strip():
            out.append(Finding(
                "R0", _CONFIG_NAME, 0,
                f"allow entry #{i + 1} (rule={e.rule!r}, path={e.path!r}) has "
                "no reason: every suppression must say why it is "
                "intentional."))
        if not e.rule or not e.path:
            out.append(Finding(
                "R0", _CONFIG_NAME, 0,
                f"allow entry #{i + 1} needs both rule= and path=."))
    return out


def run_lint(repo_root: Optional[str] = None, paths=None,
             cfg: Optional[AeriallintConfig] = None) -> dict:
    """Lint the configured roots (or ``paths``) -> the report dict."""
    repo_root = repo_root or find_repo_root()
    cfg = cfg or load_config()
    files = ([p if os.path.isabs(p) else os.path.join(repo_root, p)
              for p in paths] if paths
             else iter_py_files(repo_root, cfg.roots))
    findings = config_policy_findings(cfg) + lint_files(files, repo_root, cfg)
    open_f = [f for f in findings if f.status == "open"]
    return {
        "tool": "aeriallint.port",
        "roots": list(cfg.roots),
        "files_scanned": len(files),
        "findings": [f.to_json() for f in findings],
        "open": len(open_f),
        "disabled": sum(f.status == "disabled" for f in findings),
        "allowlisted": sum(f.status == "allowlisted" for f in findings),
        "ok": not open_f,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="aeriallint over the port: repo-invariant static "
                    "analysis of repro_torch.")
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: the configured roots)")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable findings report")
    ap.add_argument("-o", "--output", default=None,
                    help="also write the JSON report to this file")
    ap.add_argument("--root", default=None,
                    help="repository root (default: found from this file)")
    args = ap.parse_args(argv)

    report = run_lint(args.root, args.paths or None)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        for f in report["findings"]:
            if f["status"] == "open":
                print(f"{f['path']}:{f['line']}: {f['rule']}: {f['message']}")
        print(f"aeriallint: {report['files_scanned']} files, "
              f"{report['open']} open finding(s), "
              f"{report['disabled']} pragma-disabled, "
              f"{report['allowlisted']} allowlisted.")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
