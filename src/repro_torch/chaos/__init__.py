"""Chaos audits (port of ``repro.chaos``): so far the canonical-content
equivalence check of ``audit.py``. The fault plans and their runner are a
later slice (ROADMAP Queue 1, item 6).
"""

from repro_torch.chaos.audit import assert_content_equal, canonical_content

__all__ = ["assert_content_equal", "canonical_content"]
