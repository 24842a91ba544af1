"""Layout handlers (DM transposes, identity, reshape, concat) — port of
``src/repro/core/runtime/shape.py``.  None of them is on b4's path; they
come with the slices that run them (ROADMAP queue 1 item 2)."""
from __future__ import annotations

from repro_torch.core.runtime.registry import not_ported, register_op

register_op("transpose", "identity")(not_ported(
    "DM layout ops", "ROADMAP queue 1 item 2: b3/b5"))
register_op("reshape")(not_ported("reshape", "ROADMAP queue 1 item 2"))
register_op("concat")(not_ported("concat", "ROADMAP queue 1 item 2: b1"))
