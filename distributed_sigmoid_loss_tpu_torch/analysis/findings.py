"""The one Finding type every lint rule reports through (the port's copy of
the JAX package's ``analysis/findings.py``).

Stdlib only: ``bench_schema`` (imported by the record emitters) and the AST
rules share it without importing torch.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Finding"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint/audit finding.

    ``rule``: the rule id (stable, used by ``lint --disable``).
    ``subject``: what was audited: a step-config label for the trace rules,
    a ``path::name`` for the repo rules.
    ``detail``: what is wrong and why it bites.
    ``location``: where to look: ``path:line`` for repo rules, a
    constraint/refusal source for config rules. Optional; empty when a rule
    has no better anchor than ``subject``.
    """

    rule: str
    subject: str
    detail: str
    location: str = ""

    def __str__(self) -> str:  # the `lint` command's text line
        loc = f" ({self.location})" if self.location else ""
        return f"[{self.rule}] {self.subject}{loc}: {self.detail}"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # Annotators key on rule_id; kept beside the short name so `lint
        # --json` consumers never parse the text line.
        d["rule_id"] = self.rule
        return d

    def key(self) -> tuple[str, str]:
        """Stable identity used by ``lint --baseline`` suppression."""
        return (self.rule, self.subject)
