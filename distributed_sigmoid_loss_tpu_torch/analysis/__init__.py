"""The port's lint: static analyzers of the distributed-correctness bug
classes the JAX package's ``analysis`` package checks, over the port.

Four halves, one :class:`Finding` stream:

- :mod:`.trace_audit` builds the sampled step configs through the port's
  real builders at tiny shapes, traces one step of each inside a fake
  process group (nothing sent, nothing launched), and checks the trace:
  ring peers, collective groups, double reductions, f64, the chunked loss's
  recompute, bf16 upcasts. :mod:`.shard_flow` adds the dataflow rules:
  redundant gathers, dropped state, the collective order across ranks, the
  error-feedback and codec threading, the gather placement under full
  update sharding.
- :mod:`.config_space` is the declarative feature model of the step-config
  axes: its constraint table, the legal product, and the drift check that
  probes every config through the port's refusal layers.
- :mod:`.repo_lint`: an AST pass over the port's package for repo
  invariants (mutable globals, stale docs, slow markers, record schemas,
  the ledger emit path, the chaos gate).
- :mod:`.lock_flow`: the lock discipline of the threaded host stack
  (guarded-by, lock order, the lockwatch gate).

Run it with ``python -m distributed_sigmoid_loss_tpu_torch lint`` (exit 1
on findings, ``--json``, ``--disable RULE``, ``--no-jaxpr`` for the AST
half alone, ``--full-product``, ``--baseline`` for ratchet mode).
:data:`JAX_RULE_COUNTERPARTS` maps each of the JAX package's rule ids to
the port's rule, or to the reason it has none.
"""

from __future__ import annotations

from distributed_sigmoid_loss_tpu_torch.analysis.findings import Finding
from distributed_sigmoid_loss_tpu_torch.analysis.lock_flow import (
    LOCK_RULES,
    run_lock_flow,
)
from distributed_sigmoid_loss_tpu_torch.analysis.repo_lint import (
    REPO_RULES,
    run_repo_lint,
)

__all__ = [
    "Finding",
    "ALL_RULES",
    "REPO_RULES",
    "LOCK_RULES",
    "TRACE_RULES",
    "CONFIG_RULES",
    "META_RULES",
    "JAX_RULE_COUNTERPARTS",
    "run_lint",
    "run_lock_flow",
    "load_lint_baseline",
    "apply_lint_baseline",
]

# The trace rule ids, written out here (not imported) so that listing the
# rules (the lint command's --disable check) imports no torch. The first six
# are trace_audit's, the last six shard_flow's; the tests pin them against
# those modules' catalogs.
TRACE_RULES = (
    "trace-ppermute-bijection",
    "trace-collective-axis",
    "trace-double-psum",
    "trace-f64",
    "trace-chunk-checkpoint",
    "trace-bf16-upcast",
    "trace-redundant-gather",
    "trace-state-drop",
    "trace-collective-order",
    "trace-ef-threaded",
    "trace-codec-threaded",
    "trace-gather-placement",
)

# config_space's declarative-vs-imperative cross-check.
CONFIG_RULES = ("config-space-drift",)

# Rules about the lint run itself: a --baseline entry that no longer fires.
META_RULES = ("lint-stale-suppression",)

ALL_RULES = REPO_RULES + LOCK_RULES + TRACE_RULES + CONFIG_RULES + META_RULES

# Each rule id of the JAX package's ALL_RULES -> the port's rule id, or the
# reason the port has none.
JAX_RULE_COUNTERPARTS = {
    **{rule: rule for rule in REPO_RULES + LOCK_RULES + CONFIG_RULES + META_RULES},
    "repo-bench-shield": (
        "no counterpart until the port has a bench entry (ROADMAP.md queue A, "
        "ID 7): repo_lint.check_bench_shield is ported and tested on fixtures, "
        "and runs on no file of the port's tree"
    ),
    **{f"jaxpr-{rule[len('trace-'):]}": rule for rule in TRACE_RULES},
    "jaxpr-weak-type": (
        "no counterpart: a torch tensor has no weak type, so a Python scalar "
        "cannot leak one into a step's inputs"
    ),
}


def run_lint(
    disabled=(),
    jaxpr: bool = True,
    n_devices: int | None = None,
    full_product: bool = False,
    device: str = "cpu",
) -> list[Finding]:
    """Run the repo rules, the lock rules, and (unless ``jaxpr=False``, JAX's
    name for the trace half) the config-space drift check and the trace
    audit over the sampled step-config product.

    ``disabled``: rule ids to drop from the result. ``n_devices``: the fake
    world the configs are traced in (default 8). ``full_product``: trace the
    pairwise-covering sample of the whole legal product instead of the
    tier-1 sample. ``device``: where the traced tensors lie (``"cuda"``
    traces tensors without storage on the card)."""
    disabled = set(disabled)
    findings = run_repo_lint(disabled=disabled)
    findings.extend(run_lock_flow(disabled=disabled))
    if jaxpr:
        # Imported here: the AST half stays usable (and fast) without torch.
        from distributed_sigmoid_loss_tpu_torch.analysis.config_space import (
            config_space_drift_findings,
        )
        from distributed_sigmoid_loss_tpu_torch.analysis.trace_audit import (
            audit_default_step_configs,
        )

        if "config-space-drift" not in disabled:
            findings.extend(config_space_drift_findings())
        findings.extend(audit_default_step_configs(
            n_devices=n_devices, full_product=full_product, device=device))
    return [f for f in findings if f.rule not in disabled]


def load_lint_baseline(path) -> list:
    """Parse a ``--baseline`` file: a saved ``lint --json`` report
    (``{"findings": [...]}``) or a bare JSON list of finding dicts. Returns
    ``(rule, subject)`` keys, the identity findings are matched on."""
    import json

    with open(path) as f:
        data = json.load(f)
    entries = data.get("findings", data) if isinstance(data, dict) else data
    keys = []
    for e in entries:
        if not isinstance(e, dict) or "rule" not in e or "subject" not in e:
            raise ValueError(
                f"baseline entry {e!r} needs 'rule' and 'subject' keys "
                "(write one with: lint --json > baseline.json)"
            )
        keys.append((e["rule"], e["subject"]))
    return keys


def apply_lint_baseline(findings: list, baseline_keys: list) -> list:
    """Ratchet mode: drop findings matching a baseline entry; every baseline
    entry that no longer fires becomes a ``lint-stale-suppression`` finding
    (the ratchet only tightens: fixed findings must leave the baseline)."""
    baseline = set(baseline_keys)
    kept = [f for f in findings if f.key() not in baseline]
    fired = {f.key() for f in findings}
    stale = [k for k in baseline_keys if k not in fired]
    for rule, subject in sorted(set(stale)):
        kept.append(
            Finding(
                "lint-stale-suppression",
                subject,
                f"baseline suppresses [{rule}] here but it no longer fires "
                "— remove the entry so the ratchet stays tight",
                location="lint --baseline",
            )
        )
    return kept
