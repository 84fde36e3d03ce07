"""The AST half of the port's lint (its counterpart of the JAX package's
``analysis/repo_lint.py``): repo invariants that are statically checkable,
over the port's package and files.

- ``repo-mutable-global``: module-level state that a function mutates must
  be allowlisted with a rationale: either a recorder that the records are
  checked against (the ``_DEFAULT_BATCH_HEADS`` class, where a step traced
  before the mutation keeps the other behaviour while its records claim
  otherwise), or host-side state that no step's trace reads.
- ``repo-doc-stale``: every flag of the port's ``cli.py`` and every
  ``LossConfig`` field must appear in ``README.md`` or in a markdown file
  inside the port's package (a flag nobody can find is a flag nobody
  tries).
- ``repo-slow-marker``: the registered multi-minute port suites must carry
  the module-level ``slow`` marker.
- ``repo-bench-record``: every record-field string literal in the port's
  record emitters (``data-bench``, ``serve-bench``) must be registered in
  ``analysis/bench_schema.py``.
- ``repo-metrics-schema``: every train metrics-line / serve ``stats()`` /
  health-event field literal in the emitting modules must be registered in
  ``obs/metrics_schema.py``.
- ``repo-ledger-emit``: an emitter module prints a record
  (``print(json.dumps(...))``) only inside its one emitter function, and
  that function appends to the run ledger (``obs/ledger.py
  append_record``).
- ``repo-chaos-gate``: every fault-injection point in ``serve/`` is a
  ``maybe_inject("<point>")`` call whose point is a string constant
  registered in ``serve/siege.py CHAOS_POINTS`` with a rationale;
  ``maybe_inject`` checks the ``chaos_enabled()`` gate, which keys on the
  ``DSL_CHAOS`` env hook; and no registry row is stale.

:func:`check_bench_shield` is the JAX package's ``repo-bench-shield``
(every flag of a bench entry read by its compile shield or exempt with a
rationale). The port has no bench entry yet, so the rule runs on the
sources it is given and is not part of :func:`run_repo_lint`.

Every check takes explicit source inputs, so that the tests trip each rule
on a bad fixture; the defaults audit the port's tree.
"""

from __future__ import annotations

import ast
import os

from distributed_sigmoid_loss_tpu_torch.analysis.findings import Finding

__all__ = [
    "REPO_RULES",
    "run_repo_lint",
    "check_mutable_globals",
    "check_bench_shield",
    "check_doc_staleness",
    "check_slow_markers",
    "check_bench_record_fields",
    "check_metrics_schema",
    "check_ledger_emit",
    "check_chaos_gate",
    "MUTABLE_GLOBAL_ALLOWLIST",
    "SLOW_REQUIRED_TEST_MODULES",
    "METRICS_SCHEMA_FILES",
    "BENCH_RECORD_EMITTERS",
]

REPO_RULES = (
    "repo-mutable-global",
    "repo-doc-stale",
    "repo-slow-marker",
    "repo-bench-record",
    "repo-metrics-schema",
    "repo-ledger-emit",
    "repo-chaos-gate",
)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PACKAGE_DIR)

# Module-level mutable globals the port accepts, each with its rationale.
# Policy: state that selects a traced behaviour is allowlisted only when a
# recorder exists and the records are checked against it; host-side state
# (build caches, counters, registries) must never change what a step
# computes. Stale entries are findings.
MUTABLE_GLOBAL_ALLOWLIST = {
    "ops/short_attention.py::_DEFAULT_BATCH_HEADS": (
        "kernel choice of the attention backward (K2 or K3); every resolution "
        "is recorded in _TRACED_BWD_BATCH_HEADS and the smoke checks the "
        "launch counts against it"
    ),
    "ops/short_attention.py::_TRACED_BWD_BATCH_HEADS": (
        "is the recorder of _DEFAULT_BATCH_HEADS (appended as steps run; "
        "cleared only by the test-isolation reset)"
    ),
    "ops/streaming_sigmoid_loss.py::_TRACED_LOSS_KERNELS": (
        "recorder of the streaming loss kernel's dispatch (streaming / "
        "streaming_int8 / xla fallback), so that use_pallas is never claimed "
        "while every block fell back (appended as blocks run; cleared only "
        "by the test-isolation reset)"
    ),
    "ops/short_attention.py::_launches": (
        "K1-K3 launch counters: incremented only where a kernel launches, "
        "under the module's _count_lock; read by the smoke's launch pins, "
        "never by a step"
    ),
    "ops/flash_attention.py::_launches": (
        "K7 launch counters: incremented only where a kernel launches, under "
        "_count_lock; read by the smoke's launch pins, never by a step"
    ),
    "ops/attention_f32.py::_launches": (
        "f32 attention launch counters: incremented only where a kernel "
        "launches, under _count_lock; read by the smoke, never by a step"
    ),
    "ops/quant.py::_int_mm_calls": (
        "count of torch._int_mm products, under _count_lock; read by tests "
        "and the smoke, never by a step"
    ),
    "ops/_cuda.py::_loaded": (
        "host-side cache of the loaded kernel libraries (ctypes handles), "
        "filled under the build latch _lock; which library is loaded never "
        "changes what a step computes"
    ),
    "data/native_loader.py::_libs": (
        "host-side build/load cache of the C++ data engine's libraries; data "
        "feeding happens on the host, outside every step"
    ),
    "data/native_decode.py::_failed": (
        "host-side build-failure latch of the libjpeg engine; decode happens "
        "on the host, outside every step"
    ),
    "obs/ledger.py::_FINGERPRINT_CACHE": (
        "host-side memo of the ledger's environment fingerprint (the git sha "
        "subprocess's result); the ledger is an emit path, outside every step"
    ),
    "obs/attribution.py::_REGISTERED": (
        "once-latch of the flop formulas' registration with the flop counter; "
        "the formulas are fixed, so registering them changes no count"
    ),
    "parallel/mesh.py::_GRIDS": (
        "the ambient process-grid stack, pushed and popped by ProcessGrid's "
        "context manager; module-level so that autograd's threads see the "
        "grid the step was entered with"
    ),
    "serve/siege.py::_INJECTORS": (
        "host-side armed-fault registry of the chaos harness, mutated only by "
        "install_fault/clear_faults under _INJECT_LOCK and dead in "
        "production: maybe_inject is gated on DSL_CHAOS (repo-chaos-gate)"
    ),
    "analysis/trace_audit.py::_STEP_CONFIG_CACHE": (
        "host-side per-label memo of the deterministic step-config traces "
        "(the audit, obs/attribution and obs/regress share one sampled "
        "product); it holds trace records, which no step reads"
    ),
}

# The port's test modules whose run takes minutes on one worker: each must
# carry a module-level `pytestmark = pytest.mark.slow`. Empty: no port suite
# is marked slow; a suite that becomes one registers itself here.
SLOW_REQUIRED_TEST_MODULES: tuple = ()

_MUTATING_METHODS = {
    "add", "append", "extend", "update", "clear", "pop", "popitem",
    "remove", "discard", "insert", "setdefault", "appendleft",
}

_MUTABLE_CTORS = {"set", "dict", "list", "deque", "defaultdict", "OrderedDict"}


def _module_level_names(tree: ast.Module) -> set[str]:
    names = set()
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
    return names


def _local_bindings(fn: ast.AST) -> set[str]:
    """Names bound locally in a function (params + assignments), EXCLUDING
    names it declares ``global``."""
    bound, globals_ = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            globals_.update(node.names)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bound.add(t.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                bound.add(node.target.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for a in (
                node.args.args + node.args.posonlyargs + node.args.kwonlyargs
            ):
                bound.add(a.arg)
    return bound - globals_


def _mutated_module_globals(tree: ast.Module) -> dict[str, int]:
    """name -> line of the first detected mutation of a module-level name."""
    module_names = _module_level_names(tree)
    mutable_containers = set()
    for node in tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            target = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            target = node.target.id
        if target is None or node.value is None:
            continue
        v = node.value
        is_container = isinstance(v, (ast.List, ast.Dict, ast.Set)) or (
            isinstance(v, ast.Call)
            and isinstance(v.func, ast.Name)
            and v.func.id in _MUTABLE_CTORS
        )
        if is_container:
            mutable_containers.add(target)

    mutated: dict[str, int] = {}

    def note(name: str, line: int) -> None:
        mutated.setdefault(name, line)

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        declared_global = {
            n for node in ast.walk(fn) if isinstance(node, ast.Global)
            for n in node.names
        }
        local = _local_bindings(fn)
        for node in ast.walk(fn):
            # `global N` + assignment: rebinding a module global from a function.
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in declared_global:
                        note(t.id, node.lineno)
                    # container[k] = v on a module-level container
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in mutable_containers
                        and t.value.id not in local
                    ):
                        note(t.value.id, node.lineno)
            # container.add/append/... on a module-level container
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATING_METHODS
                and isinstance(node.func.value, ast.Name)
            ):
                name = node.func.value.id
                if name in module_names and name in mutable_containers and (
                    name not in local
                ):
                    note(name, node.lineno)
    return mutated


def _iter_package_sources(package_dir: str):
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, package_dir)
            with open(path, encoding="utf-8") as f:
                yield rel, f.read()


def check_mutable_globals(
    sources=None, allowlist=None,
) -> list[Finding]:
    """repo-mutable-global: unallowlisted mutated module-level state.

    ``sources``: ``{relpath: source}`` (default: every package module).
    """
    if sources is None:
        sources = dict(_iter_package_sources(_PACKAGE_DIR))
    allowlist = MUTABLE_GLOBAL_ALLOWLIST if allowlist is None else allowlist
    findings = []
    seen_keys = set()
    for rel, src in sources.items():
        rel = rel.replace(os.sep, "/")
        tree = ast.parse(src)
        for name, line in sorted(_mutated_module_globals(tree).items()):
            key = f"{rel}::{name}"
            seen_keys.add(key)
            if key not in allowlist:
                findings.append(Finding(
                    "repo-mutable-global",
                    key,
                    f"module-level {name!r} is mutated (line {line}) — "
                    "trace-time mutable global state; a step traced before "
                    "the mutation silently keeps the other behavior while "
                    "records claim otherwise (the _DEFAULT_BATCH_HEADS "
                    "class). Either remove it or allowlist it in "
                    "analysis/repo_lint.py with a rationale naming its "
                    "traced-choice recorder",
                ))
    for key in sorted(set(allowlist) - seen_keys):
        findings.append(Finding(
            "repo-mutable-global",
            key,
            "stale allowlist entry: no such mutated module global exists "
            "anymore — drop it so the allowlist stays an honest inventory",
        ))
    return findings


def _argparse_dests(tree: ast.Module) -> dict[str, int]:
    """dest -> lineno for every add_argument call in the module."""
    dests: dict[str, int] = {}
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            and node.args
        ):
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
            continue
        flag = first.value
        dest = flag[2:].replace("-", "_") if flag.startswith("--") else flag
        if dest:
            dests.setdefault(dest, node.lineno)
    return dests


def _argparse_flags(tree: ast.Module) -> dict[str, int]:
    """'--flag' -> lineno for every OPTIONAL add_argument in the module."""
    flags: dict[str, int] = {}
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            and node.args
        ):
            continue
        first = node.args[0]
        if (
            isinstance(first, ast.Constant)
            and isinstance(first.value, str)
            and first.value.startswith("--")
        ):
            flags.setdefault(first.value, node.lineno)
    return flags


def _attr_reads_of(tree: ast.Module, func_name: str, obj: str = "args") -> set[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func_name:
            return {
                n.attr
                for n in ast.walk(node)
                if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == obj
            }
    return set()


def _module_dict_keys(tree: ast.Module, var_name: str) -> set[str]:
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == var_name
            and isinstance(node.value, ast.Dict)
        ):
            return {
                k.value
                for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
    return set()


def check_bench_shield(bench_source: str) -> list[Finding]:
    """repo-bench-shield: every flag of a bench entry (``bench_source``)
    classified as a compile-shield trigger (read by
    ``_fresh_compile_config``) or exempt with a rationale
    (``_SHIELD_EXEMPT_FLAGS``), enumerated from its argparse tree. The port
    has no bench entry yet, so there is no default source."""
    tree = ast.parse(bench_source)
    dests = _argparse_dests(tree)
    reads = _attr_reads_of(tree, "_fresh_compile_config")
    exempt = _module_dict_keys(tree, "_SHIELD_EXEMPT_FLAGS")
    findings = []
    if not reads:
        findings.append(Finding(
            "repo-bench-shield", "bench.py::_fresh_compile_config",
            "no _fresh_compile_config function found (or it reads no args) — "
            "the compile shield has no trigger set",
        ))
    for dest, line in sorted(dests.items()):
        if dest not in reads and dest not in exempt:
            findings.append(Finding(
                "repo-bench-shield",
                f"bench.py::{dest}",
                f"flag --{dest.replace('_', '-')} (line {line}) is neither "
                "read by _fresh_compile_config nor listed in "
                "_SHIELD_EXEMPT_FLAGS: a config-changing flag outside the "
                "shield runs fresh compiles unprotected (the "
                "--gradcache-bf16 class). Classify it.",
            ))
    for dest in sorted(exempt - set(dests)):
        findings.append(Finding(
            "repo-bench-shield",
            f"bench.py::{dest}",
            "_SHIELD_EXEMPT_FLAGS names a flag that is not in the argparse "
            "tree — stale exemption; drop it",
        ))
    for dest in sorted(exempt & reads):
        findings.append(Finding(
            "repo-bench-shield",
            f"bench.py::{dest}",
            "flag is BOTH a _fresh_compile_config trigger and exempt — "
            "contradictory classification; pick one",
        ))
    return findings


def _package_markdown() -> list[str]:
    """The markdown files inside the port's package, sorted."""
    out = []
    for dirpath, dirnames, filenames in os.walk(_PACKAGE_DIR):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, fn) for fn in sorted(filenames) if fn.endswith(".md")]
    return out


def check_doc_staleness(
    cli_source: str | None = None,
    config_source: str | None = None,
    docs_text: str | None = None,
) -> list[Finding]:
    """repo-doc-stale: the port's CLI flags and LossConfig fields must
    appear in README.md or in a markdown file inside the port's package
    (``docs/`` describes the JAX package)."""
    if cli_source is None:
        with open(os.path.join(_PACKAGE_DIR, "cli.py"), encoding="utf-8") as f:
            cli_source = f.read()
    if config_source is None:
        with open(os.path.join(_PACKAGE_DIR, "utils", "config.py"), encoding="utf-8") as f:
            config_source = f.read()
    if docs_text is None:
        chunks = []
        for path in [os.path.join(_REPO_ROOT, "README.md")] + _package_markdown():
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    chunks.append(f.read())
        docs_text = "\n".join(chunks)

    findings = []
    cli_tree = ast.parse(cli_source)
    for flag, line in sorted(_argparse_flags(cli_tree).items()):
        # Positionals (e.g. `export out`) are visible in --help usage strings;
        # only true --flags are held to the doc rule.
        if flag not in docs_text:
            findings.append(Finding(
                "repo-doc-stale",
                f"cli.py::{flag}",
                f"CLI flag {flag} (line {line}) appears in no README.md or "
                "markdown file of the package — undocumented surface goes "
                "untried and rots; add a line where the subcommand is "
                "documented",
            ))
    cfg_tree = ast.parse(config_source)
    for node in ast.walk(cfg_tree):
        if isinstance(node, ast.ClassDef) and node.name == "LossConfig":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    field = stmt.target.id
                    if field not in docs_text:
                        findings.append(Finding(
                            "repo-doc-stale",
                            f"LossConfig.{field}",
                            f"LossConfig field {field!r} appears in no "
                            "README.md or markdown file of the package",
                        ))
    return findings


def check_slow_markers(
    sources=None, required=None,
) -> list[Finding]:
    """repo-slow-marker: registered multi-minute suites carry the module-level
    slow pytestmark (the time-boxed test run's structural guard)."""
    required = SLOW_REQUIRED_TEST_MODULES if required is None else required
    if sources is None:
        sources = {}
        tests_dir = os.path.join(_REPO_ROOT, "tests")
        for fn in required:
            path = os.path.join(tests_dir, fn)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    sources[fn] = f.read()
            else:
                sources[fn] = None
    findings = []
    for fn in required:
        src = sources.get(fn)
        if src is None:
            findings.append(Finding(
                "repo-slow-marker", f"tests/{fn}",
                "registered as slow-required but the file does not exist — "
                "update SLOW_REQUIRED_TEST_MODULES",
            ))
            continue
        tree = ast.parse(src)
        if not _has_module_slow_mark(tree):
            findings.append(Finding(
                "repo-slow-marker", f"tests/{fn}",
                "multi-minute suite without a module-level `pytestmark = "
                "pytest.mark.slow` — it would land inside the time-boxed "
                "test run and blow its budget",
            ))
    return findings


def _has_module_slow_mark(tree: ast.Module) -> bool:
    def is_slow_mark(node) -> bool:
        # pytest.mark.slow, possibly wrapped: pytest.mark.slow / mark.slow
        return (
            isinstance(node, ast.Attribute)
            and node.attr == "slow"
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "mark"
        )

    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "pytestmark"
            for t in node.targets
        ):
            v = node.value
            elems = v.elts if isinstance(v, (ast.List, ast.Tuple)) else [v]
            if any(is_slow_mark(e) for e in elems):
                return True
            # pytest.mark.skipif(...) etc: calls wrapping a mark — check func
            if any(
                isinstance(e, ast.Call) and is_slow_mark(e.func) for e in elems
            ):
                return True
    return False


# The port's record emitters: module (package-relative) -> (the function
# that validates, prints and ledgers a record, the part of the module that
# emits records: the top-level functions whose names hold this string, ""
# for the whole module). repo-bench-record audits the record fields of those
# parts, repo-ledger-emit their prints; cli.py's other commands print other
# JSON (lint reports, export summaries), which are not records.
BENCH_RECORD_EMITTERS = {
    "data/data_bench.py": ("_emit_record", ""),
    "cli.py": ("_emit_serve_record", "serve"),
}


def _emitting_part(tree: ast.Module, scope: str) -> ast.Module:
    """The top-level functions of ``tree`` whose names hold ``scope`` (all
    of ``tree`` when it is empty)."""
    if not scope:
        return tree
    body = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and scope in n.name]
    return ast.Module(body=body, type_ignores=[])


def _read_package_sources(rels) -> dict:
    out = {}
    for rel in rels:
        with open(os.path.join(_PACKAGE_DIR, rel.replace("/", os.sep)), encoding="utf-8") as f:
            out[rel] = f.read()
    return out


def check_bench_record_fields(sources=None) -> list[Finding]:
    """repo-bench-record: record-field string literals in the record
    emitters (``{relpath: source}``, default :data:`BENCH_RECORD_EMITTERS`'
    modules, their emitting parts) are all registered in the shared schema
    (analysis/bench_schema.py): the dicts bound to ``record``, subscript
    assigns onto it, and dict literals passed to an emitter or to
    ``json.dumps``."""
    from distributed_sigmoid_loss_tpu_torch.analysis.bench_schema import (
        BENCH_RECORD_FIELDS,
    )

    if sources is None:
        sources = _read_package_sources(BENCH_RECORD_EMITTERS)
    emit_names = {"dumps"} | {fn for fn, _ in BENCH_RECORD_EMITTERS.values()}
    findings = []
    for rel, src in sorted(sources.items()):
        tree = _emitting_part(ast.parse(src), BENCH_RECORD_EMITTERS.get(rel, ("", ""))[1])

        def check_keys(keys, line, rel=rel) -> None:
            for k in keys:
                if k not in BENCH_RECORD_FIELDS:
                    findings.append(Finding(
                        "repo-bench-record",
                        f"{rel}::{k}",
                        f"record field {k!r} (line {line}) is not registered in "
                        "analysis/bench_schema.py BENCH_RECORD_FIELDS — "
                        "unregistered fields drift per emit path; register it "
                        "(and document it if it encodes a new config knob)",
                    ))

        def dict_keys(d: ast.Dict) -> list[str]:
            return [k.value for k in d.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)]

        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Name) and t.id == "record"
                            and isinstance(node.value, ast.Dict)):
                        check_keys(dict_keys(node.value), node.lineno)
                    if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                            and t.value.id == "record" and isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)):
                        check_keys([t.slice.value], node.lineno)
            if isinstance(node, ast.Call):
                fname = None
                if isinstance(node.func, ast.Name):
                    fname = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    fname = node.func.attr
                if fname in emit_names and node.args and isinstance(node.args[0], ast.Dict):
                    check_keys(dict_keys(node.args[0]), node.lineno)
    return findings


_METRIC_DICT_NAMES = {"metrics", "line", "snap"}

# The modules whose metric-field literals repo-metrics-schema audits, and the
# registry (obs/metrics_schema.py) each validates against. Package-relative
# paths; a module emitting a NEW record stream registers itself here.
METRICS_SCHEMA_FILES = {
    "train/train_step.py": "train",
    "train/compressed_step.py": "train",
    "cli.py": "train",
    "serve/service.py": "serve",
    "serve/admission.py": "serve",
    "serve/fleet/leases.py": "serve",
    "serve/fleet/router.py": "serve",
    "serve/fleet/waves.py": "serve",
    "obs/health.py": "health",
}


def _metric_literals(tree: ast.Module) -> list[tuple[str, int]]:
    """(field, lineno) for every metric-field string literal in a module:
    dict literals bound to the conventional record names (``metrics`` /
    ``line`` / ``snap``), subscript-assigns onto them, dict literals passed
    to ``.log(step, {...})`` / ``.write({...})``, and the dict a function
    named ``record`` returns (the HealthEvent convention). Dynamic keys
    (f-strings like ``eval/{k}``) are invisible to AST and covered by the
    registered prefixes at emit time instead."""
    out: list[tuple[str, int]] = []

    def take(d: ast.Dict, line: int) -> None:
        for k in d.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                out.append((k.value, line))

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, ast.Name)
                    and t.id in _METRIC_DICT_NAMES
                    and isinstance(node.value, ast.Dict)
                ):
                    take(node.value, node.lineno)
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in _METRIC_DICT_NAMES
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                ):
                    out.append((t.slice.value, node.lineno))
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            if (
                node.func.attr == "log"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Dict)
            ):
                take(node.args[1], node.lineno)
            elif (
                node.func.attr == "write"
                and node.args
                and isinstance(node.args[0], ast.Dict)
            ):
                take(node.args[0], node.lineno)
        elif isinstance(node, ast.FunctionDef) and node.name == "record":
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Return) and isinstance(
                    stmt.value, ast.Dict
                ):
                    take(stmt.value, stmt.lineno)
    return out


def check_metrics_schema(sources=None, files=None) -> list[Finding]:
    """repo-metrics-schema: metric-field literals in the emitting modules are
    all registered in obs/metrics_schema.py (train lines / serve stats /
    health events — the repo-bench-record discipline for the other two
    record streams)."""
    from distributed_sigmoid_loss_tpu_torch.obs.metrics_schema import (
        HEALTH_EVENT_FIELDS,
        SERVE_STATS_FIELDS,
        TRAIN_METRICS_FIELDS,
        TRAIN_METRICS_PREFIXES,
    )

    schemas = {
        "train": (TRAIN_METRICS_FIELDS, TRAIN_METRICS_PREFIXES),
        "serve": (SERVE_STATS_FIELDS, ()),
        "health": (HEALTH_EVENT_FIELDS, ()),
    }
    files = METRICS_SCHEMA_FILES if files is None else files
    if sources is None:
        sources = {}
        for rel in files:
            path = os.path.join(_PACKAGE_DIR, rel.replace("/", os.sep))
            with open(path, encoding="utf-8") as f:
                sources[rel] = f.read()
    findings = []
    for rel, kind in files.items():
        src = sources.get(rel)
        if src is None:
            continue
        fields, prefixes = schemas[kind]
        for field_name, line in _metric_literals(ast.parse(src)):
            if field_name in fields:
                continue
            if any(field_name.startswith(p) for p in prefixes):
                continue
            findings.append(Finding(
                "repo-metrics-schema",
                f"{rel}::{field_name}",
                f"metric field {field_name!r} (line {line}) is not "
                f"registered in obs/metrics_schema.py ({kind} schema) — "
                "undeclared fields drift per emit path and are invisible "
                "to downstream parsers; register it (and document it in "
                "README.md if it encodes a new signal)",
            ))
    return findings


def _json_record_prints(tree: ast.Module) -> dict[str, list[int]]:
    """function_name -> lines where ``print(json.dumps(...))`` (or
    ``print(dumps(...))``) occurs — the record-emit signature the ledger rule
    keys on. Module-level prints land under the pseudo-name ``<module>``."""

    def is_dumps(call: ast.AST) -> bool:
        if not isinstance(call, ast.Call):
            return False
        f = call.func
        return (isinstance(f, ast.Attribute) and f.attr == "dumps") or (
            isinstance(f, ast.Name) and f.id == "dumps"
        )

    out: dict[str, list[int]] = {}

    def visit(node: ast.AST, owner: str) -> None:
        for child in ast.iter_child_nodes(node):
            name = owner
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Name)
                and child.func.id == "print"
                and child.args
                and is_dumps(child.args[0])
            ):
                out.setdefault(owner, []).append(child.lineno)
            visit(child, name)

    visit(tree, "<module>")
    return out


def check_ledger_emit(sources=None, emitters=None) -> list[Finding]:
    """repo-ledger-emit: every record print of an emitter module routes
    through its one ledger-appending emitter.

    Two statically checkable halves, per module of ``emitters`` (default
    :data:`BENCH_RECORD_EMITTERS`, module -> (emitter function, emitting
    part)): (a) the
    emitter calls the ledger append (``append_record``); (b) no
    ``print(json.dumps(...))`` appears outside it — a path printing its own
    JSON bypasses the ledger and the schema check.
    """
    emitters = BENCH_RECORD_EMITTERS if emitters is None else emitters
    if sources is None:
        sources = _read_package_sources(emitters)
    findings = []
    for rel, (emitter, scope) in sorted(emitters.items()):
        src = sources.get(rel)
        if src is None:
            continue
        tree = _emitting_part(ast.parse(src), scope)
        emit_fns = [node for node in ast.walk(tree)
                    if isinstance(node, ast.FunctionDef) and node.name == emitter]
        if not emit_fns:
            findings.append(Finding(
                "repo-ledger-emit", f"{rel}::{emitter}",
                f"no {emitter} function found — {rel} has no single schema-"
                "checking, ledger-appending emit path",
            ))
        elif not _calls_name(emit_fns[0], "append_record"):
            findings.append(Finding(
                "repo-ledger-emit", f"{rel}::{emitter}",
                f"{emitter} does not call obs.ledger append_record — records "
                "print to stdout but never enter the run's trajectory",
            ))
        for owner, lines in sorted(_json_record_prints(tree).items()):
            if owner == emitter:
                continue
            for line in lines:
                findings.append(Finding(
                    "repo-ledger-emit", f"{rel}::{owner}",
                    f"print(json.dumps(...)) at line {line} outside {emitter} — a "
                    "record emit path bypassing the ledger append (and the "
                    f"schema check); route it through {emitter}",
                ))
    return findings


def _chaos_registry(tree: ast.Module) -> dict[str, str] | None:
    """CHAOS_POINTS {point: rationale} from siege's module body (string
    constants only), or None when the dict is missing entirely."""
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "CHAOS_POINTS"
            and isinstance(node.value, ast.Dict)
        ):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                rationale = ""
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    rationale = v.value
                elif isinstance(v, ast.JoinedStr):
                    rationale = "<dynamic>"
                out[k.value] = rationale
            return out
    return None


def _maybe_inject_calls(tree: ast.Module) -> list[tuple[str | None, int]]:
    """(point-or-None, lineno) for every maybe_inject(...) call; None marks
    a non-constant point argument (unauditable — itself a finding)."""
    calls = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None
        )
        if name != "maybe_inject":
            continue
        point = None
        if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
            node.args[0].value, str
        ):
            point = node.args[0].value
        calls.append((point, node.lineno))
    return calls


def _calls_name(fn: ast.AST, target: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == target:
                return True
            if isinstance(f, ast.Attribute) and f.attr == target:
                return True
    return False


def check_chaos_gate(
    siege_source: str | None = None, serve_sources=None,
) -> list[Finding]:
    """repo-chaos-gate: fault injection provably dead in production paths.

    Four statically-checkable halves: (a) ``maybe_inject`` must check the
    ``chaos_enabled()`` gate before any fault can fire, and ``chaos_enabled``
    must key on the ``DSL_CHAOS`` env hook; (b) every point in
    ``CHAOS_POINTS`` carries a non-empty rationale; (c) every
    ``maybe_inject(...)`` call site in serve/ names a registered point with
    a STRING CONSTANT (a computed point is unauditable); (d) no registry row
    is stale — a registered point nobody calls is a drill that silently
    stopped existing.
    """
    serve_dir = os.path.join(_PACKAGE_DIR, "serve")
    if siege_source is None:
        with open(
            os.path.join(serve_dir, "siege.py"), encoding="utf-8"
        ) as f:
            siege_source = f.read()
    if serve_sources is None:
        serve_sources = {
            f"serve/{rel}": src
            for rel, src in _iter_package_sources(serve_dir)
        }
    findings = []
    siege_tree = ast.parse(siege_source)

    # (a) the gate itself.
    fns = {
        node.name: node
        for node in ast.walk(siege_tree)
        if isinstance(node, ast.FunctionDef)
    }
    if "maybe_inject" not in fns:
        findings.append(Finding(
            "repo-chaos-gate", "serve/siege.py::maybe_inject",
            "no maybe_inject function found — the chaos harness has no "
            "gated injection entry point",
        ))
    elif not _calls_name(fns["maybe_inject"], "chaos_enabled"):
        findings.append(Finding(
            "repo-chaos-gate", "serve/siege.py::maybe_inject",
            "maybe_inject does not check chaos_enabled() — an armed fault "
            "would fire in production without the DSL_CHAOS hook; gate it",
        ))
    if "chaos_enabled" not in fns:
        findings.append(Finding(
            "repo-chaos-gate", "serve/siege.py::chaos_enabled",
            "no chaos_enabled function found — nothing defines the "
            "DSL_CHAOS gate",
        ))
    else:
        reads_hook = any(
            isinstance(n, ast.Constant) and n.value == "DSL_CHAOS"
            for n in ast.walk(fns["chaos_enabled"])
        )
        if not reads_hook:
            findings.append(Finding(
                "repo-chaos-gate", "serve/siege.py::chaos_enabled",
                "chaos_enabled does not reference the 'DSL_CHAOS' env hook "
                "— the documented production off-switch is not what the "
                "gate actually checks",
            ))

    # (b) the registry + rationales.
    registry = _chaos_registry(siege_tree)
    if registry is None:
        findings.append(Finding(
            "repo-chaos-gate", "serve/siege.py::CHAOS_POINTS",
            "no CHAOS_POINTS dict found — injection points have no "
            "registered inventory",
        ))
        registry = {}
    for point, rationale in sorted(registry.items()):
        if not rationale.strip():
            findings.append(Finding(
                "repo-chaos-gate", f"serve/siege.py::{point}",
                f"chaos point {point!r} has no rationale — the registry "
                "must say which failure mode the drill exists for",
            ))

    # (c) every call site names a registered constant point.
    called: set[str] = set()
    for rel in sorted(serve_sources):
        for point, line in _maybe_inject_calls(ast.parse(serve_sources[rel])):
            if rel.endswith("siege.py"):
                continue  # the definition module, not an injection site
            if point is None:
                findings.append(Finding(
                    "repo-chaos-gate", f"{rel}::maybe_inject",
                    f"maybe_inject call at line {line} passes a computed "
                    "point — unauditable; injection points must be string "
                    "constants registered in CHAOS_POINTS",
                ))
                continue
            called.add(point)
            if point not in registry:
                findings.append(Finding(
                    "repo-chaos-gate", f"{rel}::{point}",
                    f"maybe_inject({point!r}) at line {line} is not "
                    "registered in serve/siege.py CHAOS_POINTS — register "
                    "it with a rationale (ungated/undocumented injection "
                    "points are exactly what this rule exists to prevent)",
                ))

    # (d) stale registry rows.
    for point in sorted(set(registry) - called):
        findings.append(Finding(
            "repo-chaos-gate", f"serve/siege.py::{point}",
            f"chaos point {point!r} is registered but no serve/ module "
            "calls maybe_inject with it — stale inventory row; drop it or "
            "wire the drill back in",
        ))
    return findings


def run_repo_lint(disabled=()) -> list[Finding]:
    """Run every repo rule against the port's tree (``repo-bench-shield``
    waits for the port's bench entry)."""
    checks = {
        "repo-mutable-global": check_mutable_globals,
        "repo-doc-stale": check_doc_staleness,
        "repo-slow-marker": check_slow_markers,
        "repo-bench-record": check_bench_record_fields,
        "repo-metrics-schema": check_metrics_schema,
        "repo-ledger-emit": check_ledger_emit,
        "repo-chaos-gate": check_chaos_gate,
    }
    findings: list[Finding] = []
    for rule, fn in checks.items():
        if rule not in disabled:
            findings.extend(fn())
    return findings
