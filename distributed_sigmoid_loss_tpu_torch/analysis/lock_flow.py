"""Lock-discipline static analysis of the port's threaded host stack (its
counterpart of the JAX package's ``analysis/lock_flow.py``, with JAX's
rules). All pure AST; every check takes explicit sources, so the tests trip
each rule on a bad fixture, and the defaults audit the port's package:

- ``lock-unguarded-write``: for every class owning a ``Lock``/``RLock``/
  ``Condition`` (raw or through the ``named_lock`` family), the attributes
  mutated inside ``with self._lock`` blocks form its guarded set; any
  mutation of a guarded attribute outside the lock (``__init__``
  exempt) is a finding. Plain reads are not: lock-free snapshot reads of
  atomically published references are a deliberate idiom.
- ``lock-wait-no-loop``: a ``Condition.wait()`` outside a ``while``
  predicate loop (``wait_for`` carries its own loop).
- ``lock-blocking-hold``: a blocking call (``Future.result``, pipe
  ``recv``/``poll``, ``join``, queue ``get``/``put``, ``sleep``) made while
  holding a lock. JAX's list adds its dispatch calls (``block_until_ready``,
  ``device_put``, ``device_get``), which the port does not have.
- ``lock-orphan-thread``: a ``threading.Thread`` started with no join.
- ``lock-order-cycle``: a cycle in the lock-acquisition graph built from
  lexically nested ``with`` statements over distinct owned locks. The
  runtime half, orders no AST can see, is ``obs/lockwatch.py``'s witness
  (``DSL_LOCKWATCH=1``).

Plus ``repo-lockwatch-gate``: the witness is dead in production (the
``named_lock`` factories consult ``lockwatch_enabled()``, which keys on
``DSL_LOCKWATCH``); every call site passes a registered string-constant
name; registry rows carry rationales and none is stale; and no module
constructs ``threading.Lock/RLock/Condition`` directly outside
``obs/lockwatch.py`` unless :data:`RAW_LOCK_ALLOWLIST` says why.

Findings suppressed by :data:`LOCK_ALLOWLIST` need a rationale; stale
entries are findings.
"""

from __future__ import annotations

import ast
import os
import re

from distributed_sigmoid_loss_tpu_torch.analysis.findings import Finding
from distributed_sigmoid_loss_tpu_torch.analysis.repo_lint import (
    _iter_package_sources,
)

__all__ = [
    "LOCK_RULES",
    "LOCK_ALLOWLIST",
    "RAW_LOCK_ALLOWLIST",
    "run_lock_flow",
    "analyze_lock_flow",
    "check_lock_order",
    "check_lockwatch_gate",
    "lock_order_edges",
]

LOCK_RULES = (
    "lock-unguarded-write",
    "lock-wait-no-loop",
    "lock-blocking-hold",
    "lock-orphan-thread",
    "lock-order-cycle",
    "repo-lockwatch-gate",
)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Findings the port accepts, keyed "<rule>::<subject>", each with its
# rationale. Policy (JAX's): a blocking hold only when the lock IS the
# serialization contract of the blocking resource itself; an unguarded write
# only when the attribute is published atomically by a single writer and
# every reader tolerates either value. Stale entries are findings.
LOCK_ALLOWLIST = {
    "lock-blocking-hold::serve/siege.py::EngineProcess.call": (
        "the Pipe IS the serialized resource: one request/response exchange "
        "per child at a time is the contract, so send, poll(timeout), recv "
        "stay inside _lock; poll carries the deadline that bounds the hold, "
        "and a second caller blocking on _lock is the intended queueing"
    ),
}

# Raw threading.Lock/RLock/Condition constructions repo-lockwatch-gate
# tolerates outside obs/lockwatch.py, keyed "<relpath>::<scope>", each with
# its rationale. Stale entries are findings.
RAW_LOCK_ALLOWLIST: dict[str, str] = {
    "ops/_cuda.py::<module>": (
        "the kernel build latch: held across nvcc, it serializes the build "
        "and load of each library; the ops layer imports nothing of obs "
        "(named_lock's module), and no other lock is taken under it"
    ),
    "ops/short_attention.py::<module>": (
        "the K1-K3 launch counters' lock: held for one increment or read, "
        "never across another lock, on the launch path of every kernel"
    ),
    "ops/flash_attention.py::<module>": (
        "the K7 launch counters' lock: held for one increment or read, never "
        "across another lock"
    ),
    "ops/attention_f32.py::<module>": (
        "the f32 attention launch counters' lock: held for one increment or "
        "read, never across another lock"
    ),
    "ops/streaming_sigmoid_loss.py::<module>": (
        "the K4-K6 launch counters' lock: held for one increment or read, "
        "never across another lock"
    ),
    "ops/quant.py::<module>": (
        "the torch._int_mm call counter's lock: held for one increment or "
        "read, never across another lock"
    ),
}

_LOCK_FACTORIES = {"Lock", "RLock", "named_lock", "named_rlock"}
_CONDITION_FACTORIES = {"Condition", "named_condition"}
_ALL_LOCK_FACTORIES = _LOCK_FACTORIES | _CONDITION_FACTORIES

_MUTATING_METHODS = {
    "add", "append", "extend", "update", "clear", "pop", "popitem",
    "remove", "discard", "insert", "setdefault", "appendleft",
    "move_to_end",
}

# Calls that block the calling thread: flagged whenever an owned lock is
# held. `join` skips str.join (constant receiver) and os.path.join;
# `get`/`put` only fire on queue-ish receivers (`q`/`queue`/`*_q[ueue]`) so
# dict.get stays silent; `wait` on a HELD lock/condition is the legitimate
# Condition.wait (releases what it holds) and is exempt.
_BLOCKING_SIMPLE = {"result", "recv", "poll", "sleep"}
_QUEUEISH = re.compile(r"(^|_)(q|queue)$", re.IGNORECASE)


def _call_name(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _self_attr(expr: ast.AST) -> str | None:
    """'attr' when expr is exactly ``self.attr``."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


def _self_attr_base(expr: ast.AST) -> str | None:
    """The first-level attribute a self-rooted expression hangs off:
    ``self._versions[v].x`` → '_versions' (mutating any part of an owned
    structure is a mutation of the owning attribute)."""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        got = _self_attr(expr)
        if got is not None:
            return got
        expr = expr.value
    return None


def _terminal_name(expr: ast.AST) -> str | None:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


class _ModuleScan:
    """One module's lock-flow facts, collected in a single AST pass."""

    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        # (rule, subject, detail) rows; order-graph edges separately.
        self.findings: list[Finding] = []
        self.order_edges: set[tuple[str, str]] = set()
        # Module-level locks: name -> lock id.
        self.module_locks: dict[str, str] = {}
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and _call_name(node.value) in _ALL_LOCK_FACTORIES
            ):
                name = node.targets[0].id
                self.module_locks[name] = f"{rel}::{name}"
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._scan_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(node, owner=node.name)

    # -- class analysis ------------------------------------------------------

    def _scan_class(self, cls: ast.ClassDef) -> None:
        rel = self.rel
        lock_attrs: set[str] = set()
        cond_attrs: set[str] = set()
        methods = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for m in methods:
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    fac = _call_name(node.value)
                    if fac not in _ALL_LOCK_FACTORIES:
                        continue
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        lock_attrs.add(attr)
                        if fac in _CONDITION_FACTORIES:
                            cond_attrs.add(attr)
        thread_attrs: dict[str, int] = {}
        joined_attrs: set[str] = set()
        # mutations: (attr, method, line, guarded)
        mutations: list[tuple[str, str, int, bool]] = []

        for m in methods:
            self._scan_function(
                m,
                owner=f"{cls.name}.{m.name}",
                cls_name=cls.name,
                lock_attrs=lock_attrs,
                cond_attrs=cond_attrs,
                mutations=mutations,
                mutations_method=m.name,
                thread_attrs=thread_attrs,
                joined_attrs=joined_attrs,
            )

        guarded = {
            attr for attr, _m, _l, held in mutations
            if held and attr not in lock_attrs
        }
        for attr, method, line, held in mutations:
            if held or attr not in guarded or method == "__init__":
                continue
            self.findings.append(Finding(
                "lock-unguarded-write",
                f"{rel}::{cls.name}.{attr}",
                f"{cls.name}.{method} writes self.{attr} (line {line}) "
                f"without the lock that guards it elsewhere in the class — "
                "a torn/lost update under the serving stack's thread churn "
                "(the token-bucket class). Take the lock, or "
                "allowlist with a single-atomic-writer rationale in "
                "analysis/lock_flow.py",
            ))
        for attr, line in sorted(thread_attrs.items()):
            if attr in joined_attrs:
                continue
            self.findings.append(Finding(
                "lock-orphan-thread",
                f"{rel}::{cls.name}.{attr}",
                f"thread self.{attr} (line {line}) is never joined by any "
                f"method of {cls.name} — no close path means shutdown "
                "races the thread and tests leak it across suites; join "
                "it in close()/stop()",
            ))

    # -- function-level walk -------------------------------------------------

    def _scan_function(
        self,
        fn,
        *,
        owner: str,
        cls_name: str | None = None,
        lock_attrs: set[str] | None = None,
        cond_attrs: set[str] | None = None,
        mutations: list | None = None,
        mutations_method: str | None = None,
        thread_attrs: dict | None = None,
        joined_attrs: set | None = None,
    ) -> None:
        rel = self.rel
        lock_attrs = lock_attrs or set()
        cond_attrs = cond_attrs or set()
        blocking_seen: set[tuple[str, str, int]] = set()

        # Function-local locks (incl. ones closures inherit lexically).
        local_locks: dict[str, str] = {}

        def note_local_locks(f) -> None:
            for node in ast.walk(f):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and _call_name(node.value) in _ALL_LOCK_FACTORIES
                ):
                    name = node.targets[0].id
                    local_locks.setdefault(
                        name, f"{rel}::{owner}.{name}"
                    )

        note_local_locks(fn)

        fn_has_join = [False]
        fn_makes_thread: list[int] = []

        def lock_ref(expr: ast.AST):
            """(kind, key, lock_id) for an expression naming an owned lock."""
            attr = _self_attr(expr)
            if attr is not None and attr in lock_attrs:
                return ("self", attr, f"{rel}::{cls_name}.{attr}")
            if isinstance(expr, ast.Name):
                if expr.id in local_locks:
                    return ("name", expr.id, local_locks[expr.id])
                if expr.id in self.module_locks:
                    return ("name", expr.id, self.module_locks[expr.id])
            return None

        def note_mutation(attr: str, line: int, held) -> None:
            if mutations is not None and attr not in lock_attrs:
                mutations.append(
                    (attr, mutations_method or owner, line,
                     any(h[0] == "self" for h in held))
                )

        def visit(node: ast.AST, held: tuple, in_while: bool) -> None:
            for child in ast.iter_child_nodes(node):
                dispatch(child, held, in_while)

        def dispatch(child: ast.AST, held: tuple, in_while: bool) -> None:
            # Handle ONE node, then recurse. Bodies of with/while are fed
            # back through dispatch (not bare visit) so a statement that is
            # the direct child of a with body — the common `with self._lock:
            # self._n += 1` shape — still gets its own Assign/Call handling.
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                # A nested def/lambda body does not run under the
                # enclosing lexical lock hold (it runs whenever it is
                # CALLED — often on another thread).
                visit(child, (), False)
                return
            if isinstance(child, (ast.With, ast.AsyncWith)):
                cur = held
                for item in child.items:
                    dispatch(item.context_expr, held, in_while)
                    ref = lock_ref(item.context_expr)
                    if ref is None:
                        continue
                    for h in cur:
                        if h[2] != ref[2]:
                            self.order_edges.add((h[2], ref[2]))
                    cur = cur + (ref,)
                for stmt in child.body:
                    dispatch(stmt, cur, in_while)
                return
            if isinstance(child, ast.While):
                dispatch(child.test, held, in_while)
                for stmt in child.body + child.orelse:
                    dispatch(stmt, held, True)
                return

            if isinstance(child, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    child.targets if isinstance(child, ast.Assign)
                    else [child.target]
                )
                value_is_thread = (
                    isinstance(getattr(child, "value", None), ast.Call)
                    and _call_name(child.value) == "Thread"
                )
                for t in targets:
                    base = _self_attr_base(t)
                    if base is not None:
                        note_mutation(base, child.lineno, held)
                        if value_is_thread and thread_attrs is not None:
                            thread_attrs.setdefault(base, child.lineno)

            if isinstance(child, ast.Call):
                self._visit_call(
                    child, held, in_while, owner=owner,
                    cls_name=cls_name, cond_attrs=cond_attrs,
                    note_mutation=note_mutation,
                    joined_attrs=joined_attrs,
                    fn_has_join=fn_has_join,
                    fn_makes_thread=fn_makes_thread,
                    blocking_seen=blocking_seen,
                )

            visit(child, held, in_while)

        dispatch(fn, (), False)

        # Function-local orphan threads: a function that constructs a
        # Thread but contains no .join anywhere (self-attribute threads are
        # judged class-wide above instead).
        if (
            cls_name is None
            and fn_makes_thread
            and not fn_has_join[0]
        ):
            self.findings.append(Finding(
                "lock-orphan-thread",
                f"{rel}::{owner}",
                f"{owner} starts a thread (line {fn_makes_thread[0]}) but "
                "contains no join — no close path; join it (bounded) "
                "before returning, or hand ownership to an object with a "
                "close()",
            ))

    def _visit_call(
        self, call: ast.Call, held: tuple, in_while: bool, *, owner,
        cls_name, cond_attrs, note_mutation, joined_attrs, fn_has_join,
        fn_makes_thread, blocking_seen,
    ) -> None:
        rel = self.rel
        name = _call_name(call)
        if name == "Thread":
            fn_makes_thread.append(call.lineno)
        if name is None or not isinstance(call.func, ast.Attribute):
            return
        recv = call.func.value
        base = _self_attr_base(recv)

        # Mutating-method calls on owned structures.
        if name in _MUTATING_METHODS and base is not None:
            note_mutation(base, call.lineno, held)

        if name == "join":
            fn_has_join[0] = True
            if base is not None and joined_attrs is not None:
                joined_attrs.add(base)

        # Condition.wait outside a predicate loop.
        attr = _self_attr(recv)
        if (
            name == "wait"
            and attr is not None
            and attr in cond_attrs
            and not in_while
        ):
            self.findings.append(Finding(
                "lock-wait-no-loop",
                f"{rel}::{owner}",
                f"Condition self.{attr}.wait() at line {call.lineno} is "
                "not wrapped in a `while <predicate>` loop — spurious and "
                "stolen wakeups make an if/bare wait return with the "
                "predicate false; loop it (or use wait_for)",
            ))

        if not held:
            return
        blocking = None
        if name in _BLOCKING_SIMPLE:
            blocking = name
        elif name == "join":
            terminal = _terminal_name(recv)
            if not isinstance(recv, ast.Constant) and terminal != "path":
                blocking = name
        elif name in ("get", "put"):
            terminal = _terminal_name(recv)
            if terminal is not None and _QUEUEISH.search(terminal):
                blocking = name
        elif name == "wait":
            ref_attr = _self_attr(recv)
            held_keys = {h[1] for h in held if h[0] == "self"}
            held_names = {h[1] for h in held if h[0] == "name"}
            is_held = (
                (ref_attr is not None and ref_attr in held_keys)
                or (isinstance(recv, ast.Name) and recv.id in held_names)
            )
            if not is_held:
                blocking = name
        if blocking is None:
            return
        key = (f"{rel}::{owner}", blocking, call.lineno)
        if key in blocking_seen:
            return
        blocking_seen.add(key)
        held_desc = ", ".join(sorted(h[2].split("::", 1)[1] for h in held))
        self.findings.append(Finding(
            "lock-blocking-hold",
            f"{rel}::{owner}",
            f".{blocking}(...) at line {call.lineno} blocks while holding "
            f"{held_desc} — every thread needing that lock convoys behind "
            "the slow call (and a cycle through the blocked resource is a "
            "deadlock). Move the blocking call outside the lock, or "
            "allowlist with a the-lock-IS-the-contract rationale in "
            "analysis/lock_flow.py",
        ))


def _scan_sources(sources) -> list[_ModuleScan]:
    scans = []
    for rel, src in sorted(sources.items()):
        rel = rel.replace(os.sep, "/")
        scans.append(_ModuleScan(rel, ast.parse(src)))
    return scans


def _default_sources():
    return dict(_iter_package_sources(_PACKAGE_DIR))


def analyze_lock_flow(sources=None) -> list[Finding]:
    """The four guarded-by rules (unguarded-write, wait-no-loop,
    blocking-hold, orphan-thread) over ``{relpath: source}`` — raw findings,
    no allowlist applied (``run_lock_flow`` applies LOCK_ALLOWLIST)."""
    if sources is None:
        sources = _default_sources()
    findings: list[Finding] = []
    for scan in _scan_sources(sources):
        findings.extend(scan.findings)
    return findings


def lock_order_edges(sources=None) -> set[tuple[str, str]]:
    """The static lock-acquisition graph: lexically nested ``with`` over
    distinct owned locks → (outer, inner) edges."""
    if sources is None:
        sources = _default_sources()
    edges: set[tuple[str, str]] = set()
    for scan in _scan_sources(sources):
        edges |= scan.order_edges
    return edges


def check_lock_order(sources=None) -> list[Finding]:
    """lock-order-cycle: any cycle in the static acquisition graph."""
    edges = lock_order_edges(sources)
    graph: dict[str, list[str]] = {}
    for a, b in sorted(edges):
        graph.setdefault(a, []).append(b)
    findings = []
    color: dict[str, int] = {}
    path: list[str] = []
    sigs: set[tuple[str, ...]] = set()

    def visit(start: str) -> None:
        color[start] = 1
        path.append(start)
        stack = [(start, iter(graph.get(start, ())))]
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[node] = 2
                path.pop()
                stack.pop()
                continue
            c = color.get(nxt, 0)
            if c == 0:
                color[nxt] = 1
                path.append(nxt)
                stack.append((nxt, iter(graph.get(nxt, ()))))
            elif c == 1:
                cyc = tuple(path[path.index(nxt):])
                k = min(range(len(cyc)), key=lambda j: cyc[j:] + cyc[:j])
                sig = cyc[k:] + cyc[:k]
                if sig not in sigs:
                    sigs.add(sig)
                    findings.append(Finding(
                        "lock-order-cycle",
                        " -> ".join(sig + (sig[0],)),
                        "lock-acquisition cycle: two threads entering this "
                        "ring from different locks deadlock. Impose one "
                        "global order (obs/lockwatch.py WATCHED_LOCKS) "
                        "and acquire along it",
                    ))

    for u in sorted(graph):
        if color.get(u, 0) == 0:
            visit(u)
    return findings


# ---------------------------------------------------------------------------
# repo-lockwatch-gate
# ---------------------------------------------------------------------------

_NAMED_FACTORIES = ("named_lock", "named_rlock", "named_condition")


def _watched_registry(tree: ast.Module) -> dict[str, str] | None:
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "WATCHED_LOCKS"
            and isinstance(node.value, ast.Dict)
        ):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if not (
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                ):
                    continue
                rationale = ""
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    rationale = v.value
                elif isinstance(v, ast.JoinedStr):
                    rationale = "<dynamic>"
                out[k.value] = rationale
            return out
    return None


def _calls_name(fn: ast.AST, target: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == target:
                return True
            if isinstance(f, ast.Attribute) and f.attr == target:
                return True
    return False


def _scoped_walk(tree: ast.Module):
    """(node, scope) pairs where scope is the enclosing def/class qualname
    (or '<module>')."""

    def rec(node, scope):
        for child in ast.iter_child_nodes(node):
            child_scope = scope
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                child_scope = (
                    child.name if scope == "<module>"
                    else f"{scope}.{child.name}"
                )
            yield child, scope
            yield from rec(child, child_scope)

    yield from rec(tree, "<module>")


def check_lockwatch_gate(
    lockwatch_source: str | None = None,
    sources=None,
    raw_allowlist=None,
) -> list[Finding]:
    """repo-lockwatch-gate: the witness provably dead in prod, the registry
    an honest inventory, and every lock visible to it.

    Five statically-checkable halves: (a) the ``named_lock`` factory family
    must consult ``lockwatch_enabled()``, and ``lockwatch_enabled`` must key
    on the documented ``DSL_LOCKWATCH`` env hook; (b) every ``WATCHED_LOCKS``
    row carries a non-empty what-it-guards rationale; (c) every factory call
    site in the package passes a registered STRING CONSTANT name; (d) no
    registry row is stale (registered but never constructed — a lock the
    docs describe but the code dropped); (e) no module outside
    obs/lockwatch.py constructs ``threading.Lock/RLock/Condition`` directly
    unless allowlisted — a raw lock is invisible to the witness AND to the
    docs' threading model.
    """
    if lockwatch_source is None:
        with open(
            os.path.join(_PACKAGE_DIR, "obs", "lockwatch.py"),
            encoding="utf-8",
        ) as f:
            lockwatch_source = f.read()
    if sources is None:
        sources = _default_sources()
    raw_allowlist = (
        RAW_LOCK_ALLOWLIST if raw_allowlist is None else raw_allowlist
    )
    findings = []
    lw_tree = ast.parse(lockwatch_source)
    fns = {
        node.name: node
        for node in ast.walk(lw_tree)
        if isinstance(node, ast.FunctionDef)
    }

    # (a) the gate itself.
    for fac in _NAMED_FACTORIES:
        if fac not in fns:
            findings.append(Finding(
                "repo-lockwatch-gate", f"obs/lockwatch.py::{fac}",
                f"no {fac} function found — the lock factory family is "
                "incomplete and call sites would crash",
            ))
        elif not _calls_name(fns[fac], "lockwatch_enabled"):
            findings.append(Finding(
                "repo-lockwatch-gate", f"obs/lockwatch.py::{fac}",
                f"{fac} does not consult lockwatch_enabled() — it would "
                "hand out instrumented locks in production; gate it",
            ))
    if "lockwatch_enabled" not in fns:
        findings.append(Finding(
            "repo-lockwatch-gate", "obs/lockwatch.py::lockwatch_enabled",
            "no lockwatch_enabled function found — nothing defines the "
            "DSL_LOCKWATCH gate",
        ))
    elif not any(
        isinstance(n, ast.Constant) and n.value == "DSL_LOCKWATCH"
        for n in ast.walk(fns["lockwatch_enabled"])
    ):
        findings.append(Finding(
            "repo-lockwatch-gate", "obs/lockwatch.py::lockwatch_enabled",
            "lockwatch_enabled does not reference the 'DSL_LOCKWATCH' env "
            "hook — the documented off-switch is not what the gate checks",
        ))

    # (b) the registry + rationales.
    registry = _watched_registry(lw_tree)
    if registry is None:
        findings.append(Finding(
            "repo-lockwatch-gate", "obs/lockwatch.py::WATCHED_LOCKS",
            "no WATCHED_LOCKS dict found — the lock inventory (and the "
            "threading model it states) is gone",
        ))
        registry = {}
    for name, rationale in sorted(registry.items()):
        if not rationale.strip():
            findings.append(Finding(
                "repo-lockwatch-gate", f"obs/lockwatch.py::{name}",
                f"watched lock {name!r} has no rationale — the registry "
                "row must say what the lock guards",
            ))

    used: set[str] = set()
    for rel in sorted(sources):
        rel_norm = rel.replace(os.sep, "/")
        if rel_norm.endswith("obs/lockwatch.py"):
            continue
        tree = ast.parse(sources[rel])
        for node, scope in _scoped_walk(tree):
            if not isinstance(node, ast.Call):
                continue
            cname = _call_name(node)
            # (c) constant, registered factory names.
            if cname in _NAMED_FACTORIES:
                arg = node.args[0] if node.args else None
                if not (
                    isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                ):
                    findings.append(Finding(
                        "repo-lockwatch-gate", f"{rel_norm}::{scope}",
                        f"{cname} call at line {node.lineno} passes a "
                        "computed name — unauditable; lock names must be "
                        "string constants registered in WATCHED_LOCKS",
                    ))
                    continue
                used.add(arg.value)
                if arg.value not in registry:
                    findings.append(Finding(
                        "repo-lockwatch-gate", f"{rel_norm}::{arg.value}",
                        f"{cname}({arg.value!r}) at line {node.lineno} is "
                        "not registered in obs/lockwatch.py WATCHED_LOCKS "
                        "— register it with a what-it-guards rationale",
                    ))
            # (e) raw constructions.
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("Lock", "RLock", "Condition")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "threading"
            ):
                key = f"{rel_norm}::{scope}"
                if key not in raw_allowlist:
                    findings.append(Finding(
                        "repo-lockwatch-gate", key,
                        f"raw threading.{node.func.attr}() at line "
                        f"{node.lineno} — invisible to the lockwatch "
                        "witness and to the WATCHED_LOCKS inventory; route "
                        "it through obs.lockwatch.named_lock (or allowlist "
                        "with a rationale in analysis/lock_flow.py)",
                    ))

    # (d) stale registry rows.
    for name in sorted(set(registry) - used):
        findings.append(Finding(
            "repo-lockwatch-gate", f"obs/lockwatch.py::{name}",
            f"watched lock {name!r} is registered but no module constructs "
            "it — stale inventory row; drop it or wire the lock back in",
        ))
    # Stale raw allowlist entries: key should have suppressed something.
    seen_raw = {
        f"{rel.replace(os.sep, '/')}" for rel in sources
    }
    for key in sorted(raw_allowlist):
        rel = key.split("::", 1)[0]
        if rel not in seen_raw:
            findings.append(Finding(
                "repo-lockwatch-gate", key,
                "stale raw-lock allowlist entry: module not in the scanned "
                "set — drop it",
            ))
    return findings


def _apply_allowlist(findings, allowlist) -> list[Finding]:
    kept, seen = [], set()
    for f in findings:
        key = f"{f.rule}::{f.subject}"
        if key in allowlist:
            seen.add(key)
        else:
            kept.append(f)
    for key in sorted(set(allowlist) - seen):
        rule, subject = key.split("::", 1)
        kept.append(Finding(
            rule, subject,
            "stale allowlist entry: the finding it suppresses no longer "
            "fires — drop it so LOCK_ALLOWLIST stays an honest inventory",
        ))
    return kept


def run_lock_flow(disabled=()) -> list[Finding]:
    """Run every lock rule against the port's tree (LOCK_ALLOWLIST
    applied, stale entries flagged)."""
    disabled = set(disabled)
    sources = _default_sources()
    findings: list[Finding] = []
    findings.extend(analyze_lock_flow(sources))
    findings.extend(check_lock_order(sources))
    findings = _apply_allowlist(findings, LOCK_ALLOWLIST)
    if "repo-lockwatch-gate" not in disabled:
        findings.extend(check_lockwatch_gate(sources=sources))
    return [f for f in findings if f.rule not in disabled]
