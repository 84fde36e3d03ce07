"""The port's lint (``distributed_sigmoid_loss_tpu_torch/analysis``) held to
the JAX package's ``analysis``.

The config space: the port's legal product equals JAX's, and its probe of
the port's refusal layers gives JAX's verdict on every config of JAX's
tier-1 and full-product samples. The rules: each trips on a seeded bad
fixture and stays silent on the port's tree (the whole lint, traces
included, runs once, in a module-scoped fixture); the catalog and the
counterpart map cover JAX's ``ALL_RULES`` exactly. The ``lint`` command:
its flags and exit codes through ``cli.main``.
"""

import contextlib
import dataclasses
import io
import json

import pytest
import torch
import torch.distributed as dist

from distributed_sigmoid_loss_tpu import analysis as jax_analysis
from distributed_sigmoid_loss_tpu.analysis import config_space as jcs
from distributed_sigmoid_loss_tpu.analysis import jaxpr_audit as jaudit
from distributed_sigmoid_loss_tpu_torch import analysis, cli
from distributed_sigmoid_loss_tpu_torch.analysis import (
    config_space,
    lock_flow,
    repo_lint,
    shard_flow,
    trace_audit,
)
from distributed_sigmoid_loss_tpu_torch.analysis.trace_audit import (
    StepTrace,
    _leaves,
    fake_process_group,
    one_thread,
)
from distributed_sigmoid_loss_tpu_torch.obs.attribution import trace_costs, trace_ops


def run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def tree_lint():
    """``lint --json`` over the port's tree, traces included (once):
    (exit code, report)."""
    rc, out, _ = run(["lint", "--json"])
    return rc, json.loads(out)


# --- the config space ------------------------------------------------------------


def _fields(cfg) -> tuple:
    return dataclasses.astuple(cfg)


def test_legal_product_equals_jaxs():
    port = {_fields(c) for c in config_space.enumerate_legal()}
    want = {_fields(c) for c in jcs.enumerate_legal()}
    assert port == want and len(port) == len(config_space.enumerate_legal())
    assert [f.name for f in dataclasses.fields(config_space.StepConfig)] == \
        [f.name for f in dataclasses.fields(jcs.StepConfig)]
    assert config_space.AXES == jcs.AXES
    assert [c.name for c in config_space.CONSTRAINTS] == [c.name for c in jcs.CONSTRAINTS]


def test_samples_and_labels_equal_jaxs():
    for port_fn, jax_fn in ((config_space.tier1_sample, jcs.tier1_sample),
                            (config_space.full_product_sample, jcs.full_product_sample)):
        port, want = port_fn(), jax_fn()
        assert list(port) == list(want)
        assert all(_fields(port[k]) == _fields(want[k]) for k in want)
    assert tuple(config_space.LEGACY_CONFIGS) == jaudit.DEFAULT_STEP_CONFIGS
    assert set(config_space.LEGACY_CONFIGS) <= set(config_space.tier1_sample())


@pytest.mark.parametrize("sample", ["tier1", "full_product"])
def test_probe_verdicts_equal_jaxs_on_its_samples(sample):
    """The port's refusal layers accept and refuse exactly what JAX's do, on
    every config of JAX's sample; the verdicts agree with both tables."""
    configs = (jcs.tier1_sample() if sample == "tier1" else jcs.full_product_sample()).values()
    for jcfg in configs:
        cfg = config_space.StepConfig(**dataclasses.asdict(jcfg))
        got, detail = config_space.probe_imperative(cfg)
        want, jdetail = jcs.probe_imperative(jcfg)
        assert got == want, (config_space.label_of(cfg), detail, jdetail)
        assert got == config_space.is_legal(cfg)


def test_probe_verdicts_equal_jaxs_on_refused_corners():
    """Configs the table refuses, one a constraint, refused by both probes."""
    seen = set()
    for cfg in config_space.iter_product():
        broken = config_space.violations(cfg)
        if len(broken) != 1 or broken[0].name in seen or cfg.ema:
            continue
        seen.add(broken[0].name)
        jcfg = jcs.StepConfig(**dataclasses.asdict(cfg))
        assert config_space.probe_imperative(cfg)[0] is False, broken[0].name
        assert jcs.probe_imperative(jcfg)[0] is False, broken[0].name
    assert seen == {c.name for c in config_space.CONSTRAINTS} - {"ema-excludes-compression"}


# --- the catalog ----------------------------------------------------------------------


def test_catalog_and_counterpart_map_cover_jaxs_rules():
    assert set(analysis.JAX_RULE_COUNTERPARTS) == set(jax_analysis.ALL_RULES)
    ported = {v for v in analysis.JAX_RULE_COUNTERPARTS.values() if v in analysis.ALL_RULES}
    assert ported == set(analysis.ALL_RULES)
    reasons = {k: v for k, v in analysis.JAX_RULE_COUNTERPARTS.items()
               if v not in analysis.ALL_RULES}
    assert set(reasons) == {"repo-bench-shield", "jaxpr-weak-type"}
    assert all(len(v) > 40 for v in reasons.values())
    for jax_rule, rule in analysis.JAX_RULE_COUNTERPARTS.items():
        if rule in analysis.ALL_RULES and jax_rule.startswith("jaxpr-"):
            assert rule == "trace-" + jax_rule[len("jaxpr-"):]
    assert analysis.TRACE_RULES == trace_audit.TRACE_RULES + shard_flow.SHARD_FLOW_RULES
    assert analysis.CONFIG_RULES == config_space.CONFIG_SPACE_RULES
    assert len(set(analysis.ALL_RULES)) == len(analysis.ALL_RULES)


# --- the rules: a bad fixture each, the tree silent --------------------------------

W = 4


def trace_callable(label, fn, inputs, outputs=None, *, world=1, rank=0, groups=None,
                   checks=None) -> StepTrace:
    """The trace of a small program, ``fn(**made)`` with ``made = inputs()``
    (argument name -> tree of tensors, made under ``FakeTensorMode``):
    ``made``'s leaves are the roots (named by their path, ``opt/mu``),
    ``outputs(made, result)`` the final leaves (default: ``made``); in a
    fake process group of ``world`` ranks at ``rank`` when ``world > 1``,
    ``groups`` the groups the rules accept (default: the world)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ctx = fake_process_group(world, rank) if world > 1 else contextlib.nullcontext()
    with one_thread(), ctx, FakeTensorMode(allow_non_fake_inputs=True):
        made = inputs()
        with trace_ops() as tally:
            roots = {k: tally.sid(v) for k, v in _leaves(made, "", {}).items()}
            result = fn(**made)
            final_t = outputs(made, result) if outputs is not None else made
            final = {k: tally.sid(v) for k, v in _leaves(final_t, "", {}).items()}
    return StepTrace(label=label, rank=rank, world=world, ops=list(tally.ops),
                     groups=groups or {"world": tuple(range(world))},
                     roots={k.lstrip("/"): v for k, v in roots.items()},
                     final={k.lstrip("/"): v for k, v in final.items()},
                     costs=trace_costs(tally), checks=dict(checks or {}))


def _fake_world_traces(label, fn, inputs, checks=None, groups=None):
    """The trace of ``fn`` at every rank of a fake world of W."""
    return [trace_callable(label, fn, inputs, world=W, rank=r, checks=checks, groups=groups)
            for r in range(W)]


def _x(n=8):
    return lambda: {"x": torch.ones(n)}


def _ring(shift_of):
    def fn(x):
        r = dist.get_rank()
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, shift_of(r)),
               dist.P2POp(dist.irecv, y, (r - 1) % W)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return y
    return fn


def bad_ppermute_bijection():
    traces = _fake_world_traces("fixture", _ring(lambda r: 0 if r else 1), _x())
    return trace_audit.audit_peer_traces(traces)


def bad_collective_axis():
    def fn(x):
        group = dist.new_group([0, 1])
        dist.all_reduce(x, group=group)
    return trace_audit.audit_trace(trace_callable(
        "fixture", fn, _x(), world=W, groups={"dp": tuple(range(W))}))


def bad_double_psum():
    def fn(x):
        dist.all_reduce(x)
        dist.all_reduce(x)
    return trace_audit.audit_trace(trace_callable("fixture", fn, _x(), world=W))


def bad_f64():
    return trace_audit.audit_trace(trace_callable("fixture", lambda x: x.double() * 2, _x()))


def _chunked_loss(zi, zt, t_prime, bias):
    from distributed_sigmoid_loss_tpu_torch.parallel.allgather_loss import (
        allgather_sigmoid_loss,
    )

    for t in (zi, zt, t_prime, bias):
        t.requires_grad_(True)
    allgather_sigmoid_loss(zi, zt, t_prime, bias, loss_impl="chunked").backward()


def _loss_inputs():
    return {"zi": torch.randn(4, 16), "zt": torch.randn(4, 16),
            "t_prime": torch.tensor(2.3), "bias": torch.tensor(-10.0)}


def bad_chunk_checkpoint(monkeypatch):
    from distributed_sigmoid_loss_tpu_torch.ops import sigmoid_loss

    monkeypatch.setattr(sigmoid_loss, "checkpoint", lambda body, *a, **kw: body(*a))
    return trace_audit.audit_trace(trace_callable(
        "fixture", _chunked_loss, _loss_inputs, world=W,
        checks={"expect_chunk_block": (4, 4)}))


def bad_bf16_upcast():
    def fn(a, b):
        return a.to(torch.bfloat16).float() @ b
    return trace_audit.audit_trace(trace_callable(
        "fixture", fn, lambda: {"a": torch.ones(4, 8), "b": torch.ones(8, 4)},
        checks={"check_bf16_upcast": True}))


def bad_redundant_gather():
    def fn(x):
        dist.all_reduce(x)
        out = torch.empty(W * x.numel())
        dist.all_gather_into_tensor(out, x)
    return shard_flow.audit_shard_flow(trace_callable("fixture", fn, _x(), world=W))


def bad_state_drop():
    def fn(opt, batch):
        opt["mu"] * 0.9 + batch["g"]  # the update, never written back
    return shard_flow.audit_shard_flow(trace_callable(
        "fixture", fn, lambda: {"opt": {"mu": torch.ones(8)}, "batch": {"g": torch.ones(8)}}))


def bad_collective_order():
    def fn(x):
        if dist.get_rank() == 0:
            dist.all_reduce(x)
        dist.all_reduce(x)
    return shard_flow.audit_shard_flow_ranks(_fake_world_traces("fixture", fn, _x()))


def bad_ef_threaded():
    def fn(ef, batch):
        return [e.clone() for e in ef]  # the residual passed through
    return shard_flow.audit_shard_flow(trace_callable(
        "fixture", fn, lambda: {"ef": [torch.zeros(8)], "batch": {"g": torch.ones(8)}},
        outputs=lambda made, result: {"ef": result}, checks={"ef": True}))


def bad_codec_threaded():
    def fn(comp, params, batch):
        params["w"].add_(batch["g"])  # the update never reaches the codec
        return {"blockmoment": comp["codec_enc"] * 1.0, "codec_recon_err": torch.zeros(())}

    def inputs():
        return {"comp": {"codec_enc": torch.ones(2, 4), "codec_dec": torch.ones(4, 2)},
                "params": {"w": torch.ones(8)}, "batch": {"g": torch.ones(8)}}

    return shard_flow.audit_shard_flow(trace_callable(
        "fixture", fn, inputs,
        outputs=lambda made, result: {"comp": {**made["comp"], **result},
                                      "params": made["params"]},
        checks={"codec": True}))


def bad_gather_placement():
    def fn(opt, batch):
        g = batch["g"]
        shard = torch.empty(g.numel() // W)
        dist.reduce_scatter_tensor(shard, g)
        full = torch.empty_like(g)
        dist.all_gather_into_tensor(full, shard)  # re-replicated before the update
        opt["mu"].add_(full[: shard.numel()])
    return shard_flow.audit_shard_flow(trace_callable(
        "fixture", fn, lambda: {"opt": {"mu": torch.zeros(2)}, "batch": {"g": torch.ones(8)}},
        world=W, groups={"dp": tuple(range(W)), "world": tuple(range(W))},
        checks={"update_shard_axis": "dp"}))


def bad_mutable_global():
    src = "_SEEN = []\n\ndef f(x):\n    _SEEN.append(x)\n"
    return repo_lint.check_mutable_globals({"ops/x.py": src}, allowlist={})


def bad_doc_stale():
    cli_src = ("import argparse\np = argparse.ArgumentParser()\n"
               "p.add_argument('--zz-undocumented')\n")
    cfg_src = "class LossConfig:\n    zz_field: int = 0\n"
    return repo_lint.check_doc_staleness(cli_src, cfg_src, docs_text="")


def bad_slow_marker():
    return repo_lint.check_slow_markers({"test_torch_x.py": "import pytest\n"},
                                        required=("test_torch_x.py",))


def bad_bench_record():
    src = "def _emit_record(r, c):\n    pass\n\nrecord = {'metric': 'm', 'zz_field': 1}\n"
    return repo_lint.check_bench_record_fields({"data/data_bench.py": src})


def bad_metrics_schema():
    return repo_lint.check_metrics_schema({"train/train_step.py": "metrics = {'zz_metric': 1}\n"},
                                          files={"train/train_step.py": "train"})


def bad_ledger_emit():
    src = ("import json\n\ndef _emit_record(r, c):\n    print(json.dumps(r))\n\n"
           "def stage():\n    print(json.dumps({'metric': 'm'}))\n")
    return repo_lint.check_ledger_emit({"data/data_bench.py": src})


def bad_chaos_gate():
    siege = ("CHAOS_POINTS = {'engine.latency': ''}\n\ndef chaos_enabled():\n    return True\n\n"
             "def maybe_inject(point):\n    pass\n")
    return repo_lint.check_chaos_gate(siege, {"serve/engine.py": "maybe_inject(name)\n"})


_LOCK_FIXTURE = '''
import threading
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import named_lock

class Box:
    def __init__(self):
        self._lock = named_lock("fixture.Box._lock")
        self._cond = threading.Condition()
        self._n = 0
        self._t = threading.Thread(target=self.run)

    def bump(self):
        with self._lock:
            self._n += 1

    def reset(self):
        self._n = 0

    def wait_once(self):
        with self._cond:
            self._cond.wait()

    def slow(self, fut):
        with self._lock:
            return fut.result()

    def run(self):
        pass

A = named_lock("fixture.A")
B = named_lock("fixture.B")

def ab():
    with A:
        with B:
            pass

def ba():
    with B:
        with A:
            pass
'''


def _lock_findings(rule):
    sources = {"serve/fixture.py": _LOCK_FIXTURE}
    if rule == "lock-order-cycle":
        return lock_flow.check_lock_order(sources)
    if rule == "repo-lockwatch-gate":
        return lock_flow.check_lockwatch_gate(sources=sources, raw_allowlist={})
    return lock_flow.analyze_lock_flow(sources)


def bad_config_drift():
    cfgs = [c for c in config_space.iter_product() if not config_space.is_legal(c)][:3]
    return config_space.config_space_drift_findings(probe=lambda c: (True, "accepted"),
                                                    configs=cfgs)


def bad_stale_suppression():
    return analysis.apply_lint_baseline([], [("repo-doc-stale", "cli.py::--gone")])


FIXTURES = {
    "trace-ppermute-bijection": bad_ppermute_bijection,
    "trace-collective-axis": bad_collective_axis,
    "trace-double-psum": bad_double_psum,
    "trace-f64": bad_f64,
    "trace-chunk-checkpoint": bad_chunk_checkpoint,
    "trace-bf16-upcast": bad_bf16_upcast,
    "trace-redundant-gather": bad_redundant_gather,
    "trace-state-drop": bad_state_drop,
    "trace-collective-order": bad_collective_order,
    "trace-ef-threaded": bad_ef_threaded,
    "trace-codec-threaded": bad_codec_threaded,
    "trace-gather-placement": bad_gather_placement,
    "repo-mutable-global": bad_mutable_global,
    "repo-doc-stale": bad_doc_stale,
    "repo-slow-marker": bad_slow_marker,
    "repo-bench-record": bad_bench_record,
    "repo-metrics-schema": bad_metrics_schema,
    "repo-ledger-emit": bad_ledger_emit,
    "repo-chaos-gate": bad_chaos_gate,
    "config-space-drift": bad_config_drift,
    "lint-stale-suppression": bad_stale_suppression,
    **{rule: (lambda rule=rule: _lock_findings(rule)) for rule in lock_flow.LOCK_RULES},
}


def test_every_rule_has_a_fixture():
    assert set(FIXTURES) == set(analysis.ALL_RULES)


@pytest.mark.parametrize("rule", analysis.ALL_RULES)
def test_rule_trips_on_its_fixture_and_passes_on_the_tree(rule, tree_lint, monkeypatch):
    fixture = FIXTURES[rule]
    args = (monkeypatch,) if rule == "trace-chunk-checkpoint" else ()
    assert any(f.rule == rule for f in fixture(*args)), rule
    rc, report = tree_lint
    assert [f for f in report["findings"] if f["rule"] == rule] == []
    assert rule in report["rules_checked"] or rule == "lint-stale-suppression"


def test_good_twins_of_the_trace_fixtures_pass():
    """The same programs written right: a ring, one reduction, the chunked
    loss with its checkpoint, a bf16 product, the state written back, the
    residual updated, every rank in step."""
    traces = _fake_world_traces("ok", _ring(lambda r: (r + 1) % W), _x())
    assert trace_audit.audit_peer_traces(traces) == []
    assert shard_flow.audit_shard_flow_ranks(traces) == []
    ok = trace_callable("ok", _chunked_loss, _loss_inputs, world=W,
                        checks={"expect_chunk_block": (4, 4)})
    assert trace_audit.audit_trace(ok) == [] and shard_flow.audit_shard_flow(ok) == []

    def update(opt, batch):
        opt["mu"].mul_(0.9).add_(batch["g"])

    ok = trace_callable("ok", update, lambda: {"opt": {"mu": torch.ones(8)},
                                               "batch": {"g": torch.ones(8)}})
    assert shard_flow.audit_shard_flow(ok) == []

    def ef(ef, batch):
        return [e + batch["g"] for e in ef]

    ok = trace_callable("ok", ef, lambda: {"ef": [torch.zeros(8)], "batch": {"g": torch.ones(8)}},
                        outputs=lambda made, result: {"ef": result}, checks={"ef": True})
    assert shard_flow.audit_shard_flow(ok) == []


def test_bench_shield_trips_on_an_unclassified_flag():
    """``repo-bench-shield`` waits for the port's bench entry: ported and
    tested here, on fixtures, never on the tree."""
    bench = ("import argparse\n_SHIELD_EXEMPT_FLAGS = {'steps': 'timing only'}\n"
             "def _fresh_compile_config(args):\n    return (args.use_pallas,)\n"
             "p = argparse.ArgumentParser()\np.add_argument('--use-pallas')\n"
             "p.add_argument('--steps')\np.add_argument('--zz-new')\n")
    findings = repo_lint.check_bench_shield(bench)
    assert [f.subject for f in findings] == ["bench.py::zz_new"]
    assert "repo-bench-shield" not in repo_lint.REPO_RULES


def test_trace_audit_covers_the_sample_at_every_rank_where_peers_meet(tree_lint):
    traces = trace_audit.step_config_traces()
    assert list(traces) == list(config_space.tier1_sample())
    assert all(t.world == 8 and t.rank == 0 for t in traces.values())
    peers = trace_audit.peer_traces()
    assert set(peers) == {"ring", "ring_overlap", "pallas_ring_overlap", "pp",
                          "family=softmax+variant=ring"}
    assert all([t.rank for t in ts] == list(range(trace_audit.PEER_WORLD))
               for ts in peers.values())
    ring = traces["ring"]
    assert sum(op.name == "c10d::send" for op in ring.ops) > 0
    assert all(op.group in ring.bound() for op in ring.ops if op.group)
    kernel = traces["pallas_fused"]
    assert any(op.name == "dsl_torch_port::streaming_loss_fwd" for op in kernel.ops)


# --- the lint command ----------------------------------------------------------------


def test_lint_command_on_the_tree_is_green(tree_lint):
    rc, report = tree_lint
    assert rc == 0 and report["findings"] == [] and report["disabled"] == []
    assert set(report["rules_checked"]) == set(analysis.ALL_RULES) - {"lint-stale-suppression"}


def test_lint_command_flags_and_exit_codes(monkeypatch, tmp_path):
    """``--no-jaxpr`` (the AST half), ``--disable``, ``--baseline`` with its
    stale suppression, a finding's exit 1 naming its rule, the usage errors'
    exit 2, and ``--full-product`` / ``--cpu-devices`` handed to the audit."""
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"findings": [{"rule": "repo-doc-stale",
                                              "subject": "cli.py::--gone"}]}))
    rc, out, err = run(["lint", "--no-jaxpr", "--json", "--disable", "repo-doc-stale",
                        "--baseline", str(base)])
    report = json.loads(out)
    assert rc == 1 and report["disabled"] == ["repo-doc-stale"]
    assert [(f["rule"], f["subject"]) for f in report["findings"]] == \
        [("lint-stale-suppression", "cli.py::--gone")]
    assert "repo-doc-stale" not in report["rules_checked"]
    assert not any(r.startswith("trace-") or r == "config-space-drift"
                   for r in report["rules_checked"])
    assert "lint-stale-suppression" in report["rules_checked"]

    monkeypatch.setattr(repo_lint, "MUTABLE_GLOBAL_ALLOWLIST",
                        {k: v for k, v in repo_lint.MUTABLE_GLOBAL_ALLOWLIST.items()
                         if k != "obs/attribution.py::_REGISTERED"})
    rc, out, err = run(["lint", "--no-jaxpr"])
    assert rc == 1 and out.startswith("[repo-mutable-global] obs/attribution.py::_REGISTERED")
    assert "1 finding(s)" in err

    assert run(["lint", "--disable", "no-such-rule"])[0] == 2
    assert run(["lint", "--cpu-devices", "3"])[0] == 2
    base.write_text("[{\"rule\": \"x\"}]")
    assert run(["lint", "--no-jaxpr", "--baseline", str(base)])[0] == 2

    seen = {}

    def fake_run_lint(**kw):
        seen.update(kw)
        return []

    monkeypatch.setattr(analysis, "run_lint", fake_run_lint)
    assert run(["lint", "--full-product", "--cpu-devices", "4"])[0] == 0
    assert seen["full_product"] is True and seen["n_devices"] == 4 and seen["jaxpr"] is True
    assert set(config_space.tier1_sample()) < set(config_space.full_product_sample())
