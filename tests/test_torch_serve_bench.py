"""The port's ``serve-bench`` command vs the JAX package's on the CPU.

- The snapshot path on every ``--index-tier`` (with ``--swap-every`` churn
  and a live ``--metrics-port``): exit 0, the JAX command's record keys,
  valid under JAX's ``analysis/bench_schema.validate_record``, and
  ``compile_count`` equal to the warmed buckets.
- The stack the command serves (``cli.serve_bench_stack``) over weights
  converted from JAX's (``models/convert.py``): the same synthetic pool,
  corpus embeddings within 1e-4 of JAX's ``serve-bench`` stack, and the
  same search ids on every tier.
- The refusals: exit 2 wherever the JAX command exits 2; without CUDA and
  without ``--cpu-devices 1`` an encoding path exits 1.
"""

import dataclasses
import json

import flax.linen as nn
import jax
import numpy as np
import pytest

from distributed_sigmoid_loss_tpu import cli as jax_cli
from distributed_sigmoid_loss_tpu.analysis.bench_schema import validate_record
from distributed_sigmoid_loss_tpu.data import SyntheticImageText as JaxSynthetic
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.serve import EmbeddingCache as JaxEmbeddingCache
from distributed_sigmoid_loss_tpu.serve import EmbeddingService as JaxEmbeddingService
from distributed_sigmoid_loss_tpu.serve import InferenceEngine as JaxInferenceEngine
from distributed_sigmoid_loss_tpu.serve import RetrievalRouter as JaxRetrievalRouter
from distributed_sigmoid_loss_tpu.utils.config import SigLIPConfig as JaxSigLIPConfig
from distributed_sigmoid_loss_tpu_torch import cli
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.serve import EmbeddingCache, EmbeddingService
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

SMALL = ["serve-bench", "--requests", "48", "--clients", "4", "--pool", "16",
         "--index-size", "16", "--seed", "1"]


def _last_record(capsys) -> tuple[dict, str]:
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


def _shape(record: dict) -> dict:
    """Keys of the record and of its nested maps whose keys the run's numbers
    do not decide."""
    out = {"": list(record)}
    for key in ("latency_ms", "cache", "swap_latency_ms"):
        out[key] = sorted(record[key])
    out["stage_latency_ms"] = {k: sorted(v) for k, v in record["stage_latency_ms"].items()}
    out["search_stage_latency_ms"] = sorted(record["search_stage_latency_ms"])
    return out


@pytest.mark.parametrize("extra", [
    ["--batch-buckets", "1,4,8"],
    ["--batch-buckets", "1,4,8", "--index-tier", "ann", "--swap-every", "12", "--rerank-k", "8"],
    # JAX's --mesh spans the 8 CPU devices of tests/conftest.py, so its
    # buckets must divide 8; the port's shard sits on the one CPU device.
    ["--batch-buckets", "8", "--index-tier", "sharded", "--mesh", "--metrics-port", "0"],
])
def test_snapshot_record_keys_equal_jax(extra, capsys):
    assert cli.main(SMALL + extra + ["--cpu-devices", "1"]) == 0
    port, err = _last_record(capsys)
    assert jax_cli.main(SMALL + extra) == 0
    ref, _ = _last_record(capsys)
    assert _shape(port) == _shape(ref)
    assert validate_record(port) == []
    assert port["metric"] == "serve_bench" and port["requests"] == 48
    assert port["compile_count"] == port["bucket_space"] == ref["bucket_space"]
    assert port["index_tier"] == ref["index_tier"] and port["sharded"] == ref["sharded"]
    assert port["rerank_k"] == ref["rerank_k"]
    if "--swap-every" in extra:
        assert port["swap_count"] >= 1 and port["index_version"] == port["swap_count"] + 1
    if "--metrics-port" in extra:
        assert "live /metrics at http://127.0.0.1:" in err
        assert port["shard_count"] == 1  # one shard on the one device


@pytest.fixture(scope="module")
def jax_params():
    jcfg = JaxSigLIPConfig.tiny_test()
    pool = next(iter(JaxSynthetic(jcfg, 24, image_seed=2, text_seed=3)))
    params = JaxSigLIP(jcfg).init(jax.random.key(1), np.asarray(pool["images"][:1]),
                                  np.asarray(pool["tokens"][:1]))["params"]
    return jcfg, jax.tree.map(np.asarray, nn.meta.unbox(params))


@pytest.mark.parametrize("tier", ["exact", "sharded", "ann"])
def test_stack_embeddings_and_search_ids_equal_jax(tier, jax_params):
    """``serve_bench_stack`` over JAX's weights against the JAX command's own
    stack-building steps (``cmd_serve_bench``: the pool at seeds + 1 / + 2,
    ``model.init(key(seed))``, warmup, corpus through the engine, the
    router) at ``--seed 1``."""
    jcfg, params = jax_params
    argv = ["serve-bench", "--pool", "24", "--index-size", "20", "--seed", "1",
            "--batch-buckets", "1,8", "--index-tier", tier, "--cpu-devices", "1"]
    if tier == "sharded":
        argv.append("--mesh")
    args = cli._parser().parse_args(argv)
    buckets = (1, 8)

    # The JAX command's stack.
    jmodel = JaxSigLIP(jcfg)
    jpool = next(iter(JaxSynthetic(jcfg, 24, image_seed=2, text_seed=3)))
    jengine = JaxInferenceEngine.from_model(jmodel, params, batch_buckets=buckets)
    jengine.warmup()
    jcorpus = np.concatenate([jengine.encode_image(np.asarray(jpool["images"])[i:i + 8])
                              for i in range(0, 20, 8)])
    jrouter = JaxRetrievalRouter(tier=tier, mesh=make_mesh() if tier == "sharded" else None)
    jrouter.publish(jcorpus)

    # The port's, over the converted weights.
    cfg = pc.SigLIPConfig(vision=pc.ViTConfig(**dataclasses.asdict(jcfg.vision)),
                          text=pc.TextConfig(**dataclasses.asdict(jcfg.text)),
                          loss=pc.LossConfig(**dataclasses.asdict(jcfg.loss)))
    model = SigLIP(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    stack = cli.serve_bench_stack(args, model.eval(), buckets,
                                  ["cpu"] if tier == "sharded" else None)
    np.testing.assert_array_equal(stack["pool_tokens"], np.asarray(jpool["tokens"]))
    np.testing.assert_array_equal(stack["pool_images"], np.asarray(jpool["images"]))
    assert stack["warmed"] == stack["engine"].bucket_space == 4
    np.testing.assert_allclose(stack["corpus_emb"], jcorpus, rtol=1e-4, atol=1e-6)

    psvc = EmbeddingService(stack["engine"], cache=EmbeddingCache(64), index=stack["router"],
                            max_wait_ms=1.0)
    jsvc = JaxEmbeddingService(jengine, cache=JaxEmbeddingCache(64), index=jrouter,
                               max_wait_ms=1.0)
    try:
        queries = stack["pool_tokens"]
        ps, pi = psvc.search(queries[:8], k=5)
        js, ji = jsvc.search(queries[:8], k=5)
        q = psvc.encode_text(queries[:8])
    finally:
        psvc.close()
        jsvc.close()
    sims = q @ stack["corpus_emb"].T
    top = np.sort(sims, axis=1)[:, ::-1][:, :6]
    assert np.all(np.diff(top, axis=1) < -1e-4)  # tie-free at this tolerance
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("argv", [
    ["--requests", "0"],
    ["--clients", "0"],
    ["--swap-every", "-1"],
    ["--rerank-k", "-2"],
    ["--index-tier", "sharded"],
    ["--batch-buckets", "1,x"],
    ["--scenario", "burst", "--duration-s", "0"],
    ["--scenario", "skew", "--offered-load", "-1"],
    ["--scenario", "slowloris", "--capacity", "0"],
    ["--scenario", "burst", "--tenants", "gold:prio=high"],
    ["--scenario", "hostloss", "--tenants", ""],
    ["--index-tier", "ivf"],
    ["--model", "giant"],
    ["--scenario", "stampede"],
])
def test_refusals_exit_2_like_jax(argv, capsys):
    def run(main):
        try:
            return main(["serve-bench"] + argv)
        except SystemExit as e:  # argparse's own refusals
            return e.code

    assert run(cli.main) == run(jax_cli.main) == 2
    capsys.readouterr()


def test_device_rules(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(SMALL) == 1  # an encoding path never falls back to the CPU
    assert "CUDA is not available" in capsys.readouterr().err
    assert cli.main(SMALL + ["--cpu-devices", "2"]) == 2
    assert "--cpu-devices 2" in capsys.readouterr().err
    # The drills touch no device and run without --cpu-devices.
    assert cli.main(["serve-bench", "--scenario", "hostloss", "--duration-s", "0.6",
                     "--offered-load", "60"]) == 0
    record, _ = _last_record(capsys)
    assert record["scenario"] == "hostloss" and record["silent_drops"] == 0


def test_mesh_refuses_several_gpus(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.main(SMALL + ["--mesh", "--index-tier", "sharded"]) == 2
    err = capsys.readouterr().err
    assert "2 GPUs" in err and "ROADMAP.md queue A item 9" in err


def test_emit_serve_record_fails_on_silent_drops(capsys):
    assert cli._emit_serve_record({"metric": "serve_siege", "silent_drops": 0},
                                  strict_zero_drops=True) == 0
    assert cli._emit_serve_record({"metric": "serve_siege", "silent_drops": 2},
                                  strict_zero_drops=True) == 1
    assert cli._emit_serve_record({"metric": "serve_bench", "silent_drops": 2}) == 0
    out, err = capsys.readouterr()
    assert len(out.strip().splitlines()) == 3 and "2 silent drop(s)" in err
