"""The port's evaluation (``eval/retrieval.py``, ``eval/zeroshot.py``)
against the JAX package's: retrieval and classification ranks exactly, the
recall@K / top@K fractions to one f32 ulp (XLA's CPU mean multiplies the sum
by an f32 1/N, the port divides: 10/24 is 0.41666669 there, the correctly
rounded 0.41666666 here); the prompt-ensembled classifier through the tiny text tower with
JAX's weights carried in (within 1e-5), and the zero-shot metrics; and both
at W = 2 over gloo against JAX's sharded metrics on a 2-device mesh. On the
CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as dist_worker
import _torch_slice_workers as workers
from distributed_sigmoid_loss_tpu import cli as jax_cli
from distributed_sigmoid_loss_tpu import eval as jax_eval
from distributed_sigmoid_loss_tpu.models.siglip import SigLIP as JaxSigLIP
from distributed_sigmoid_loss_tpu.parallel.mesh import make_mesh
from distributed_sigmoid_loss_tpu.train import train_step as jts
from distributed_sigmoid_loss_tpu.utils import config as jc
from distributed_sigmoid_loss_tpu_torch import cli as port_cli
from distributed_sigmoid_loss_tpu_torch import eval as port_eval
from distributed_sigmoid_loss_tpu_torch.models import SigLIP, params_from_jax
from distributed_sigmoid_loss_tpu_torch.utils import config as pc

N, D, N_CLASSES = 24, 16, 7
ULP = 1.2e-7  # one f32 ulp of a fraction in (0.5, 1]


def same_fractions(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=0, abs=ULP), k


def embeddings(seed, n=N, d=D):
    rng = np.random.default_rng(seed)
    return workers.unit_rows(rng, n, d), workers.unit_rows(rng, n, d)


def correlated(seed):
    """Texts near their images, so the ranks spread over 0..N-1."""
    rng = np.random.default_rng(seed)
    zimg = workers.unit_rows(rng, N, D)
    ztxt = zimg + 0.9 * workers.unit_rows(rng, N, D)
    return zimg, (ztxt / np.linalg.norm(ztxt, axis=-1, keepdims=True)).astype(np.float32)


CASES = {"random": lambda: embeddings(0), "correlated": lambda: correlated(1),
         "identical": lambda: (embeddings(2)[0],) * 2}


@pytest.mark.parametrize("case", sorted(CASES))
def test_retrieval_ranks_and_recalls_are_jaxs(case):
    zimg, ztxt = CASES[case]()
    for a, b in ((zimg, ztxt), (ztxt, zimg)):
        want = np.asarray(jax_eval.retrieval_ranks(jnp.asarray(a), jnp.asarray(b)))
        got = port_eval.retrieval_ranks(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), want)
        same_fractions({k: port_eval.recall_at_k(got, k) for k in (1, 3, 10)},
                       {k: jax_eval.recall_at_k(jnp.asarray(want), k) for k in (1, 3, 10)})
    ref = jax_eval.retrieval_metrics(jnp.asarray(zimg), jnp.asarray(ztxt), ks=(1, 5))
    got = port_eval.retrieval_metrics(torch.from_numpy(zimg), torch.from_numpy(ztxt), ks=(1, 5))
    same_fractions(got, ref)
    if case == "identical":
        assert all(float(v) == 1.0 for v in got.values())


@functools.cache
def tiny_models():
    jcfg = jc.SigLIPConfig.tiny_test()
    jmodel = JaxSigLIP(jcfg)
    rng = np.random.default_rng(0)
    hw, ctx = jcfg.vision.image_size, jcfg.text.context_length
    sample = {"images": jnp.asarray(rng.standard_normal((2, hw, hw, 3)), jnp.float32),
              "tokens": jnp.asarray(rng.integers(0, 64, (2, ctx)), jnp.int32)}
    params = jts.init_params(jax.random.key(0), jmodel, sample, make_mesh(1))
    pcfg = pc.SigLIPConfig.tiny_test()
    model = SigLIP(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), pcfg), strict=True)
    return jcfg, jmodel, params, pcfg, model


def test_classifier_through_the_text_tower_is_jaxs():
    # 21 prompts in chunks of 4: the last chunk is padded.
    batch_size, templates = 4, ("{} photo.", "{} image.", "a {}.")
    jcfg, jmodel, params, pcfg, model = tiny_models()
    names = [f"c{c}" for c in range(N_CLASSES)]
    ref = jax_eval.build_classifier(
        functools.partial(jmodel.apply, {"params": params}, method=JaxSigLIP.encode_text),
        names, jax_cli._byte_tokenize_for(jcfg), jcfg.text.context_length,
        templates=templates, batch_size=batch_size)
    got = port_eval.build_classifier(model.encode_text, names,
                                     port_cli._byte_tokenize_for(pcfg),
                                     pcfg.text.context_length, templates=templates,
                                     batch_size=batch_size)
    assert got.shape == (N_CLASSES, pcfg.text.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="class_names"):
        port_eval.build_classifier(model.encode_text, [], port_cli._byte_tokenize_for(pcfg), 8)


def test_zeroshot_metrics_are_jaxs():
    rng = np.random.default_rng(3)
    zimg = workers.unit_rows(rng, N, D)
    classifier = workers.unit_rows(rng, N_CLASSES, D)
    labels = rng.integers(0, N_CLASSES, N).astype(np.int32)
    want_ranks = np.asarray(jax_eval.classify_ranks(jnp.asarray(zimg), jnp.asarray(classifier),
                                                    jnp.asarray(labels)))
    got_ranks = port_eval.classify_ranks(torch.from_numpy(zimg), torch.from_numpy(classifier),
                                         torch.from_numpy(labels))
    np.testing.assert_array_equal(got_ranks.numpy(), want_ranks)
    ref = jax_eval.zeroshot_metrics(jnp.asarray(zimg), jnp.asarray(classifier),
                                    jnp.asarray(labels), ks=(1, 3, 5))
    got = port_eval.zeroshot_metrics(torch.from_numpy(zimg), torch.from_numpy(classifier),
                                     torch.from_numpy(labels), ks=(1, 3, 5))
    same_fractions(got, ref)


def test_classifier_weights_are_jaxs():
    z = np.random.default_rng(4).standard_normal((N_CLASSES, 3, D)).astype(np.float32)
    np.testing.assert_allclose(port_eval.classifier_weights(torch.from_numpy(z)).numpy(),
                               np.asarray(jax_eval.classifier_weights(jnp.asarray(z))),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    zimg, ztxt = correlated(5)
    rng = np.random.default_rng(6)
    classifier = workers.unit_rows(rng, N_CLASSES, D)
    labels = rng.integers(0, N_CLASSES, N).astype(np.int32)
    ranks = dist_worker.spawn(workers.retrieval_worker, 2, (zimg, ztxt, classifier, labels),
                              tmp_path_factory.mktemp("retrieval"))
    return (zimg, ztxt, classifier, labels), ranks


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_metrics_at_w2_are_jaxs(sharded, rank):
    (zimg, ztxt, classifier, labels), ranks = sharded
    mesh = make_mesh(2)
    ref = jax_eval.retrieval_metrics(jnp.asarray(zimg), jnp.asarray(ztxt), mesh=mesh,
                                     ks=(1, 2, 5))
    same_fractions(ranks[rank]["retrieval"], ref)
    ref = jax_eval.zeroshot_metrics(jnp.asarray(zimg), jnp.asarray(classifier),
                                    jnp.asarray(labels), mesh=mesh, ks=(1, 3))
    same_fractions(ranks[rank]["zeroshot"], ref)
    # The sharded ranks give the one-device recalls.
    one = port_eval.retrieval_metrics(torch.from_numpy(zimg), torch.from_numpy(ztxt), ks=(1, 2, 5))
    assert ranks[rank]["retrieval"] == {k: float(v) for k, v in one.items()}
