"""Expert parallelism on a (dp, ep) = (2, 2) grid of gloo ranks against
JAX's global loss and gradient (``test_torch_expert_parallel.py``'s
oracle, split off to keep each file's time down): top-1 with a capacity
that drops tokens and top-2, without the aux term, whose estimator at dp >
1 is the port's per-shard one (ROADMAP.md, deliberate differences)."""

import pytest

from test_torch_expert_parallel import check_against_jax, spawn_cases

MINE = ("dp2ep2_k1_drop", "dp2ep2_k2")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_cases(MINE, tmp_path_factory.mktemp("ep_dp2"), with_checkpoint=False)


@pytest.mark.parametrize("name", MINE)
def test_every_rank_matches_jax_global_loss_and_gradient(ranks, name):
    check_against_jax(ranks, name)
