"""The pipeline train step with Adafactor over gloo ranks (split off from
``test_torch_pipeline.py`` to keep each file's time down): at (dp, pp) =
(2, 2) against JAX's non-pp step with Adafactor (its block RMS taken over
every stage's layers), and a checkpoint whose statistics join the stages'
layers along the stack, restored onto a plain dp = 4 grid and back."""

import pytest

from test_torch_pipeline import (
    STEP_CASES,
    check_checkpoint,
    check_step_against_jax,
    spawn_cases,
)

MINE = [c for c in STEP_CASES if c[-1] == "adafactor"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_cases(MINE, "adafactor", tmp_path_factory.mktemp("pipeline_adafactor"))


@pytest.mark.parametrize("name,dp,m,schedule,remat,optimizer", MINE)
def test_pp_train_step_with_adafactor_matches_jax(ranks, name, dp, m, schedule, remat,
                                                 optimizer):
    check_step_against_jax(ranks, name, dp, remat, optimizer)


def test_pp_adafactor_checkpoint_restores_onto_plain_dp_grid(ranks):
    check_checkpoint(ranks, "adafactor")
