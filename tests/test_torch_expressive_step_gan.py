"""HOP on TED Expressive: the epoch-0 GAN steps, fused and the reference's
3-forward one, against hop_tpu.train.llm, under
test_torch_expressive_step.py's helpers, sizes and tolerances (there)."""

import pytest

from test_torch_expressive_step import check_step, expressive_runs, step_ids
from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

STEPS = [("gan", 0, True), ("gan", 0, False)]


@pytest.fixture(scope="module")
def jax_runs():
    return expressive_runs(STEPS)


@pytest.mark.parametrize("kind,epoch,fused", STEPS, ids=step_ids(STEPS))
def test_expressive_gan_step_matches_jax(jax_runs, kind, epoch, fused):
    check_step(jax_runs, kind, epoch, fused)
