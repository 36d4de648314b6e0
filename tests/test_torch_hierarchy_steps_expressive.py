"""One warmup step of the TED Expressive hierarchy (6 stages, the
off-by-one face-bone routing, the palm pseudo-bones of the physical prior)
in the port against hop_tpu.train.hierarchy's, from identical state, under
test_torch_hierarchy_steps.py's helpers, widths and tolerances (hop_tpu's
step in f64, the port's in f32; see there). The GAN step is in
test_torch_hierarchy_steps_expressive_gan.py: each file compiles one of
hop_tpu's 6-stage steps, about a minute on the CPU."""

import pytest

from test_torch_hierarchy_steps import check_step, hierarchy_runs
from test_torch_zoo_steps import no_dropout, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def expressive_runs(no_dropout):
    return hierarchy_runs("TED_expressive", ("warmup",))


def test_expressive_warmup_step_matches_jax(expressive_runs):
    check_step(expressive_runs, "TED_expressive", "warmup")
