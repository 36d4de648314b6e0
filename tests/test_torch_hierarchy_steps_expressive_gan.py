"""One GAN step of the TED Expressive hierarchy (6 stages) in the port
against hop_tpu.train.hierarchy's, from identical state, under
test_torch_hierarchy_steps.py's helpers, widths and tolerances (hop_tpu's
step in f64, the port's in f32; see there): the D phase's own cascade, the
discriminator's update, then the generator's with the G term against the
updated discriminator."""

import pytest

from test_torch_hierarchy_steps import check_step, hierarchy_runs
from test_torch_zoo_steps import no_dropout, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def expressive_runs(no_dropout):
    return hierarchy_runs("TED_expressive", ("gan",))


def test_expressive_gan_step_matches_jax(expressive_runs):
    check_step(expressive_runs, "TED_expressive", "gan")
