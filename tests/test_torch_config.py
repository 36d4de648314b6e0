"""The port's presets (hop_tpu_torch.config) equal hop_tpu.config's, field
by field, the train step's loss weights and optimizer settings too: every
field the port carries exists in the JAX sub-config under the same name,
in the same order, with the same value."""

import dataclasses

import pytest

from hop_tpu import config as jcfg
from hop_tpu_torch import config as tcfg

PRESETS = [
    ("ted", lambda m: m.ted_config()),
    ("expressive", lambda m: m.expressive_config()),
    ("tiny_ted", lambda m: m.tiny_test_config("TED")),
    ("tiny_expressive", lambda m: m.tiny_test_config("TED_expressive")),
]


@pytest.mark.parametrize("name,make", PRESETS, ids=[p[0] for p in PRESETS])
@pytest.mark.parametrize("section", ["data", "llm", "hop", "loss", "train"])
def test_preset_fields_match(name, make, section):
    port = getattr(make(tcfg), section)
    ref = getattr(make(jcfg), section)
    port_fields = [f.name for f in dataclasses.fields(port)]
    ref_fields = [f.name for f in dataclasses.fields(ref)]
    assert port_fields == [f for f in ref_fields if f in port_fields]
    assert set(port_fields) <= set(ref_fields)
    for f in port_fields:
        assert getattr(port, f) == getattr(ref, f), f"{name}.{section}.{f}"


@pytest.mark.parametrize("dataset", ["TED", "TED_expressive"])
def test_skeleton_widths_match(dataset):
    port = tcfg.DataConfig(dataset=dataset)
    ref = jcfg.DataConfig(dataset=dataset)
    assert port.pose_dim == ref.pose_dim
    assert port.n_joints_graph == ref.n_joints_graph
