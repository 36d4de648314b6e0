"""The port's checkpoints (hop_tpu_torch.utils.checkpoint and
`GANTrainState.state_dict`) on the CPU at the tiny size.

A GAN train state saved after a step and restored into a fresh state built
from the same seeds equals it in every tensor (both nets, BatchNorm
statistics and their `num_batches_tracked`, both Adams' moments and
per-parameter step counts) and trains on bit for bit. `strip_frozen` drops
exactly the frozen backbone (`llm_model.*`). The manager keeps the three
newest saves, the best FGD and the run metadata as hop_tpu's orbax manager
does for the same saves. A crash between the arrays' write and the
metadata's leaves `latest_step` on the older save.

The bitwise comparisons of training run on one CPU thread: MKL's threaded
GEMMs (the beat MLP's weight gradient) may split their sums differently
from one call to the next, so two multi-threaded CPU steps from equal
states need not agree in the last bit.
"""

import json

import jax.numpy as jnp
import pytest
import torch

from hop_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager

from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.data.synthetic import make_train_batch
from hop_tpu_torch.models.hop import build_hop_model
from hop_tpu_torch.models.multimodal_context import build_discriminator
from hop_tpu_torch.train.llm import make_hop_train_steps
from hop_tpu_torch.utils import checkpoint
from hop_tpu_torch.utils.checkpoint import (CheckpointManager, reattach_frozen,
                                            strip_frozen)

N_SPEAKERS = 10


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    cfg = tiny_test_config("TED")
    model = build_hop_model(cfg, N_SPEAKERS, seed, "cpu")
    disc = build_discriminator(cfg, seed + 1, "cpu")
    warmup, gan, init_state = make_hop_train_steps(cfg, model, disc)
    return cfg, init_state(), gan


def _all_tensors(state):
    """Every tensor of a state by name, the frozen backbone included."""
    out = {"gen/" + k: v for k, v in state.model.state_dict().items()}
    out.update({"dis/" + k: v for k, v in state.disc.state_dict().items()})
    for name, opt in (("gen_opt", state.gen_opt), ("dis_opt", state.dis_opt)):
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{name}/{i}/{k}": v for k, v in s.items()})
    return {k: v.clone() for k, v in out.items()}


def test_round_trip_restores_a_train_state_bit_for_bit(tmp_path, one_thread):
    cfg, state, gan = _state()
    batch = make_train_batch(cfg, 4, 0, N_SPEAKERS, "cpu")
    for i in range(2):
        state, _ = gan(state, batch, torch.Generator().manual_seed(i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state.state_dict())
    assert mgr.latest_step() == 3

    _, fresh, gan2 = _state()
    fresh.load_state_dict(mgr.restore())
    want, got = _all_tensors(state), _all_tensors(fresh)
    assert want.keys() == got.keys()
    assert any(k.endswith("num_batches_tracked") for k in got)
    assert any(k.startswith("gen_opt/") and k.endswith("/step") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert fresh.step == state.step == 2

    # and they train on alike
    state, m1 = gan(state, batch, torch.Generator().manual_seed(9))
    fresh, m2 = gan2(fresh, batch, torch.Generator().manual_seed(9))
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    want, got = _all_tensors(state), _all_tensors(fresh)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_strip_frozen_drops_exactly_the_backbone():
    _, state, _ = _state()
    sd = state.model.state_dict()
    stripped, frozen = strip_frozen(sd)
    frozen_params = {k for k, p in state.model.named_parameters() if not p.requires_grad}
    assert frozen_params and frozen_params <= set(frozen)
    assert set(frozen) == {k for k in sd if k.startswith("llm_model.")}
    assert not any(k.startswith("llm_model.") for k in stripped)
    assert all(p.requires_grad for k, p in state.model.named_parameters()
               if k in stripped)
    assert reattach_frozen(stripped, frozen).keys() == sd.keys()
    assert state.state_dict()["gen"].keys() == stripped.keys()


def test_manager_keeps_what_hop_tpus_keeps(tmp_path):
    """Five saves with hop_tpu's loop metadata, best FGD at epochs 1 and 3:
    the same kept steps, latest step, best record and run metadata."""
    fgds = [5.0, 3.0, 4.0, 2.0, 2.5]
    port = CheckpointManager(str(tmp_path / "port"))
    ref = JaxCheckpointManager(str(tmp_path / "jax"))
    static = {"model": "AD_LLM", "n_speakers": 2, "llm_weights": None}
    port.metadata, ref.metadata = static, dict(static)
    best = float("inf")
    for epoch, fgd in enumerate(fgds):
        meta = {"fgd": fgd, "bc": 0.0, "epoch": epoch, "best_fgd": min(best, fgd)}
        port.save(epoch, {"w": torch.full((3,), float(epoch))}, meta)
        ref.save(epoch, {"w": jnp.full((3,), float(epoch))}, dict(meta))
        if fgd < best:
            assert port.record_best("frechet", fgd, epoch)
            assert ref.record_best("frechet", fgd, epoch)
            best = fgd
    assert port.latest_step() == ref.latest_step() == 4
    assert port.all_steps() == list(ref._mgr.all_steps()) == [2, 3, 4]
    assert ((tmp_path / "port" / "best_metrics.json").read_text()
            == (tmp_path / "jax" / "best_metrics.json").read_text())
    got = port.run_metadata()
    assert got.pop("step") == 4
    assert got == ref.run_metadata()
    assert torch.equal(port.restore()["w"], torch.full((3,), 4.0))
    assert torch.equal(port.restore(2)["w"], torch.full((3,), 2.0))


def test_crash_before_the_metadata_leaves_the_older_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.zeros(2)}, {"epoch": 0})
    write = checkpoint._write_atomically

    def crash_on_metadata(path, fn):
        if path.name == "run_metadata.json":
            raise KeyboardInterrupt("preempted")
        write(path, fn)
    monkeypatch.setattr(checkpoint, "_write_atomically", crash_on_metadata)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(1, {"w": torch.ones(2)}, {"epoch": 1})
    monkeypatch.undo()
    assert mgr.path(1).exists()            # the arrays are on disk ...
    for m in (mgr, CheckpointManager(str(tmp_path))):
        assert m.latest_step() == 0        # ... but a resume takes the older save
        assert m.run_metadata()["epoch"] == 0
        assert torch.equal(m.restore()["w"], torch.zeros(2))
    assert not list(tmp_path.glob("*.tmp"))
    assert json.loads((tmp_path / "run_metadata.json").read_text())["step"] == 0
