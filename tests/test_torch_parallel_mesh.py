"""The port's rank layout (hop_tpu_torch.parallel.mesh) against hop_tpu's
mesh, and what the parallel path refuses, without processes.

  * the rank at each (dcn, data, model) coordinate is the device index of
    hop_tpu's `create_mesh(4, 2)` and `create_mesh(2, 2, n_dcn=2)` on the
    8-device CPU mesh of conftest.py, and the process groups hold the ranks
    that hop_tpu's mesh axes hold;
  * `zero2_spec` names the axis hop_tpu's names, on every moment shape of
    the tiny HOP generator and discriminator;
  * the flag arithmetic (`--data-parallel 0` = WORLD_SIZE / (model x dcn))
    and its refusals: a product that is not WORLD_SIZE, ranks without
    torchrun's environment, a global batch the batch group does not divide,
    a tensor-parallel degree that does not divide the backbone's widths;
  * a step's global draws cut to a rank's rows (`StepNoise.for_rank`).
"""

import numpy as np
import pytest
import torch

from hop_tpu.parallel import create_mesh
from hop_tpu.parallel import zero2_spec as jax_zero2_spec

from hop_tpu_torch import config as tcfg
from hop_tpu_torch.models.bert import BertEncoder
from hop_tpu_torch.models.hop import HOPModel
from hop_tpu_torch.models.llama import LlamaEncoder
from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
from hop_tpu_torch.ops.dropout import fold_seed
from hop_tpu_torch.parallel import (GLOBAL_VIDS, Mesh, batch_rows, init_distributed, layout,
                                    resolve_degrees, zero2_spec)
from hop_tpu_torch.train.llm import StepNoise

LAYOUTS = [((1, 4, 2), dict(n_data=4, n_model=2)),
           ((2, 2, 2), dict(n_data=2, n_model=2, n_dcn=2))]


def _mesh(n_dcn, n_data, n_model, rank):
    return Mesh(n_dcn, n_data, n_model, rank, torch.device("cpu"))


@pytest.mark.parametrize("degrees,kw", LAYOUTS, ids=["data4_model2", "dcn2_data2_model2"])
def test_rank_layout_matches_create_mesh(degrees, kw):
    jmesh = create_mesh(**kw)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(degrees)
    np.testing.assert_array_equal(layout(*degrees), ids)
    names = ("dcn", "data", "model")
    for coord in np.ndindex(*degrees):
        mesh = _mesh(*degrees, int(ids[coord]))
        assert mesh.coords == coord
        # the groups: the ranks along hop_tpu's batch axes, its data axis and
        # its model axis through this device
        d, a, m = coord
        assert sorted(mesh.batch_ranks()) == sorted(ids[:, :, m].ravel().tolist())
        assert mesh.data_ranks() == ids[d, :, m].tolist()
        assert mesh.model_ranks() == ids[d, a, :].tolist()
        assert mesh.batch_rank == d * degrees[1] + a
    assert jmesh.axis_names == (names if degrees[0] > 1 else names[1:])


def _moment_shapes():
    cfg = tcfg.tiny_test_config("TED")
    nets = (HOPModel(cfg, 10), ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses))
    return sorted({tuple(p.shape) for net in nets for p in net.parameters()
                   if p.requires_grad})


@pytest.mark.parametrize("n_data", [2, 4, 8])
def test_zero2_spec_matches_hop_tpu(n_data):
    shapes = _moment_shapes()
    assert len(shapes) > 10
    n_sharded = 0
    for shape in shapes:
        spec = tuple(jax_zero2_spec(shape, n_data))
        want = spec.index("data") if "data" in spec else None
        assert zero2_spec(shape, n_data) == want, shape
        n_sharded += want is not None
    assert n_sharded > 5


def test_degrees_and_their_refusals(monkeypatch):
    assert resolve_degrees(8, 0, 2) == (1, 4, 2)
    assert resolve_degrees(8, 0, 2, 2) == (2, 2, 2)
    assert resolve_degrees(2, 2) == (1, 2, 1)
    assert resolve_degrees(1) == (1, 1, 1)
    with pytest.raises(SystemExit, match="= 12 ranks, but WORLD_SIZE is 8"):
        resolve_degrees(8, 3, 2, 2)
    with pytest.raises(SystemExit, match="WORLD_SIZE is 4"):
        resolve_degrees(4, 0, 8)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run --nproc-per-node N"):
        init_distributed("cpu", data_parallel=2)
    mesh = _mesh(1, 2, 1, 0)
    assert mesh.describe() == "mesh: data=2 x model=1"
    mesh.zero2 = True
    assert _mesh(2, 2, 2, 0).describe() == "mesh: dcn=2 x data=2 x model=2"
    assert mesh.describe().endswith("(zero2 opt-state sharding)")


def test_batch_rows_takes_the_rank_block_and_keeps_the_global_speakers():
    batch = {"target_vec": np.arange(8 * 3).reshape(8, 3), "vid_indices": np.arange(8) % 5}
    for rank, (d, a) in enumerate(np.ndindex(2, 2)):
        mesh = _mesh(2, 2, 1, rank)
        rows = batch_rows(batch, mesh)
        np.testing.assert_array_equal(rows["target_vec"], batch["target_vec"][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(rows[GLOBAL_VIDS], batch["vid_indices"])
    assert batch_rows(batch, None) is batch
    assert batch_rows(batch, _mesh(1, 1, 2, 1)) is batch     # model ranks share rows
    with pytest.raises(SystemExit, match="global batch 6 is not divisible by the 4"):
        batch_rows({"x": np.zeros((6, 1))}, _mesh(2, 2, 1, 0))


def test_tensor_parallel_degree_must_divide_the_backbone():
    bert = BertEncoder(tcfg.tiny_test_config("TED").llm)         # 4 heads, FFN 128
    with pytest.raises(SystemExit, match="--model-parallel 3 does not divide the "
                                         "backbone's n_heads 4, intermediate_dim 128"):
        bert.shard_(None, 0, 3)
    llama = LlamaEncoder(tcfg.tiny_llama_llm_config())           # 4 heads, 2 KV heads
    with pytest.raises(SystemExit, match="n_kv_heads 2"):
        llama.shard_(None, 0, 4)


def test_step_noise_for_rank_cuts_rows_and_folds_seeds():
    cfg = tcfg.tiny_test_config("TED")
    noise = StepNoise.draw(torch.Generator().manual_seed(1), cfg, 8)
    assert noise.for_rank(None, 8) is noise
    assert noise.for_rank(_mesh(1, 1, 2, 1), 8) is noise
    mesh = _mesh(1, 4, 1, 2)
    cut = noise.for_rank(mesh, 2)
    for name in ("eps", "eps_rand", "eps_dis", "target_noise", "fake_noise", "perm"):
        assert torch.equal(getattr(cut, name), getattr(noise, name)[4:6]), name
    for name in ("reprog_seed", "dropout_seed", "attn_seed"):
        assert getattr(cut, name) == fold_seed(getattr(noise, name), 2), name
    stages = StepNoise.draw_stages(torch.Generator().manual_seed(1), 3, 8, 4)
    assert torch.equal(stages.for_rank(mesh, 2).eps, stages.eps[:, 4:6])
