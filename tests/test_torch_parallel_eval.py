"""The validation pass's mesh branch (hop_tpu_torch.eval.evaluate with
`mesh`) on 2 ranks (gloo on the CPU, one thread a rank) against the
one-process pass and against hop_tpu's pass under `create_mesh(2, 1)`
(tests/test_parallel.py:158-219's setting): three batches of 16, 16 and 7
rows, the first two split by rows over the ranks and gathered before the
metrics, the ragged third run whole on every rank. The generator is
tests/test_parallel.py's stand-in, which both packages compute alike from
the batch and the speaker ids (hop_tpu's ids, handed to the port); the
feature net is hop_tpu's random EmbeddingNet carried by the converter.
A second pass draws the speaker ids and the stand-in's noise (through the
speaker latent's `reparameterize`) from a seeded generator: the 2-rank
pass must draw what the one-process pass draws.

Tolerances, test_torch_eval.py's for the pass on a stand-in generator: L1,
joint MAE, feature distance, BC and diversity 1e-5 relative, FGD 1e-3
relative (singular covariances). Both ranks return the same numbers.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hop_tpu.config import tiny_test_config
from hop_tpu.data import synthetic
from hop_tpu.eval.evaluate import evaluate_testset as jax_evaluate
from hop_tpu.eval.fgd import EmbeddingSpaceEvaluator as JaxEvaluator
from hop_tpu.eval.fgd import make_ted_feature_fn as jax_feature_fn
from hop_tpu.models.embedding_net import EmbeddingNet as JaxEmbeddingNet
from hop_tpu.parallel import create_mesh

from hop_tpu_torch import convert

from test_torch_parallel_tp import launch, one_torch_thread  # noqa: F401 (a fixture)

SIZES = (16, 16, 7)
REL = 1e-5
FGD_REL = 1e-3
FIELDS = ("loss", "mae", "feat_dist", "bc", "diversity")


def _gen(batch, vids, rng):
    base = jnp.roll(batch["target_vec"], 1, axis=1)
    amp = jnp.mean(jnp.abs(batch["in_audio"]), axis=1)
    off = (vids.astype(jnp.float32) / 100.0)[:, None, None]
    return base * 0.9 + off + 0.01 * amp[:, None, None]


def _assert_close(got, want):
    for k in FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=0, err_msg=k)
    np.testing.assert_allclose(got["frechet_dist"], want["frechet_dist"], rtol=FGD_REL)


@pytest.fixture(scope="module")
def passes(tmp_path_factory):
    cfg = tiny_test_config("TED")
    batches = []
    for i, n in enumerate(SIZES):
        nb = synthetic.make_batch(cfg, n, seed=10 + i)
        batches.append({"target_vec": np.asarray(nb["target_vec"]),
                        "in_audio": np.asarray(nb["in_audio"])})
    net = JaxEmbeddingNet(pose_dim=27, n_frames=cfg.data.n_poses, n_words=50, mode="pose")
    poses = jnp.zeros((2, cfg.data.n_poses, 27))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: net.init(
        k, None, None, poses[:, :4], poses, input_mode="pose"))(jax.random.PRNGKey(0)))
    rng = jax.random.PRNGKey(5)
    vids = []                # hop_tpu's draws (evaluate.py: one split a batch)
    for n in SIZES:
        rng, rng_vid, _ = jax.random.split(rng, 3)
        vids.append(np.asarray(jax.random.randint(rng_vid, (n,), 0, 10)))
    job = {"job": "eval", "batches": batches, "vids": vids,
           "net": convert.embedding_net_state_dict_from_jax(variables)}
    drawn = {**job, "draw": True}
    # the ranks run while hop_tpu's pass compiles
    pool = concurrent.futures.ThreadPoolExecutor(1)
    got = pool.submit(launch, {"data_parallel": 2, "jobs": {"eval": job, "eval_drawn": drawn}},
                      tmp_path_factory.mktemp("eval"), "eval", world=2)
    pool.shutdown(wait=False)
    with create_mesh(2, 1):
        r = jax_evaluate(({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
                         jax.jit(_gen), JaxEvaluator(jax_feature_fn(net, variables),
                                                     trained=False),
                         epoch=cfg.loss.bc_start_epoch + 1, cfg=cfg, n_speakers=10,
                         rng=jax.random.PRNGKey(5))
    want = dataclasses.asdict(r)
    import torch_parallel_worker
    one = torch_parallel_worker.eval_job(job, None)
    one_drawn = torch_parallel_worker.eval_job(drawn, None)
    got = got.result()
    return (want, one, [g["eval"] for g in got], one_drawn,
            [g["eval_drawn"] for g in got])


def test_sharded_pass_matches_one_process_and_jax(passes):
    want, one, ranks = passes[:3]
    _assert_close(one["result"], want)
    for rank in ranks:
        _assert_close(rank["result"], one["result"])
        _assert_close(rank["result"], want)
    assert ranks[0]["result"] == {**ranks[1]["result"], "elapsed_sec":
                                  ranks[0]["result"]["elapsed_sec"]}


def test_sharded_pass_draws_the_one_process_noise(passes):
    one, drawn, ranks = passes[1], passes[3], passes[4]
    assert drawn["result"]["loss"] != one["result"]["loss"]   # the noise counts
    for rank in ranks:
        assert rank["rows"] == [8, 8, 7]
        _assert_close(rank["result"], drawn["result"])


def test_divisible_batches_are_split_and_the_ragged_one_runs_whole(passes):
    _, one, ranks = passes[:3]
    assert one["rows"] == list(SIZES)
    for rank in ranks:
        assert rank["rows"] == [8, 8, 7]
