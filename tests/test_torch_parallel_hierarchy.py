"""The hierarchy (HA2G) on a batch split over 2 ranks (hop_tpu_torch.parallel;
gloo on the CPU, one thread a rank) against hop_tpu's hierarchy steps sharded
over `create_mesh(2, 1)`, at tests/test_torch_hierarchy_steps.py's thin
widths (stages and text encoder at hidden 16 and 2 layers, ResNetSE(layers=
(1, 1, 1, 1))), global batch 4 (2 rows a rank), from identical state: the
TED warmup and GAN steps and the TED Expressive warmup.

hop_tpu's steps run in f64 as that file runs them (its `hierarchy_runs`, with
the steps placed on the mesh: the state sharded with ZeRO, the batch over
`data`), JAX's draws for the global batch handed to the ranks as a
`StepNoise` (each rank takes its rows), dropout off; the tolerances are that
file's, unchanged (losses 2e-5 relative, each gradient 1e-4 of its largest
element, BatchNorm statistics 1e-5, updated parameters lr * 1e-3 where the
gradient is resolved). The ranks end bit for bit equal.

The ranks run in f64 too (nets, batch and draws). In f32 a rank's
convolutions over its 2 rows round otherwise than one process's over 4, and
at this batch that flips one ReLU of the ResNetSE's `conv_low` (1 of its
274176 outputs on rank 1 lies within round-off of 0): that element's
gradient reaches rank 1's audio encoder as 7e-3 of its largest activation
gradient, and `audio.layer1.0.conv2.weight`'s as 1.3e-3 of its largest,
where the one-process f32 step stays within 1.3e-5 of f64. In f64 the
2-rank step equals the one-process step to 8e-15 of each gradient's
largest element, so what these tests hold is the split's semantics; the
f32 split on the card is phase 30 of chip_smoke.py.

  * ZeRO (each rank holding half of Adam's moments) against `--no-zero2`:
    the parameters and the gathered optimizer states bitwise equal;
  * a planted fault, the contrastive terms over each rank's own pairs alone
    (set in the rank's process by tests/torch_parallel_worker.py), must fail
    the comparison;
  * `softmax_contrastive` split over the 2 ranks, in one chunk and in
    chunks, against the unsplit one: the mean of the ranks' values, and the
    gradients of both feature blocks after the mean over the ranks
    (`RankAdam`'s), at the loss functions' tolerances of that file;
  * the validation pass (`evaluate_testset` with the mesh) of the hierarchy
    on batches of 4, 4 and 3 rows (the last run whole on every rank), the
    speaker ids and the stages' noise drawn from a seeded generator, against
    the one-process pass at tests/test_torch_parallel_eval.py's tolerances.
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hop_tpu.data import synthetic as jsynthetic
from hop_tpu.models import hierarchy as JH
from hop_tpu.parallel import create_mesh, shard_batch, shard_state
from hop_tpu.train import hierarchy as jtrain

from hop_tpu_torch.eval.evaluate import evaluate_testset
from hop_tpu_torch.eval.fgd import EmbeddingSpaceEvaluator, make_ted_feature_fn
from hop_tpu_torch.models.embedding_net import EmbeddingNet
from hop_tpu_torch.models.hierarchy import HierarchicalConvDiscriminator, HierarchyNet
from hop_tpu_torch.train import hierarchy as T
from hop_tpu_torch.utils.checkpoint import differing_entries

from test_torch_hierarchy_steps import (HIDDEN, LAYERS, N_SPEAKERS, N_WORDS, THIN, _batch,
                                        _check_value_and_grads, _configs, _port_nets,
                                        check_stepped, hierarchy_runs, jax_hierarchy_noise)
from test_torch_parallel_eval import _assert_close
from test_torch_parallel_step import _with, launch
from test_torch_zoo_steps import no_dropout  # noqa: F401 (a fixture)
from test_torch_zoo_steps import one_torch_thread  # noqa: F401 (a fixture)

CASES = [{"name": "ted_warmup", "dataset": "TED", "kind": "warmup"},
         {"name": "ted_gan", "dataset": "TED", "kind": "gan"},
         {"name": "expr_warmup", "dataset": "TED_expressive", "kind": "warmup"}]
CHUNKS = {"one-chunk": T.CONTRASTIVE_CHUNK_PAIRS, "chunked": 1000}
EVAL_SIZES = (4, 4, 3)
EVAL_SEED = 5


def _on_mesh(make):
    """hop_tpu's `make_hierarchy_train_steps` whose steps run under
    `create_mesh(2, 1)`: the state placed with ZeRO, the batch over `data`."""
    def made(*args):
        warmup, gan, init_state = make(*args)
        mesh = create_mesh(2, 1)

        def sharded(step):
            def run(state, batch, key):
                with mesh:
                    return step(shard_state(state, mesh, zero2=True), shard_batch(batch, mesh),
                                key)
            return run
        return sharded(warmup), sharded(gan), init_state
    return made


def _noise_fields(noise):
    return {f.name: getattr(noise, f.name) for f in dataclasses.fields(noise)}


def _eval_batches(cfg_j):
    out = []
    for i, n in enumerate(EVAL_SIZES):
        b = jsynthetic.add_device_features(jsynthetic.make_batch(cfg_j, n, seed=10 + i), cfg_j)
        b = {k: np.asarray(b[k]) for k in ("spectrogram", "text_padded", "target_vec",
                                           "in_audio")}
        b["spectrogram"] = b["spectrogram"].astype(np.float32)
        b["text_padded"] = b["text_padded"] % N_WORDS
        out.append(b)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory, no_dropout):
    """The ranks' spec, launched at once on a thread, then hop_tpu's sharded
    steps (which compile meanwhile)."""
    spec = {"job": "hier", "cases": CASES, "hidden": HIDDEN, "layers": LAYERS,
            "resnet_layers": THIN, "n_words": N_WORDS, "n_speakers": N_SPEAKERS,
            "dtype": "float64"}
    for dataset in ("TED", "TED_expressive"):
        cfg, cfg_j = _configs(dataset)
        batch = _batch(cfg_j)
        net, disc = _port_nets(cfg)
        with jax.enable_x64(True):      # the draws as hierarchy_runs takes them
            noise = {kind: _noise_fields(jax_hierarchy_noise(
                len(JH.stage_bones(dataset)), batch["vid_indices"], kind))
                for kind in ("warmup", "gan")}
        spec[dataset] = {"gen": net.state_dict(), "dis": disc.state_dict(), "batch": batch,
                         "noise": noise}
    r = np.random.default_rng(8)
    text = r.normal(size=(136, 32)).astype(np.float32)
    text[100:] = text[99]                                   # padding repeats a row
    audio = r.normal(size=(136, 32)).astype(np.float32)
    _, cfg_j = _configs("TED")
    torch.manual_seed(1)
    feat_net = EmbeddingNet(pose_dim=27, n_frames=34, n_words=N_WORDS, mode="pose")
    evaluation = {"job": "hier_eval", "batches": _eval_batches(cfg_j), "seed": EVAL_SEED,
                  "feat_net": feat_net.state_dict(),
                  **{k: spec[k] for k in ("hidden", "layers", "resnet_layers", "n_words",
                                          "n_speakers", "TED")}}
    jobs = {"zero": dict(spec, zero2=True), "no_zero": dict(spec, zero2=False),
            "local_pairs": dict(spec, fault="local_pairs", cases=[CASES[0]]),
            "contrastive": {"job": "contrastive", "text": text, "audio": audio,
                            "chunks": CHUNKS},
            "eval": evaluation}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(launch, {"data_parallel": 2, "jobs": jobs},
                        tmp_path_factory.mktemp("hier"), "hier")
    pool.shutdown(wait=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "make_hierarchy_train_steps",
                   _on_mesh(jtrain.make_hierarchy_train_steps))
        want = {"TED": hierarchy_runs("TED"),
                "TED_expressive": hierarchy_runs("TED_expressive", kinds=("warmup",))}
    return want, jobs, ranks


@pytest.fixture(scope="module")
def ranks(setup):
    return setup[2].result()


def check_rank(got, runs, dataset, kind):
    """A rank's step against hop_tpu's sharded one, by
    test_torch_hierarchy_steps' checks: f32 modules holding the rank's f64
    state and gradients, rounded as hop_tpu's are."""
    cfg, _ = _configs(dataset)
    net = _with(HierarchyNet(cfg, N_WORDS, N_SPEAKERS, resnet_layers=THIN), got["gen"],
                {k: g.float() for k, g in got["gen_grads"].items()})
    disc = _with(HierarchicalConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses),
                 got["dis"], {k: g.float() for k, g in got["dis_grads"].items()})
    check_stepped({k: torch.tensor(v) for k, v in got["metrics"].items()}, net, disc, runs,
                  dataset, kind)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_two_ranks_match_the_sharded_jax_step(setup, ranks, case):
    want = setup[0]
    for got in ranks:
        check_rank(got["zero"][case["name"]], want[case["dataset"]], case["dataset"],
                   case["kind"])
    r0, r1 = (got["zero"][case["name"]] for got in ranks)
    keys = ("gen", "dis", "gen_opt", "dis_opt")
    assert differing_entries({k: r0[k] for k in keys}, {k: r1[k] for k in keys}) == []


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_zero2_is_bitwise_the_unsharded_optimizer(ranks, case):
    on, off = ranks[0]["zero"][case["name"]], ranks[0]["no_zero"][case["name"]]
    keys = ("gen", "dis", "gen_opt", "dis_opt", "metrics")
    assert differing_entries({k: on[k] for k in keys}, {k: off[k] for k in keys}) == []
    assert on["zero_axes"] and sum(ax is not None for ax in on["zero_axes"]) > 5
    assert off["zero_axes"] is None


def test_contrastive_terms_over_local_pairs_fail_the_comparison(setup, ranks):
    """The planted fault: each rank's softmax over its own rows' pairs (what a
    port without the gather computes)."""
    with pytest.raises(AssertionError):
        check_rank(ranks[0]["local_pairs"]["ted_warmup"], setup[0]["TED"], "TED", "warmup")


@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_split_contrastive_matches_the_unsplit_one(setup, ranks, chunk):
    job = setup[1]["contrastive"]
    text, audio = (torch.tensor(job[k], requires_grad=True) for k in ("text", "audio"))
    value = T.softmax_contrastive(text, audio, CHUNKS[chunk])
    value.backward()
    got = [r["contrastive"][chunk] for r in ranks]
    n = len(got)
    _check_value_and_grads(
        (value.item(), [text.grad.numpy(), audio.grad.numpy()]),
        (sum(g["value"] for g in got) / n,
         [torch.cat([g[k] for g in got]).numpy() / n for k in ("text_grad", "audio_grad")]))


def test_split_validation_pass_matches_one_process(setup, ranks):
    job = setup[1]["eval"]
    cfg, _ = _configs("TED")
    net = HierarchyNet(cfg, N_WORDS, N_SPEAKERS, resnet_layers=THIN)
    net.load_state_dict(job["TED"]["gen"], strict=True)
    net.eval()
    feat = EmbeddingNet(pose_dim=27, n_frames=34, n_words=N_WORDS, mode="pose")
    feat.load_state_dict(job["feat_net"], strict=True)
    feat.eval()
    want = evaluate_testset(
        iter([{k: torch.tensor(v) for k, v in b.items()} for b in job["batches"]]),
        lambda b, vids, g: net.generate(b, vids, g),
        EmbeddingSpaceEvaluator(make_ted_feature_fn(feat), trained=False),
        epoch=cfg.loss.bc_start_epoch + 1, cfg=cfg, n_speakers=N_SPEAKERS,
        generator=torch.Generator().manual_seed(EVAL_SEED))
    want = dataclasses.asdict(want)
    for r in ranks:
        _assert_close(r["eval"]["result"], want)
    assert ranks[0]["eval"]["result"] == {**ranks[1]["eval"]["result"], "elapsed_sec": ranks[0][
        "eval"]["result"]["elapsed_sec"]}
