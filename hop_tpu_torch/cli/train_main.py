"""Model build and training main, shared by run_ted and run_expressive (port
of hop_tpu/cli/train_main.py): the model switch for AD_LLM (the HOP
generator) and five families of the baseline zoo, `multimodal_context`
(PoseGenerator + ConvDiscriminator, train.gan), `seq2seq`
(train.seq2seq), `speech2gesture` (train.speech2gesture),
`joint_embedding` and `gesture_autoencoder` (EmbeddingNet, or at pose_dim
126 the MotionAE; train.embed), and `hierarchy` (HA2G: the ResNetSE audio
encoder, the text encoder and the 3- or 6-stage cascade, with the
HierarchicalConvDiscriminator; train.hierarchy, at the loss weights
hop_tpu's train_main.py:207-210 sets).

`train_main` builds the datasets, the nets from the seed, their train
steps, the validation pass and the checkpoint manager, restores the latest
checkpoint on `--resume`, and runs `train.loops.run_training`. A step's draws come from
`utils.prng.step_generator(seed, epoch, i)` and the batch order of epoch e
from seed + e, so a run stopped after epoch k and resumed ends as the
uninterrupted run does, bit for bit.

On the card the run sets `torch.backends.cudnn.deterministic`: cuDNN may
otherwise pick convolution backward algorithms that sum in a varying order
(gwnet's, ResNetSE's and the discriminator's convolutions), and a resumed
run would then drift from the uninterrupted one. It turns cuDNN's TF32 off:
the convolutions run in f32, as hop_tpu's do. The port's own kernels repeat bit
for bit (no atomics, ordered split-K).

The frozen backbone, BERT or LLaMA (`--llm-model`), is built from the seed
and, with `--llm-weights`, loaded from an HF checkpoint before the
optimizers are made (hop_tpu's train_main.py:55-61). A resume refuses a
checkpoint whose model family, dataset, seed or backbone differs from the
run's (hop_tpu records the family and does not check it; another family's
state could not load): the backbone is
not saved but rebuilt, from the seed or from `--llm-weights`, so another
seed or another (or a missing) weights path would silently train on from
another backbone (hop_tpu's train_main.py:306 reattaches whatever the new
arguments build, a random backbone when `--llm-weights` is left out).

The parallel path (hop_tpu's train_main.py:321-352): `--data-parallel`,
`--model-parallel` and `--dcn-slices` above 1, or a launch by torchrun,
make this process one rank of a `parallel.Mesh` (`init_distributed`),
printing hop_tpu's "mesh: ..." line. Every rank builds the same nets from
the seed and the same global batches from the data; it takes its rows
(`batch_rows`), its share of the frozen backbone (model > 1), and reduces
gradients, batch statistics and metrics over its batch group; with ZeRO
(default when data > 1, `--no-zero2` off) it holds its share of Adam's
moments. The hierarchy's contrastive terms run over all pairs of the
global batch (`train.hierarchy.softmax_contrastive` with the batch group);
`--model-parallel` alone leaves its nets replicated over the model group,
since it has no backbone to shard.
"""

from __future__ import annotations

import functools
import os

import torch

from hop_tpu_torch.cli import common as C
from hop_tpu_torch.config import Config
from hop_tpu_torch.models.embedding_net import build_embedding_net
from hop_tpu_torch.models.hierarchy import build_hierarchy
from hop_tpu_torch.models.hop import build_hop_model
from hop_tpu_torch.models.motion_ae import MotionAE
from hop_tpu_torch.models.multimodal_context import (build_discriminator,
                                                     build_pose_generator)
from hop_tpu_torch.models.seq2seq import build_seq2seq
from hop_tpu_torch.models.speech2gesture import build_s2g
from hop_tpu_torch.parallel import attach_batch_group, batch_rows, init_distributed, wants_ranks
from hop_tpu_torch.parallel.mesh import destroy
from hop_tpu_torch.train.embed import make_embed_train_step, make_motion_ae_train_step
from hop_tpu_torch.train.gan import build_pre_seq, make_gan_train_steps
from hop_tpu_torch.train.hierarchy import make_hierarchy_train_steps
from hop_tpu_torch.train.llm import make_hop_train_steps
from hop_tpu_torch.train.loops import run_training
from hop_tpu_torch.train.seq2seq import make_seq2seq_train_step
from hop_tpu_torch.train.speech2gesture import make_s2g_train_step
from hop_tpu_torch.utils.checkpoint import CheckpointManager
from hop_tpu_torch.utils.params import set_pretrained_embeddings
from hop_tpu_torch.utils.prng import step_generator

# run_metadata keys that must match on a resume: the model family and the
# dataset (what the state is), and what rebuilds the frozen backbone (the
# optimizers' state follows the parameter order besides)
RESUME_KEYS = ("seed", "model", "dataset", "llm_model", "llm_layers", "llm_dim",
               "llm_weights")


def deterministic_cudnn(device: torch.device) -> None:
    """cuDNN's deterministic algorithms, chosen without benchmarking, in f32
    (no TF32), for a run on the card."""
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False


def generate_from_state(cfg: Config, state, batch, vids, generator):
    """The validation pass's forward: the state's generator in eval mode,
    seeded with the batch's first n_seed_frames target frames."""
    state.model.eval()
    with torch.inference_mode():
        out, *_ = state.model(batch["in_audio"], batch["log_mel"], batch["text_padded"],
                              batch["target_vec"][:, :cfg.data.n_seed_frames], vids,
                              generator=generator)
    return out


def _inference(fn):
    """A generate_from_state: fn(net, batch, vids, generator) on the state's
    net in eval mode, without autograd."""
    def generate(state, batch, vids, generator):
        state.model.eval()
        with torch.inference_mode():
            return fn(state.model, batch, vids, generator)
    return generate


def build_model_and_steps(cfg: Config, args, lang, n_speakers: int, device, mesh=None):
    """Returns (state, warmup_step, gan_step, generate_from_state) for
    `args.model` (hop_tpu's switch, train_main.py:28-204): the generator
    (or the one net) from `args.seed`, a discriminator from `args.seed + 1`,
    on `device`; `gan_step` is None where the family has no GAN phase.
    Vocabulary-shaped embedding tables take `--wordembed-path`'s vectors
    (hop_tpu installs them in every family but AD_LLM and speech2gesture).
    On a rank of `mesh`: the nets' batch statistics over the batch group,
    HOP's backbone sharded over the model group, the steps the rank's."""
    name, seed, d = args.model, args.seed, cfg.data

    def pretrained(net):
        if args.wordembed_path and lang.word_embedding_weights is not None:
            n = set_pretrained_embeddings(net, lang.word_embedding_weights)
            print(f"loaded pretrained word embeddings into {n} table(s)")
        return net

    def ranked(*nets):
        for net in nets:
            attach_batch_group(net, mesh)
        return nets if len(nets) > 1 else nets[0]

    if name == "AD_LLM":
        model = build_hop_model(cfg, n_speakers, seed, device, mesh)
        if args.llm_weights:
            C.install_backbone(model, args.llm_weights, cfg.llm, args.hf_vocab)
        disc = build_discriminator(cfg, seed + 1, device)
        n_trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
        print(f"Total parameters: {n_trainable}")
        warmup, gan, init_state = make_hop_train_steps(cfg, *ranked(model, disc), mesh)
        return init_state(), warmup, gan, functools.partial(generate_from_state, cfg)

    if name == "multimodal_context":
        gen = pretrained(build_pose_generator(cfg, lang.n_words, n_speakers, seed, device))
        disc = build_discriminator(cfg, seed + 1, device)
        warmup, gan, init_state = make_gan_train_steps(cfg, *ranked(gen, disc), mesh)
        return init_state(), warmup, gan, _inference(lambda net, b, vids, g: net(
            build_pre_seq(b["target_vec"], d.n_pre_poses), b["text_padded"],
            b["in_audio"], vids, generator=g)[0])

    if name == "seq2seq":
        net = pretrained(build_seq2seq(cfg, lang.n_words, seed, device))
        step, init_state = make_seq2seq_train_step(cfg, ranked(net), mesh)
        return init_state(), step, None, _inference(lambda net, b, vids, g: net(
            b["word_seq"], b["text_mask"], b["target_vec"]))

    if name == "speech2gesture":
        gen, disc = build_s2g(cfg, seed, device)
        step, init_state = make_s2g_train_step(cfg, *ranked(gen, disc), mesh)
        return init_state(), step, step, _inference(lambda net, b, vids, g: net(
            b["spectrogram"], b["target_vec"][:, :d.n_pre_poses]))

    if name == "gesture_autoencoder" and d.pose_dim != 27:
        # the expressive feature net is a MotionAE (EmbeddingSpaceEvaluator.py
        # :411-414), trainable here end to end as in hop_tpu
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = MotionAE(d.pose_dim, cfg.baseline.motion_ae_latent_dim)
        step, init_state = make_motion_ae_train_step(cfg, ranked(net.to(device)), mesh)
        return init_state(), step, None, _inference(
            lambda net, b, vids, g: net(b["target_vec"])[0])

    if name in ("joint_embedding", "gesture_autoencoder"):
        mode = "random" if name == "joint_embedding" else "pose"
        net = pretrained(build_embedding_net(cfg, lang.n_words, mode, seed, device))
        step, init_state = make_embed_train_step(cfg, ranked(net), mode="pose", mesh=mesh)
        return init_state(), step, None, _inference(lambda net, b, vids, g: net(
            None, None, b["target_vec"][:, :d.n_pre_poses], b["target_vec"],
            input_mode="pose")[-1])

    if name == "hierarchy":
        net, disc = build_hierarchy(cfg, lang.n_words, n_speakers, seed, device)
        warmup, gan, init_state = make_hierarchy_train_steps(
            cfg, *ranked(pretrained(net), disc), mesh)
        return init_state(), warmup, gan, _inference(
            lambda net, b, vids, g: net.generate(b, vids, g))

    raise ValueError(f"unknown model {name}")


def train_main(cfg: Config, args):
    """Returns (state, best_fgd)."""
    cfg = C.apply_overrides(cfg, args)
    device, mesh = torch.device(args.device), None
    if wants_ranks(args.data_parallel, args.model_parallel, args.dcn_slices):
        mesh = init_distributed(device, args.data_parallel, args.model_parallel,
                                args.dcn_slices, zero2=not args.no_zero2,
                                backend=args.dist_backend)
        device = mesh.device
        print(mesh.describe())
    try:
        return _train(cfg, args, device, mesh)
    finally:
        if mesh is not None:
            destroy()


def _train(cfg: Config, args, device, mesh):
    deterministic_cudnn(device)
    ckpt = CheckpointManager(args.checkpoint_dir)
    # what rebuilds the frozen backbone; the weights path absolute, so that a
    # restore from another directory finds it
    run_keys = {"seed": args.seed, "model": args.model, "dataset": cfg.data.dataset,
                "llm_model": cfg.llm.model,
                "llm_layers": cfg.llm.n_layers, "llm_dim": cfg.llm.dim,
                "llm_weights": args.llm_weights and os.path.abspath(args.llm_weights)}
    resume = args.resume and ckpt.latest_step() is not None
    if resume:      # before anything is built: what rebuilds the backbone must match
        meta = ckpt.run_metadata()
        differ = {k: (meta.get(k), run_keys[k]) for k in RESUME_KEYS
                  if meta.get(k) != run_keys[k]}
        if differ:
            raise SystemExit(
                f"--resume: {args.checkpoint_dir} was trained with "
                + ", ".join(f"{k}={was!r}" for k, (was, _) in differ.items())
                + "; this run has "
                + ", ".join(f"{k}={now!r}" for k, (_, now) in differ.items())
                + ". The state is the model family's, the frozen backbone is "
                  "rebuilt from the seed or read from --llm-weights, and the "
                  "optimizer state follows the parameter order: resume with the "
                  "checkpoint's settings")
    train_ds, val_ds, lang = C.load_datasets(cfg, args)
    n_speakers = max(train_ds.speaker_model.n_words, 1)
    bs = min(cfg.train.batch_size, len(train_ds))
    print(f"train samples: {len(train_ds)}, val: {len(val_ds)}, "
          f"speakers: {n_speakers}, batch: {bs}, device: {device}")

    state, warmup, gan, generate = build_model_and_steps(cfg, args, lang, n_speakers,
                                                         device, mesh)
    evaluator = C.make_fgd_evaluator(cfg, lang.n_words, args.eval_net, device)
    eval_fn = C.make_eval_fn(cfg, val_ds, evaluator, generate, n_speakers, device,
                             prefetch=args.prefetch, mesh=mesh)
    batch_keys = C.MODEL_BATCH_KEYS[args.model]

    def train_batches(epoch):
        for hb in train_ds.batches(bs, shuffle=True, seed=args.seed + epoch):
            yield C.device_batch(batch_rows(hb, mesh), cfg, keys=batch_keys, device=device)

    ckpt.metadata = {"model": args.model, "dataset": cfg.data.dataset,
                     "n_speakers": n_speakers, "n_words": lang.n_words, **run_keys}

    start_epoch, best_fgd, div_history = 0, float("inf"), []
    if resume:
        state.load_state_dict(ckpt.restore())
        start_epoch = int(meta["epoch"]) + 1
        best_fgd = float(meta.get("best_fgd", float("inf")))
        div_history = list(meta.get("div_history", []))
        print(f"resumed from checkpoint epoch {start_epoch - 1} "
              f"(best FGD {best_fgd:.4f})")

    state, best_fgd = run_training(
        cfg, train_batches, warmup, gan, state,
        rng=functools.partial(step_generator, args.seed),
        eval_fn=eval_fn, checkpoint_manager=ckpt,
        metric_path=args.metrics, tensorboard_dir=args.tensorboard_dir,
        log_every=args.log_every,
        start_epoch=start_epoch, best_fgd=best_fgd,
        checkpoint_every=args.checkpoint_every,
        profile_dir=args.profile_dir, transfer_guard=args.transfer_guard,
        prefetch=args.prefetch, div_history=div_history, mesh=mesh)
    return state, best_fgd
