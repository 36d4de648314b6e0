"""One rank of the parallel tests' torch runs (tests/test_torch_parallel_*.py).

    python tests/torch_parallel_worker.py <spec.pt>

launched by `hop_tpu_torch.parallel.local.run_ranks` (torchrun's
environment, gloo on the CPU, one thread). It imports no jax: the pytest
process computes hop_tpu's side and hands this rank its inputs in the spec
(a `torch.save` dict); the rank writes what it computed to
`<spec["out"]>.<rank>.pt`, by job name. Kinds of job:

  * "step": HOP and trimodal train steps from given state dicts, batch and
    global draws (`StepNoise` fields); gradients, metrics, the nets' states
    and the optimizers' (gathered) state_dicts after each;
  * "tp": a backbone (BERT or LLaMA) sharded over the model group: its
    output and its input's gradient for a given cotangent;
  * "eval": `evaluate_testset` over given batches with a deterministic
    generator function and given speaker ids; with "draw", the speaker ids
    come from a seeded generator and the generator function adds noise
    drawn from it as the speaker latent draws it;
  * "hier": the hierarchy's (HA2G) warmup and GAN steps from given state
    dicts, batch and global draws, as "step" returns them, in the job's
    "dtype" (its nets, batch and draws);
  * "contrastive": `train.hierarchy.softmax_contrastive` of the rank's rows
    of two global feature blocks, its value and both blocks' gradients;
  * "hier_eval": `evaluate_testset` of a given hierarchy in eval mode over
    given batches, speaker ids and noise drawn from a seeded generator.

A spec holds named jobs, run in turn; a job's "zero2" sets ZeRO for its
optimizers, and its "fault" plants a known bug in this process for the job
(never in the port's files), for the tests that a comparison catches it: "local_bn" (BatchNorm
on the rank's rows alone), "no_copy" (no copy-to-group before the
column-parallel products), "bias_every_rank" (the row-parallel bias added
on every rank, before the sum), "local_pairs" (the hierarchy's contrastive
terms over the rank's own pairs alone).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from hop_tpu_torch import config as tcfg  # noqa: E402
from hop_tpu_torch.models import bert, common, llama  # noqa: E402
from hop_tpu_torch.parallel import attach_batch_group, batch_rows, init_distributed  # noqa: E402
from hop_tpu_torch.parallel.collectives import reduce_from_group  # noqa: E402
from hop_tpu_torch.parallel.mesh import destroy  # noqa: E402
from hop_tpu_torch.train import hierarchy as train_hierarchy  # noqa: E402


def plant(fault):
    """Plant `fault` (None: none) in this process; returns what undoes it."""
    saved = [(m, n, getattr(m, n)) for m, n in ((common, "global_mean_var"),
                                                 (bert, "copy_to_group"),
                                                 (llama, "copy_to_group"),
                                                 (bert, "_row_linear"),
                                                 (train_hierarchy, "softmax_contrastive"))]
    if fault == "local_bn":
        def local(x, dims, group, centered=False):
            mean = x.mean(dims)
            if centered:
                shape = [1, -1] + [1] * (x.dim() - 2)
                dev = x - mean.reshape(shape)
                return mean, (dev * dev).mean(dims)
            return mean, torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        common.global_mean_var = local
    elif fault == "no_copy":
        bert.copy_to_group = llama.copy_to_group = lambda x, group: x
    elif fault == "bias_every_rank":
        def row_linear(x, layer, dt, group):
            y = F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt)).float()
            return reduce_from_group(y, group).to(dt)
        bert._row_linear = row_linear
    elif fault == "local_pairs":
        whole = train_hierarchy.softmax_contrastive
        train_hierarchy.softmax_contrastive = (
            lambda a, b, chunk_pairs=train_hierarchy.CONTRASTIVE_CHUNK_PAIRS, group=None:
            whole(a, b, chunk_pairs))

    def undo():
        for m, n, v in saved:
            setattr(m, n, v)
    return undo


def _grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters()
            if p.requires_grad and p.grad is not None}


def _f32_tiny(fused=True):
    cfg = tcfg.tiny_test_config("TED")
    return cfg.replace(llm=dataclasses.replace(cfg.llm, compute_bf16=False),
                       hop=dataclasses.replace(cfg.hop, fused_step=fused))


def step_case(case, spec, mesh):
    from hop_tpu_torch.models.hop import HOPModel
    from hop_tpu_torch.models.multimodal_context import ConvDiscriminator, PoseGenerator
    from hop_tpu_torch.train.gan import make_gan_train_steps
    from hop_tpu_torch.train.llm import StepNoise, make_hop_train_steps

    cfg = _f32_tiny()
    data = spec[case["family"]]
    if case["family"] == "hop":
        gen = HOPModel(cfg, n_speakers=data["n_speakers"])
        gen.llm_model.dropout_rate = 0.0
        gen.reprogramming_layer.attention_dropout = 0.0
    else:
        gen = PoseGenerator(27, data["n_words"], data["n_speakers"],
                            cfg.baseline.hidden_size, cfg.baseline.n_layers)
    gen.load_state_dict(data["gen"], strict=True)
    disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    disc.load_state_dict(data["dis"], strict=True)
    for module in (gen, disc):
        for m in module.modules():
            for attr in ("dropout", "emb_dropout"):
                if isinstance(getattr(m, attr, None), float):
                    setattr(m, attr, 0.0)
    if case["family"] == "hop" and mesh.n_model > 1:
        gen.llm_model.shard_(mesh.model_group, mesh.model_rank, mesh.n_model)
    attach_batch_group(gen, mesh)
    attach_batch_group(disc, mesh)
    make = make_hop_train_steps if case["family"] == "hop" else make_gan_train_steps
    warmup, gan, init_state = make(cfg, gen, disc, mesh)
    state = init_state()
    step = warmup if case["kind"] == "warmup" else gan
    if hasattr(step, "for_epoch"):
        step = step.for_epoch(case["epoch"])
    batch = {k: torch.tensor(v) for k, v in batch_rows(data["batch"], mesh).items()}
    noise = StepNoise(**data["noise"][case["kind"]])
    state, metrics = step(state, batch, noise)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "gen_grads": _grads(gen), "dis_grads": _grads(disc),
            "gen": {k: v.clone() for k, v in gen.state_dict().items()},
            "dis": {k: v.clone() for k, v in disc.state_dict().items()},
            "gen_opt": state.gen_opt.state_dict(), "dis_opt": state.dis_opt.state_dict(),
            "zero_axes": state.gen_opt.axes if getattr(state.gen_opt, "zero", False) else None}


def _hier_nets(spec, dataset):
    """The hierarchy's nets at the spec's widths, from its state dicts."""
    from hop_tpu_torch.models.hierarchy import HierarchicalConvDiscriminator, HierarchyNet
    cfg = tcfg.tiny_test_config(dataset)
    cfg = cfg.replace(baseline=dataclasses.replace(cfg.baseline, hidden_size=spec["hidden"],
                                                   n_layers=spec["layers"]))
    data = spec[dataset]
    net = HierarchyNet(cfg, spec["n_words"], spec["n_speakers"],
                       resnet_layers=spec["resnet_layers"])
    net.load_state_dict(data["gen"], strict=True)
    disc = HierarchicalConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    disc.load_state_dict(data["dis"], strict=True)
    return cfg, net, disc


def hier_case(case, spec, mesh):
    from hop_tpu_torch.train.llm import StepNoise
    dtype = getattr(torch, spec.get("dtype", "float32"))
    cfg, net, disc = _hier_nets(spec, case["dataset"])
    net, disc = net.to(dtype), disc.to(dtype)
    for module in (net, disc):
        for m in module.modules():
            for attr in ("dropout", "emb_dropout"):
                if isinstance(getattr(m, attr, None), float):
                    setattr(m, attr, 0.0)
    attach_batch_group(net, mesh)
    attach_batch_group(disc, mesh)
    warmup, gan, init_state = train_hierarchy.make_hierarchy_train_steps(cfg, net, disc, mesh)
    state = init_state()
    data = spec[case["dataset"]]
    batch = {k: torch.tensor(v) for k, v in batch_rows(data["batch"], mesh).items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    noise = StepNoise(**{k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                         else v for k, v in data["noise"][case["kind"]].items()})
    state, metrics = (warmup if case["kind"] == "warmup" else gan)(state, batch, noise)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "gen_grads": _grads(net), "dis_grads": _grads(disc),
            "gen": {k: v.clone() for k, v in net.state_dict().items()},
            "dis": {k: v.clone() for k, v in disc.state_dict().items()},
            "gen_opt": state.gen_opt.state_dict(), "dis_opt": state.dis_opt.state_dict(),
            "zero_axes": state.gen_opt.axes if getattr(state.gen_opt, "zero", False) else None}


def contrastive_job(spec, mesh):
    rows = mesh.rows(len(spec["text"]) // mesh.batch_size)
    text, audio = (torch.tensor(spec[k][rows], requires_grad=True) for k in ("text", "audio"))
    out = {}
    for name, chunk_pairs in spec["chunks"].items():
        text.grad = audio.grad = None
        value = train_hierarchy.softmax_contrastive(text, audio, chunk_pairs, mesh.batch_group)
        value.backward()
        out[name] = {"value": value.item(), "text_grad": text.grad.clone(),
                     "audio_grad": audio.grad.clone()}
    return out


def hier_eval_job(spec, mesh):
    from hop_tpu_torch.eval.evaluate import evaluate_testset
    from hop_tpu_torch.eval.fgd import EmbeddingSpaceEvaluator, make_ted_feature_fn
    from hop_tpu_torch.models.embedding_net import EmbeddingNet
    cfg, net, _ = _hier_nets(spec, "TED")
    net.eval()
    feat = EmbeddingNet(pose_dim=27, n_frames=cfg.data.n_poses, n_words=spec["n_words"],
                        mode="pose")
    feat.load_state_dict(spec["feat_net"], strict=True)
    feat.eval()
    batches = [{k: torch.tensor(v) for k, v in b.items()} for b in spec["batches"]]
    r = evaluate_testset(iter(batches), lambda b, vids, g: net.generate(b, vids, g),
                         EmbeddingSpaceEvaluator(make_ted_feature_fn(feat), trained=False),
                         epoch=cfg.loss.bc_start_epoch + 1, cfg=cfg,
                         n_speakers=spec["n_speakers"],
                         generator=torch.Generator().manual_seed(spec["seed"]), mesh=mesh)
    return {"result": dataclasses.asdict(r)}


def tp_job(spec, mesh):
    llm = spec["llm"]
    enc = (bert.BertEncoder if llm.model == "BERT" else llama.LlamaEncoder)(llm)
    enc.load_state_dict(spec["sd"], strict=True)
    enc.shard_(mesh.model_group, mesh.model_rank, mesh.n_model)
    if llm.model == "BERT":
        enc.set_attention(spec["route"])
    x = torch.tensor(spec["x"], requires_grad=True)
    out = enc(x)
    (out * torch.tensor(spec["w"])).sum().backward()
    return {"out": out.detach(), "x_grad": x.grad}


def eval_job(spec, mesh):
    from hop_tpu_torch.eval.evaluate import evaluate_testset
    from hop_tpu_torch.eval.fgd import EmbeddingSpaceEvaluator, make_ted_feature_fn
    from hop_tpu_torch.models.embedding_net import EmbeddingNet

    cfg = tcfg.tiny_test_config("TED")
    net = EmbeddingNet(pose_dim=27, n_frames=cfg.data.n_poses, n_words=50, mode="pose")
    net.load_state_dict(spec["net"], strict=True)
    net.eval()
    calls = []

    def gen(batch, vids, generator):
        calls.append(batch["target_vec"].shape[0])
        base = torch.roll(batch["target_vec"], 1, dims=1)
        amp = torch.mean(torch.abs(batch["in_audio"]), dim=1)
        off = (vids.float() / 100.0)[:, None, None]
        out = base * 0.9 + off + 0.01 * amp[:, None, None]
        if draw:
            zero = torch.zeros(out.shape[0], 1)
            out = out + 0.1 * common.reparameterize(zero, zero, generator)[:, :, None]
        return out

    draw = spec.get("draw", False)
    batches = [{k: torch.tensor(v) for k, v in b.items()} for b in spec["batches"]]
    r = evaluate_testset(iter(batches), gen, EmbeddingSpaceEvaluator(
        make_ted_feature_fn(net), trained=False), epoch=cfg.loss.bc_start_epoch + 1,
        cfg=cfg, n_speakers=10,
        generator=torch.Generator().manual_seed(5) if draw else None,
        speaker_ids=None if draw else iter(torch.tensor(v) for v in spec["vids"]),
        mesh=mesh)
    return {"result": dataclasses.asdict(r), "rows": calls}


JOBS = {"step": lambda job, mesh: {c["name"]: step_case(c, job, mesh) for c in job["cases"]},
        "tp": lambda job, mesh: tp_job(job, mesh),
        "eval": lambda job, mesh: eval_job(job, mesh),
        "hier": lambda job, mesh: {c["name"]: hier_case(c, job, mesh) for c in job["cases"]},
        "contrastive": lambda job, mesh: contrastive_job(job, mesh),
        "hier_eval": lambda job, mesh: hier_eval_job(job, mesh)}


def main(path):
    torch.set_num_threads(1)
    spec = torch.load(path, weights_only=False)
    mesh = init_distributed("cpu", spec.get("data_parallel", 0),
                            spec.get("model_parallel", 1), spec.get("dcn_slices", 1))
    out = {"coords": mesh.coords}
    for name, job in spec["jobs"].items():
        undo = plant(job.get("fault"))
        mesh.zero2 = job.get("zero2", True) and mesh.n_data > 1
        out[name] = JOBS[job["job"]](job, mesh)
        undo()
    torch.save(out, f"{spec['out']}.{mesh.rank}.pt")
    destroy()


if __name__ == "__main__":
    main(sys.argv[1])
