"""HOP's generator and its ConvDiscriminator in plain PyTorch, float32 with
TF32 off, for the benchmark's check of what the port computes.

Written from the published model (Chenghyyy/HOP, model/HOP.py, model/gwnet.py,
train_llm.py; HF BertModel for the backbone), functional over a dict of
tensors keyed by the reference's state_dict names. It imports nothing of
the port. Where the configuration states a lower precision, this file
computes in it too:

* the frozen BERT backbone's products take bf16 operands and give a bf16
  result (`llm.compute_bf16`); its softmax runs on the bf16 scores;
  LayerNorm and the residual sums are f32;
* on the card, the reprogramming attention's q, k and v, and the gradient
  of its output, are rounded to bf16 before their products (f32
  accumulation, f32 softmax and f32 gradients), as the port's kernel K1
  does there; on the CPU the port computes that attention in f32, and so
  does this file.

Every other product is f32. Convolutions are written as products (einsum
over unfolded inputs), GRUs as a loop over time, BatchNorm with the batch
variance taken as E[x^2] - E[x]^2 (flax's rule, which the port keeps).

Dropout: the backbone's and the discriminator GRU's masks are drawn from a
device generator seeded by the step, in the order the step draws them;
the reprogramming attention's mask is a counter hash of (seed, head, row,
key), copied below from its published definition.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


# ---- shapes ---------------------------------------------------------------

def gru_specs(prefix: str, input_size: int, hidden: int, layers: int) -> list:
    specs = []
    for layer in range(layers):
        width = input_size if layer == 0 else 2 * hidden
        for sfx in ("", "_reverse"):
            specs += [(f"{prefix}weight_ih_l{layer}{sfx}", (3 * hidden, width)),
                      (f"{prefix}weight_hh_l{layer}{sfx}", (3 * hidden, hidden)),
                      (f"{prefix}bias_ih_l{layer}{sfx}", (3 * hidden,)),
                      (f"{prefix}bias_hh_l{layer}{sfx}", (3 * hidden,))]
    return specs


def linear_specs(name: str, n_in: int, n_out: int) -> list:
    return [(f"{name}.weight", (n_out, n_in)), (f"{name}.bias", (n_out,))]


def norm_specs(name: str, width: int, running: bool = False) -> list:
    specs = [(f"{name}.weight", (width,)), (f"{name}.bias", (width,))]
    if running:
        specs += [(f"{name}.running_mean", (width,)), (f"{name}.running_var", (width,)),
                  (f"{name}.num_batches_tracked", ())]
    return specs


def receptive_field(hop: dict) -> int:
    return 1 + hop["gwnet_blocks"] * (2 ** hop["gwnet_layers"] - 1)


def generator_specs(conf: dict, n_speakers: int) -> list:
    """(name, shape) of every tensor of HOP's generator."""
    d, llm, hop = conf["data"], conf["llm"], conf["hop"]
    z, dim, N = hop["z_size"], llm["dim"], conf["derived"]["n_joints_graph"]
    specs = [("speaker_embedding.0.weight", (n_speakers, z))]
    specs += linear_specs("speaker_embedding.1", z, z)
    specs += linear_specs("speaker_mu", z, z) + linear_specs("speaker_logvar", z, z)
    e = "llm_model.embeddings."
    specs += [(e + "word_embeddings.weight", (llm["vocab_size"], dim)),
              (e + "position_embeddings.weight", (llm["max_position"], dim)),
              (e + "token_type_embeddings.weight", (llm["type_vocab_size"], dim))]
    specs += norm_specs(e + "LayerNorm", dim)
    for i in range(llm["n_layers"]):
        p = f"llm_model.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            specs += linear_specs(p + "attention.self." + name, dim, dim)
        specs += linear_specs(p + "attention.output.dense", dim, dim)
        specs += norm_specs(p + "attention.output.LayerNorm", dim)
        specs += linear_specs(p + "intermediate.dense", dim, llm["intermediate_dim"])
        specs += linear_specs(p + "output.dense", llm["intermediate_dim"], dim)
        specs += norm_specs(p + "output.LayerNorm", dim)
    S, HE = hop["num_prototype_tokens"], hop["n_heads"] * hop["d_ff"]
    specs += [("mapping_layer.weight", (S, llm["vocab_size"])), ("mapping_layer.bias", (S,))]
    r = "reprogramming_layer."
    specs += linear_specs(r + "query_projection", hop["d_model"], HE)
    specs += linear_specs(r + "key_projection", dim, HE)
    specs += linear_specs(r + "value_projection", dim, HE)
    specs += linear_specs(r + "out_projection", HE, dim)
    specs += linear_specs("align_layer", 2 * dim, dim)
    specs += linear_specs("beat.0", hop["beat_window"], hop["beat_window"] // 2)
    specs += linear_specs("beat.2", hop["beat_window"] // 2, hop["beat_feat"])
    res, dil, skip, end = (hop["gwnet_residual"], hop["gwnet_dilation"],
                           hop["gwnet_skip"], hop["gwnet_end"])
    c_io = 3 + hop["beat_feat"]
    specs += [("gwnet.nodevec1", (N, hop["gwnet_node_emb"])),
              ("gwnet.nodevec2", (hop["gwnet_node_emb"], N)),
              ("gwnet.start_conv.weight", (res, c_io, 1, 1)), ("gwnet.start_conv.bias", (res,))]
    for i in range(hop["gwnet_blocks"] * hop["gwnet_layers"]):
        specs += [(f"gwnet.filter_convs.{i}.weight", (dil, res, 1, 2)),
                  (f"gwnet.filter_convs.{i}.bias", (dil,)),
                  (f"gwnet.gate_convs.{i}.weight", (dil, res, 1, 2)),
                  (f"gwnet.gate_convs.{i}.bias", (dil,)),
                  (f"gwnet.skip_convs.{i}.weight", (skip, dil, 1, 1)),
                  (f"gwnet.skip_convs.{i}.bias", (skip,)),
                  (f"gwnet.gconv.{i}.mlp.mlp.weight",
                   (res, (hop["gwnet_order"] + 1) * dil, 1, 1)),
                  (f"gwnet.gconv.{i}.mlp.mlp.bias", (res,))]
        specs += norm_specs(f"gwnet.bn.{i}", res, running=True)
    specs += [("gwnet.end_conv_1.weight", (end, skip, 1, 1)), ("gwnet.end_conv_1.bias", (end,)),
              ("gwnet.end_conv_2.weight", (c_io, end, 1, 1)), ("gwnet.end_conv_2.bias", (c_io,))]
    H = hop["hidden_size"]
    specs += gru_specs("gru.", conf["derived"]["gru_input_size"], H, hop["gru_layers"])
    specs += linear_specs("out.0", H, H // 2) + linear_specs("out.3", H // 2, d_pose(conf))
    return specs


def discriminator_specs(conf: dict) -> list:
    """(name, shape) of every tensor of the ConvDiscriminator."""
    P, T = d_pose(conf), conf["data"]["n_poses"]
    specs = [("pre_conv.0.weight", (16, P, 3)), ("pre_conv.0.bias", (16,))]
    specs += norm_specs("pre_conv.1", 16, running=True)
    specs += [("pre_conv.3.weight", (8, 16, 3)), ("pre_conv.3.bias", (8,))]
    specs += norm_specs("pre_conv.4", 8, running=True)
    specs += [("pre_conv.6.weight", (8, 8, 3)), ("pre_conv.6.bias", (8,))]
    specs += gru_specs("gru.", 8, DISC_HIDDEN, 4)
    specs += linear_specs("out", DISC_HIDDEN, 1) + linear_specs("out2", T - 6, 1)
    return specs


DISC_HIDDEN = 64
DISC_DROPOUT = 0.3


def d_pose(conf: dict) -> int:
    return conf["derived"]["pose_dim"]


def trainable(name: str) -> bool:
    """The generator's tensors that Adam updates: all but the frozen backbone
    and the BatchNorm running statistics."""
    return not name.startswith("llm_model.") and not is_buffer(name)


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var", "num_batches_tracked"))


# ---- pieces -----------------------------------------------------------------

class Draws:
    """The step's device generator: Bernoulli keep masks in draw order."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= rate
        return x * keep / (1.0 - rate)


class _RoundBF16(torch.autograd.Function):
    """x rounded to bf16 (held in f32); the gradient passes unrounded."""

    @staticmethod
    def forward(ctx, x):
        return x.to(BF16).float()

    @staticmethod
    def backward(ctx, g):
        return g


class _GradBF16(torch.autograd.Function):
    """Identity; the gradient is rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g.to(BF16).float()


MASK32 = 0xFFFFFFFF


def _mul32(x, c):
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & MASK32


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix(key, mult, idx):
    return _fmix32((key + _mul32(idx + 1, mult)) & MASK32)


def attention_keep(seed: int, rate: float, B: int, L: int, head: int, S: int,
                   device) -> torch.Tensor:
    """(B, L, S) f32 keep mask, 0 or 1 / (1 - rate), of one head of the
    reprogramming attention: bits = fmix32(rk + 0xC2B2AE3D (s + 1)) with
    rk = fmix32(hk + 0x85EBCA77 (row + 1)), row = b L + l, and hk =
    fmix32(seed + 0x9E3779B9 (head + 1)), in uint32 arithmetic (MurmurHash3's
    finaliser); kept where bits >= rate 2^32."""
    i64 = dict(dtype=torch.int64, device=device)
    hk = _mix(torch.tensor(seed & MASK32, **i64), 0x9E3779B9, torch.tensor(head, **i64))
    rk = _mix(hk, 0x85EBCA77, torch.arange(B * L, **i64)).reshape(B, L, 1)
    bits = _mix(rk, 0xC2B2AE3D, torch.arange(S, **i64))
    return (bits >= int(rate * 2 ** 32)).float() / (1.0 - rate)


def batch_norm(x, P, name, train: bool, eps: float = 1e-5):
    """BatchNorm over channel axis 1: batch statistics in training (biased
    variance, E[x^2] - E[x]^2 clipped at 0), running ones in evaluation."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        dims = [i for i in range(x.dim()) if i != 1]
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return y * P[name + ".weight"].reshape(shape) + P[name + ".bias"].reshape(shape)


def linear(x, P, name):
    return x @ P[name + ".weight"].t() + P[name + ".bias"]


def conv1x1(x, P, name):
    """(B, C, N, T) 1x1 convolution as a product over channels."""
    w = P[name + ".weight"][:, :, 0, 0]
    return torch.einsum("bcnt,oc->bont", x, w) + P[name + ".bias"][None, :, None, None]


def conv_pair(x, P, name, dilation: int):
    """(B, C, N, T) convolution of kernel (1, 2) at `dilation`, no padding."""
    w = P[name + ".weight"]
    T = x.shape[3] - dilation
    y = (torch.einsum("bcnt,oc->bont", x[..., :T], w[:, :, 0, 0])
         + torch.einsum("bcnt,oc->bont", x[..., dilation:], w[:, :, 0, 1]))
    return y + P[name + ".bias"][None, :, None, None]


def conv1d(x, P, name):
    """(B, C, T) convolution of kernel 3, stride 1, no padding."""
    w = P[name + ".weight"]
    cols = x.unfold(2, w.shape[2], 1)                       # (B, C, T', k)
    return torch.einsum("bctk,ock->bot", cols, w) + P[name + ".bias"][None, :, None]


def gru(x, P, prefix, layers: int, hidden: int, draws: Optional[Draws], rate: float,
        train: bool):
    """Bidirectional GRU stack, batch first: (B, T, F) -> (B, T, 2 H), gates
    r, z, n; zero initial state; dropout on the inputs of the layers after
    the first, drawn time-major (T, B, 2 H)."""
    H = hidden
    x_tm = x.transpose(0, 1)
    for layer in range(layers):
        if layer > 0 and train and rate > 0.0:
            x_tm = draws.drop(x_tm, rate)
        outs = []
        for sfx, reverse in (("", False), ("_reverse", True)):
            w_ih = P[f"{prefix}weight_ih_l{layer}{sfx}"]
            w_hh = P[f"{prefix}weight_hh_l{layer}{sfx}"]
            b_hh = P[f"{prefix}bias_hh_l{layer}{sfx}"]
            gi = x_tm @ w_ih.t() + P[f"{prefix}bias_ih_l{layer}{sfx}"]
            h = x_tm.new_zeros(x_tm.shape[1], H)
            seq = [None] * x_tm.shape[0]
            order = range(x_tm.shape[0] - 1, -1, -1) if reverse else range(x_tm.shape[0])
            for t in order:
                gh = h @ w_hh.t() + b_hh
                r = torch.sigmoid(gi[t, :, :H] + gh[:, :H])
                zg = torch.sigmoid(gi[t, :, H:2 * H] + gh[:, H:2 * H])
                n = torch.tanh(gi[t, :, 2 * H:] + r * gh[:, 2 * H:])
                h = (1.0 - zg) * n + zg * h
                seq[t] = h
            outs.append(torch.stack(seq))
        x_tm = torch.cat(outs, dim=-1)
    return x_tm.transpose(0, 1)


# ---- the generator ----------------------------------------------------------

def bert(P, conf, x, draws: Optional[Draws], rate: float):
    llm = conf["llm"]
    dt = BF16 if llm["compute_bf16"] else torch.float32
    eps = llm["layer_norm_eps"]
    B, T, dim = x.shape
    nh = llm["n_heads"]
    hd = dim // nh

    def lin(h, name):
        return F.linear(h.to(dt), P[name + ".weight"].to(dt), P[name + ".bias"].to(dt))

    def norm(h, name):
        return F.layer_norm(h, (dim,), P[name + ".weight"], P[name + ".bias"], eps)

    def drop(h):
        return draws.drop(h, rate) if rate > 0.0 else h

    e = "llm_model.embeddings."
    x = norm(x + P[e + "position_embeddings.weight"][:T][None]
             + P[e + "token_type_embeddings.weight"][0], e + "LayerNorm")
    x = drop(x)
    for i in range(llm["n_layers"]):
        p = f"llm_model.encoder.layer.{i}."
        q, k, v = (lin(x, p + "attention.self." + n).reshape(B, T, nh, hd).transpose(1, 2)
                   for n in ("query", "key", "value"))
        probs = drop(torch.softmax((q @ k.transpose(-1, -2)) / (hd ** 0.5), dim=-1))
        ctx = (probs.to(dt) @ v).transpose(1, 2).reshape(B, T, dim)
        attn = lin(ctx, p + "attention.output.dense")
        x = norm(x + drop(attn.float()), p + "attention.output.LayerNorm")
        h = F.gelu(lin(x, p + "intermediate.dense"), approximate="none")
        h = lin(h, p + "output.dense")
        x = norm(x + drop(h.float()), p + "output.LayerNorm")
    return x


def reprogramming(P, conf, x_enc, source, train: bool, seed: int):
    hop = conf["hop"]
    H, E = hop["n_heads"], hop["d_ff"]
    B, L, _ = x_enc.shape
    S = source.shape[0]
    r = "reprogramming_layer."
    card = x_enc.device.type == "cuda"
    rnd = _RoundBF16.apply if card else (lambda t: t)
    q = rnd(linear(x_enc, P, r + "query_projection")).reshape(B, L, H, E)
    k = rnd(linear(source, P, r + "key_projection")).reshape(S, H, E)
    v = rnd(linear(source, P, r + "value_projection")).reshape(S, H, E)
    heads = []
    for h in range(H):
        s = torch.einsum("ble,se->bls", q[:, :, h], k[:, h]) * (1.0 / math.sqrt(E))
        p = torch.softmax(s, dim=-1)
        if train:
            p = p * attention_keep(seed, REPROG_DROPOUT, B, L, h, S, x_enc.device)
        heads.append(torch.einsum("bls,se->ble", p, v[:, h]))
    out = torch.stack(heads, dim=2)                                  # (B, L, H, E)
    if card:
        out = _GradBF16.apply(out)
    return linear(torch.relu(out.reshape(B, L, H * E)), P, r + "out_projection")


REPROG_DROPOUT = 0.1
BERT_DROPOUT = 0.1


def beat_features(P, conf, in_audio):
    hop = conf["hop"]
    N = conf["derived"]["n_joints_graph"]
    windows = in_audio.unfold(1, hop["beat_window"], hop["beat_stride"])
    h = linear(windows, P, "beat.0")
    feat = linear(torch.where(h >= 0, h, 0.2 * h), P, "beat.2")        # (B, W, 170)
    n_win = feat.shape[1]
    flat = torch.arange(n_win * N, device=feat.device) % n_win
    return feat[:, flat].reshape(feat.shape[0], n_win, N, -1)


def gwnet(P, conf, x, train: bool):
    hop = conf["hop"]
    rf = receptive_field(hop)
    if x.shape[3] < rf:
        x = F.pad(x, (rf - x.shape[3], 0))
    adp = torch.softmax(torch.relu(P["gwnet.nodevec1"] @ P["gwnet.nodevec2"]), dim=1)
    x = conv1x1(x, P, "gwnet.start_conv")
    skip = None
    dilations = [2 ** i for _ in range(hop["gwnet_blocks"]) for i in range(hop["gwnet_layers"])]
    for i, d in enumerate(dilations):
        residual = x
        x = (torch.tanh(conv_pair(residual, P, f"gwnet.filter_convs.{i}", d))
             * torch.sigmoid(conv_pair(residual, P, f"gwnet.gate_convs.{i}", d)))
        s = conv1x1(x, P, f"gwnet.skip_convs.{i}")
        skip = s if skip is None else s + skip[..., -s.shape[3]:]
        outs, xk = [x], x
        for _ in range(hop["gwnet_order"]):
            xk = torch.einsum("bcvt,vw->bcwt", xk, adp)
            outs.append(xk)
        x = conv1x1(torch.cat(outs, dim=1), P, f"gwnet.gconv.{i}.mlp.mlp")
        x = x + residual[..., -x.shape[3]:]
        x = batch_norm(x, P, f"gwnet.bn.{i}", train)
    out = torch.relu(conv1x1(torch.relu(skip), P, "gwnet.end_conv_1"))
    return conv1x1(out, P, "gwnet.end_conv_2")


def speaker(P, vids, eps):
    ctx = linear(P["speaker_embedding.0.weight"][vids], P, "speaker_embedding.1")
    mu = linear(ctx, P, "speaker_mu")
    logvar = linear(ctx, P, "speaker_logvar")
    return mu + eps * torch.exp(0.5 * logvar), mu, logvar


def trunk(P, conf, batch, draws: Optional[Draws], train: bool, reprog_seed: int = 0):
    """Speaker-independent features (B, T, F): seed graph and flag, beat
    features, the backbone's output."""
    d, hop = conf["data"], conf["hop"]
    T, N = d["n_poses"], conf["derived"]["n_joints_graph"]
    in_audio, text = batch["in_audio"], batch["text_padded"]
    B = in_audio.shape[0]
    word = P["llm_model.embeddings.word_embeddings.weight"]
    text_emb = word[text]
    source = P["mapping_layer.weight"] @ word + P["mapping_layer.bias"][:, None]
    enc = reprogramming(P, conf, batch["log_mel"], source, train, reprog_seed)
    llm_in = linear(torch.cat([enc, text_emb], dim=-1), P, "align_layer")
    dec = bert(P, conf, llm_in, draws, BERT_DROPOUT if train else 0.0)

    beat_in = beat_features(P, conf, in_audio)
    pre_seq = batch["target_vec"][:, :d["n_seed_frames"]]
    seed = pre_seq.reshape(B, pre_seq.shape[1], N, 3)
    feature = gwnet(P, conf, torch.cat([seed, beat_in], dim=-1).permute(0, 3, 2, 1), train)
    g_seq = feature[:, :3].reshape(B, 3 * N, -1).transpose(1, 2)
    beat = feature[:, 3:].reshape(B, T, -1)
    t_out = g_seq.shape[1]
    flag = torch.zeros(B, T, 1, device=in_audio.device)
    flag[:, :t_out] = 1.0
    seq = torch.cat([g_seq, torch.zeros(B, T - t_out, 3 * N, device=in_audio.device)], dim=1)
    return torch.cat([seq, flag, beat, dec], dim=-1)


def head(P, conf, features, z):
    H = conf["hop"]["hidden_size"]
    rep = z[:, None, :].expand(-1, features.shape[1], -1)
    out = gru(torch.cat([features, rep], dim=-1).float(), P, "gru.",
              conf["hop"]["gru_layers"], H, None, 0.0, False)
    return linear(linear(out[..., :H] + out[..., H:], P, "out.0"), P, "out.3")


def generate(P, conf, batch, eps):
    """The evaluation-mode forward: (B, T, pose_dim) poses."""
    z, _, _ = speaker(P, batch["vid_indices"], eps)
    return head(P, conf, trunk(P, conf, batch, None, train=False), z)


def discriminator(D, conf, poses, draws: Draws):
    """Training-mode ConvDiscriminator: (B, T, pose_dim) -> (B, 1)."""
    x = poses.transpose(1, 2)
    x = batch_norm(conv1d(x, D, "pre_conv.0"), D, "pre_conv.1", True)
    x = batch_norm(conv1d(x, D, "pre_conv.3"), D, "pre_conv.4", True)
    x = conv1d(x, D, "pre_conv.6").transpose(1, 2)                   # (B, T - 6, 8)
    out = gru(x, D, "gru.", 4, DISC_HIDDEN, draws, DISC_DROPOUT, True)
    out = out[..., :DISC_HIDDEN] + out[..., DISC_HIDDEN:]
    out = linear(out, D, "out")[..., 0]
    return torch.sigmoid(linear(out, D, "out2"))
