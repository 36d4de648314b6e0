"""Operations and bytes of HOP's kernels and of its whole step, counted from
the configuration's shapes (a multiply-add is two operations).

K1, the reprogramming attention: the forward is two products over (B L) query
rows, H heads, S prototypes and head width E, 4 B L H S E operations; the
backward five, 10 B L H S E. Its bytes are each operand read once (q, k, v
in bf16) and each result written once (f32).

K2, a bidirectional GRU layer on the fused route: the forward's input
projection and recurrence are D T B 3H (2 I + 2 H) operations; the backward
(dx, dW_ih, dW_hh and the recurrence's dh) twice that. Its bytes: the input,
the weights, the output (and, where a graph is kept, the four gate streams
it saves) once each; the backward reads those and writes the gradients.

`train_step_flops` and `generate_flops` count every product of the model:
forward of every part, and in the backward the products each part needs:
the input's gradient where what feeds it is trained, the weights' gradient
where they are trained (the frozen backbone: the input's gradient alone, so
that the reprogramming layer below it learns).
"""

from __future__ import annotations


def _dims(conf: dict):
    d, llm, hop = conf["data"], conf["llm"], conf["hop"]
    return d, llm, hop, conf["derived"]


# ---- K1 ------------------------------------------------------------------

def k1_fwd(B: int, L: int, H: int, E: int, S: int, lse: bool = False):
    """(operations, bytes) of one forward launch."""
    flops = 4 * B * L * H * S * E
    nbytes = 2 * (B * L * H * E + 2 * H * S * E) + 4 * B * L * H * E + (4 * B * L * H if lse else 0)
    return flops, nbytes


def k1_bwd(B: int, L: int, H: int, E: int, S: int):
    flops = 10 * B * L * H * S * E
    reads = 2 * (2 * B * L * H * E + 2 * H * S * E) + 4 * (B * L * H * E + B * L * H)
    writes = 4 * (B * L * H * E + 2 * H * S * E)
    return flops, reads + writes


def k1_launches(conf: dict, B: int, train: bool) -> list:
    """[(kind, operations, bytes)] of K1 in one step (train) or forward."""
    _, _, hop, _ = _dims(conf)
    shape = (B, conf["data"]["n_poses"], hop["n_heads"], hop["d_ff"], hop["num_prototype_tokens"])
    out = [("fwd", *k1_fwd(*shape, lse=train))]
    if train:
        out.append(("bwd", *k1_bwd(*shape)))
    return out


# ---- K2 ------------------------------------------------------------------

def k2_fwd(T: int, B: int, I: int, H: int, D: int, residuals: bool = False):
    flops = D * T * B * 3 * H * 2 * (I + H)
    weights = 4 * D * 3 * H * (I + H + 2)
    streams = 4 * D * T * B * H * (5 if residuals else 1)
    return flops, 4 * T * B * I + weights + streams


def k2_bwd(T: int, B: int, I: int, H: int, D: int):
    flops = 2 * D * T * B * 3 * H * 2 * (I + H)
    weights = 4 * D * 3 * H * (I + H + 2)
    reads = 4 * T * B * I + weights + 4 * D * T * B * H * 6     # g, r, z, n, hnb, hprev
    writes = 4 * T * B * I + weights + 4 * D * B * H
    return flops, reads + writes


def _gru_layers(input_size: int, hidden: int, layers: int):
    return [input_size if k == 0 else 2 * hidden for k in range(layers)]


def k2_launches(conf: dict, B: int, train: bool) -> list:
    """[(kind, operations, bytes)] of K2 in one fused GAN step (train) or one
    evaluation forward: the head's layers (in the step: with a graph, then
    the shuffled speakers' pass without, then the backward), and in the step
    the discriminator's layers in its three passes and their backwards."""
    d, _, hop, der = _dims(conf)
    T, H = d["n_poses"], hop["hidden_size"]
    head = _gru_layers(der["gru_input_size"], H, hop["gru_layers"])
    if not train:
        return [("fwd", *k2_fwd(T, B, I, H, 2)) for I in head]
    out = [("fwd", *k2_fwd(T, B, I, H, 2, residuals=True)) for I in head]
    out += [("fwd", *k2_fwd(T, B, I, H, 2)) for I in head]
    out += [("bwd", *k2_bwd(T, B, I, H, 2)) for I in head]
    disc = _gru_layers(8, DISC_HIDDEN, 4)
    for _ in range(3):
        out += [("fwd", *k2_fwd(T - 6, B, I, DISC_HIDDEN, 2, residuals=True)) for I in disc]
        out += [("bwd", *k2_bwd(T - 6, B, I, DISC_HIDDEN, 2)) for I in disc]
    return out


DISC_HIDDEN = 64


# ---- the whole step ---------------------------------------------------------

def _mm(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def _gwnet(conf: dict, B: int) -> int:
    _, _, hop, der = _dims(conf)
    N = der["n_joints_graph"]
    res, dil, skip, end = (hop["gwnet_residual"], hop["gwnet_dilation"],
                           hop["gwnet_skip"], hop["gwnet_end"])
    c_io = 3 + hop["beat_feat"]
    rf = 1 + hop["gwnet_blocks"] * (2 ** hop["gwnet_layers"] - 1)
    T = max(conf["data"]["n_seed_frames"], rf)
    total = _mm(B * N * T, c_io, res)
    for _ in range(hop["gwnet_blocks"]):
        for i in range(hop["gwnet_layers"]):
            T -= 2 ** i
            rows = B * N * T
            total += 2 * _mm(rows, 2 * res, dil)                 # filter and gate
            total += _mm(rows, dil, skip)
            total += hop["gwnet_order"] * 2 * B * dil * N * N * T
            total += _mm(rows, (hop["gwnet_order"] + 1) * dil, res)
    return total + _mm(B * N * T, skip, end) + _mm(B * N * T, end, c_io)


def _gru(T: int, B: int, widths, H: int) -> int:
    return sum(2 * T * B * 3 * H * 2 * (I + H) for I in widths)


def _parts(conf: dict, B: int) -> dict:
    """Forward operations of each part at batch B, and the share of it that
    its backward costs: {part: (forward, backward multiple)}."""
    d, llm, hop, der = _dims(conf)
    T, dim, S = d["n_poses"], llm["dim"], hop["num_prototype_tokens"]
    HE = hop["n_heads"] * hop["d_ff"]
    rows = B * T
    layer = (4 * _mm(rows, dim, dim) + _mm(rows, dim, llm["intermediate_dim"])
             + _mm(rows, llm["intermediate_dim"], dim))
    attn = 2 * 2 * B * llm["n_heads"] * T * T * (dim // llm["n_heads"])
    H = hop["hidden_size"]
    beat_rows = B * ((d["expected_audio_length"] - hop["beat_window"]) // hop["beat_stride"] + 1)
    return {
        "mapping": (_mm(S, llm["vocab_size"], dim), 1),            # weights' gradient
        "reprog_q": (_mm(rows, hop["d_model"], HE), 1),
        "reprog_kv": (2 * _mm(S, dim, HE), 2),
        "k1": (k1_fwd(B, T, hop["n_heads"], hop["d_ff"], S)[0], 2.5),
        "reprog_out": (_mm(rows, HE, dim), 2),
        "align": (_mm(rows, 2 * dim, dim), 2),
        "backbone_dense": (llm["n_layers"] * layer, 1),            # input's gradient
        "backbone_attention": (llm["n_layers"] * attn, 2),
        "beat_0": (_mm(beat_rows, hop["beat_window"], hop["beat_window"] // 2), 1),
        "beat_2": (_mm(beat_rows, hop["beat_window"] // 2, hop["beat_feat"]), 2),
        "gwnet": (_gwnet(conf, B), 2),
        "head": (_gru(T, B, _gru_layers(der["gru_input_size"], H, hop["gru_layers"]), H), 2),
        "out": (_mm(rows, H, H // 2) + _mm(rows, H // 2, der["pose_dim"]), 2),
    }


def _discriminator(conf: dict, B: int) -> int:
    T, P = conf["data"]["n_poses"], conf["derived"]["pose_dim"]
    convs = _mm(B * (T - 2), 3 * P, 16) + _mm(B * (T - 4), 48, 8) + _mm(B * (T - 6), 24, 8)
    return (convs + _gru(T - 6, B, _gru_layers(8, DISC_HIDDEN, 4), DISC_HIDDEN)
            + _mm(B * (T - 6), DISC_HIDDEN, 1) + _mm(B, T - 6, 1))


def generate_flops(conf: dict, B: int) -> int:
    """Operations of one evaluation forward at batch B."""
    return sum(f for f, _ in _parts(conf, B).values())


def train_step_flops(conf: dict, B: int) -> int:
    """Operations of one fused GAN step at batch B: every part forward and
    backward, the head's second pass (shuffled speakers) forward, the
    discriminator's three passes forward and their backwards (the G term's
    the input's gradient alone)."""
    parts = _parts(conf, B)
    total = sum(f * (1 + m) for f, m in parts.values())
    total += parts["head"][0] + parts["out"][0]
    disc = _discriminator(conf, B)
    return int(total + 3 * disc + 2 * 2 * disc + disc)
