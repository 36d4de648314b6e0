"""flax HOPModel and ConvDiscriminator variables -> this port's state_dicts.

`state_dict_from_jax` is the inverse of
`hop_tpu.eval.torch_import_hop.convert_hop_model`, frozen backbone
included (the inverse of `hop_tpu.models.bert.convert_hf_bert_params` or,
with `cfg.llm.model == "LLAMA"`, of `hop_tpu.models.llama.
convert_hf_llama_params`); it
covers what `hop_tpu.eval.torch_export_hop.export_hop_state_dict` exports
plus the `llm_model.*` weights. `discriminator_state_dict_from_jax` is
the inverse of `hop_tpu.eval.torch_import_generator.
convert_conv_discriminator`. `embedding_net_state_dict_from_jax` and
`motion_ae_state_dict_from_jax` are the inverses of
`hop_tpu.eval.torch_import.convert_embedding_net_pose` and
`convert_motion_ae` (the FGD feature nets); the former also converts the
joint-embedding mode (ContextEncoder, PoseDecoderGRU), for which hop_tpu has
no importer. The baseline zoo's: `pose_generator_state_dict_from_jax`,
`seq2seq_state_dict_from_jax`, `s2g_generator_state_dict_from_jax` and
`s2g_discriminator_state_dict_from_jax` are the inverses of
`hop_tpu.eval.torch_import_generator`'s `convert_pose_generator`,
`convert_seq2seq`, `convert_s2g_generator` and
`convert_s2g_discriminator`. The hierarchy's: a cascade stage converts as a
PoseGenerator without its WavEncoder (the inverse of
`convert_hierarchical_generator`), the HierarchicalConvDiscriminator as the
ConvDiscriminator; `resnet_se_state_dict_from_jax` inverts
`convert_resnet_se`, `gru_discriminator_state_dict_from_jax` converts the
GRU discriminators (HierarchicalDiscriminator, the text Discriminator), and
`hierarchy_state_dict_from_jax` the whole generator side of hop_tpu's
train_main. The other way, `embedding_net_to_jax` and `motion_ae_to_jax`
give the FGD feature nets' flax trees, which `save_npz_variables` writes
as `save_arrays` does (`eval.export_eval_net`). No jax here: the caller hands
over the variable tree `{"params": ..., "batch_stats": ...}` with numpy
leaves (unboxed); `load_npz_variables` reads that tree from the flat .npz
that `hop_tpu.utils.checkpoint.save_arrays` writes.

Layout rules: Dense (in, out) -> Linear weight (out, in); Dense as 1x1
conv -> Conv2d (out, in, 1, 1); gwnet temporal conv (k, 1, in, out) ->
Conv2d (out, in, 1, k); Conv (k, in, out) -> Conv1d (out, in, k);
ConvTranspose (k, in, out) -> ConvTranspose1d (in, out, k), k flipped;
Conv (kh, kw, in, out) -> Conv2d (out, in, kh, kw); weight norm v (k, in,
out) -> weight_v (out, in, k), g (out,) -> weight_g (out, 1, 1);
LayerNorm/BatchNorm scale -> weight; the GRU and the mapping layer
already keep torch's layout. The GRU's parameters have the same names and
shapes on both of its routes (`ops.gru.GRU(kernel="fused" | "stack")`), so
one state_dict serves either (tests/test_torch_gru.py pins it).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from hop_tpu_torch.config import Config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _lin(sd, name, p):
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).T)
    sd[name + ".bias"] = _t(p["bias"])


def _conv1x1(sd, name, p):
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
    sd[name + ".bias"] = _t(p["bias"])


def _temporal_conv(sd, name, p):
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 1, 0))
    sd[name + ".bias"] = _t(p["bias"])


def _norm(sd, name, p):
    sd[name + ".weight"] = _t(p["scale"])
    sd[name + ".bias"] = _t(p["bias"])


def _bn(sd, name, p, s):
    _norm(sd, name, p)
    sd[name + ".running_mean"] = _t(s["mean"])
    sd[name + ".running_var"] = _t(s["var"])
    sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _gru(sd, prefix, p):
    for name, arr in p.items():
        # w_ih_l0[_reverse] -> weight_ih_l0[_reverse]: same layout
        torch_name = name.replace("w_", "weight_", 1).replace("b_", "bias_", 1)
        sd[prefix + torch_name] = _t(arr)


def _bert(sd, prefix, p, n_layers):
    e = prefix + "embeddings."
    sd[e + "word_embeddings.weight"] = _t(p["word_embeddings"]["embedding"])
    sd[e + "position_embeddings.weight"] = _t(p["position_embeddings"]["embedding"])
    sd[e + "token_type_embeddings.weight"] = _t(p["token_type_embeddings"]["embedding"])
    _norm(sd, e + "LayerNorm", p["embed_ln"])
    for i in range(n_layers):
        lp = p[f"layer_{i}"]
        n = f"{prefix}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            _lin(sd, n + "attention.self." + name, lp["attention"][name])
        _lin(sd, n + "attention.output.dense", lp["attention"]["out"])
        _norm(sd, n + "attention.output.LayerNorm", lp["attention_ln"])
        _lin(sd, n + "intermediate.dense", lp["intermediate"])
        _lin(sd, n + "output.dense", lp["output"])
        _norm(sd, n + "output.LayerNorm", lp["output_ln"])


def _llama(sd, prefix, p, n_layers):
    """The inverse of `hop_tpu.models.llama.convert_hf_llama_params`: Dense
    kernels transposed, RMSNorm scale -> weight, HF LlamaModel's names."""
    sd[prefix + "embed_tokens.weight"] = _t(p["word_embeddings"]["embedding"])
    for i in range(n_layers):
        lp = p[f"layer_{i}"]
        n = f"{prefix}layers.{i}."
        sd[n + "input_layernorm.weight"] = _t(lp["input_ln"]["scale"])
        sd[n + "post_attention_layernorm.weight"] = _t(lp["post_attention_ln"]["scale"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{n}self_attn.{name}.weight"] = _t(
                np.asarray(lp["self_attn"][name]["kernel"]).T)
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{n}mlp.{name}.weight"] = _t(np.asarray(lp["mlp"][name]["kernel"]).T)
    sd[prefix + "norm.weight"] = _t(p["final_norm"]["scale"])


def state_dict_from_jax(variables, cfg: Config) -> "OrderedDict[str, torch.Tensor]":
    """HOPModel variables (numpy leaves) -> HOPModel state_dict for this port."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    sp = params["speaker"]
    sd["speaker_embedding.0.weight"] = _t(sp["Embed_0"]["embedding"])
    _lin(sd, "speaker_embedding.1", sp["Dense_0"])
    _lin(sd, "speaker_mu", sp["Dense_1"])
    _lin(sd, "speaker_logvar", sp["Dense_2"])

    backbone = _llama if cfg.llm.model == "LLAMA" else _bert
    backbone(sd, "llm_model.", params["llm"], cfg.llm.n_layers)

    if cfg.hop.use_reprogramming:
        sd["mapping_layer.weight"] = _t(params["mapping_layer"]["kernel"])
        sd["mapping_layer.bias"] = _t(params["mapping_layer"]["bias"])
        for name in ("query_projection", "key_projection",
                     "value_projection", "out_projection"):
            _lin(sd, f"reprogramming_layer.{name}",
                 params["reprogramming_layer"][name])
        _lin(sd, "align_layer", params["align_layer"])

    if cfg.hop.use_gwnet:
        _lin(sd, "beat.0", params["beat_fc1"])
        _lin(sd, "beat.2", params["beat_fc2"])
        gw_p, gw_s = params["gwnet"], stats["gwnet"]
        sd["gwnet.nodevec1"] = _t(gw_p["nodevec1"])
        sd["gwnet.nodevec2"] = _t(gw_p["nodevec2"])
        _conv1x1(sd, "gwnet.start_conv", gw_p["start_conv"])
        for i in range(cfg.hop.gwnet_blocks * cfg.hop.gwnet_layers):
            _temporal_conv(sd, f"gwnet.filter_convs.{i}", gw_p[f"filter_{i}"])
            _temporal_conv(sd, f"gwnet.gate_convs.{i}", gw_p[f"gate_{i}"])
            _conv1x1(sd, f"gwnet.skip_convs.{i}", gw_p[f"skip_{i}"])
            _conv1x1(sd, f"gwnet.gconv.{i}.mlp.mlp", gw_p[f"gcn_{i}"]["Dense_0"])
            _bn(sd, f"gwnet.bn.{i}", gw_p[f"bn_{i}"], gw_s[f"bn_{i}"])
        _conv1x1(sd, "gwnet.end_conv_1", gw_p["end_conv_1"])
        _conv1x1(sd, "gwnet.end_conv_2", gw_p["end_conv_2"])
    else:
        _wav_encoder(sd, "audio_encoder.", params["audio_encoder"],
                     stats["audio_encoder"])

    _gru(sd, "gru.", params["gru"])
    _lin(sd, "out.0", params["out_fc1"])
    _lin(sd, "out.3", params["out_fc2"])
    return sd


def discriminator_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """ConvDiscriminator variables (numpy leaves) -> the port's
    ConvDiscriminator state_dict (pre_conv.{0,3,6} convs, pre_conv.{1,4}
    BatchNorm, gru.*, out, out2)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for j, ci in enumerate((0, 3, 6)):
        p = params[f"Conv_{j}"]
        sd[f"pre_conv.{ci}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        sd[f"pre_conv.{ci}.bias"] = _t(p["bias"])
    for j, bi in enumerate((1, 4)):
        _bn(sd, f"pre_conv.{bi}", params[f"BatchNorm_{j}"]["BatchNorm_0"],
            stats[f"BatchNorm_{j}"]["BatchNorm_0"])
    _gru(sd, "gru.", params["GRU_0"])
    _lin(sd, "out", params["Dense_0"])
    _lin(sd, "out2", params["Dense_1"])
    return sd


def load_npz_variables(path: str) -> dict:
    """The flat .npz of `hop_tpu.utils.checkpoint.save_arrays` (keys are
    the tree's path joined by "/", e.g. "params/pose_encoder/Conv_0/kernel")
    -> the nested tree of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree


def _conv1d(sd, name, p):
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    sd[name + ".bias"] = _t(p["bias"])


def _conv_transpose1d(sd, name, p):
    # flax ConvTranspose(padding="VALID") applies the kernel flipped
    # against torch's (hop_tpu/eval/torch_import.py `_convT`)
    sd[name + ".weight"] = _t(np.asarray(p["kernel"])[::-1].transpose(1, 2, 0))
    sd[name + ".bias"] = _t(p["bias"])


def _conv_encoder(sd, prefix, p, s):
    """The three ConvNormRelu blocks, the last conv and out_net's dense and
    BatchNorm layers shared by PoseEncoderConv and MotionPoseEncoder."""
    for i in range(3):
        block = f"ConvNormRelu_{i}"
        _conv1d(sd, f"{prefix}.net.{i}.0", p[block]["Conv_0"])
        _bn(sd, f"{prefix}.net.{i}.1", p[block]["BatchNorm_0"]["BatchNorm_0"],
            s[block]["BatchNorm_0"]["BatchNorm_0"])
    _conv1d(sd, f"{prefix}.net.3", p["Conv_0"])
    for j, (dense, norm) in enumerate(((0, 1), (3, 4))):
        _lin(sd, f"{prefix}.out_net.{dense}", p[f"Dense_{j}"])
        _bn(sd, f"{prefix}.out_net.{norm}", p[f"BatchNorm_{j}"]["BatchNorm_0"],
            s[f"BatchNorm_{j}"]["BatchNorm_0"])
    _lin(sd, f"{prefix}.out_net.6", p["Dense_2"])


def _conv_decoder(sd, p, s):
    """PoseDecoderConv / MotionPoseDecoder at `decoder.`."""
    _lin(sd, "decoder.pre_net.0", p["Dense_0"])
    _bn(sd, "decoder.pre_net.1", p["BatchNorm_0"]["BatchNorm_0"],
        s["BatchNorm_0"]["BatchNorm_0"])
    _lin(sd, "decoder.pre_net.3", p["Dense_1"])
    for j, (conv, norm) in enumerate(((0, 1), (3, 4))):
        _conv_transpose1d(sd, f"decoder.net.{conv}", p[f"ConvTranspose_{j}"])
        _bn(sd, f"decoder.net.{norm}", p[f"BatchNorm_{j + 1}"]["BatchNorm_0"],
            s[f"BatchNorm_{j + 1}"]["BatchNorm_0"])
    _conv1d(sd, "decoder.net.6", p["Conv_0"])
    _conv1d(sd, "decoder.net.7", p["Conv_1"])


def _bn_of(sd, name, p, s, key):
    """A `models.common.BatchNorm` wrapper `key` ({"BatchNorm_0": ...})."""
    _bn(sd, name, p[key]["BatchNorm_0"], s[key]["BatchNorm_0"])


def _wav_encoder(sd, prefix, p, s):
    """WavEncoder: Conv_0..3 at feat_extractor.{0,3,6,9}, BatchNorm_0..2 at
    feat_extractor.{1,4,7}."""
    for j, ci in enumerate((0, 3, 6, 9)):
        _conv1d(sd, f"{prefix}feat_extractor.{ci}", p[f"Conv_{j}"])
    for j, bi in enumerate((1, 4, 7)):
        _bn_of(sd, f"{prefix}feat_extractor.{bi}", p, s, f"BatchNorm_{j}")


def _wn_conv(sd, name, p):
    sd[name + ".weight_v"] = _t(np.asarray(p["v"]).transpose(2, 1, 0))
    sd[name + ".weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    sd[name + ".bias"] = _t(p["b"])


def _text_encoder_tcn(sd, prefix, p):
    """TextEncoderTCN: embedding, tcn.network.{i}.conv1/conv2/downsample,
    decoder."""
    sd[prefix + "embedding.weight"] = _t(p["embedding"])
    tcn = p["TemporalConvNet_0"]
    for i in range(len(tcn)):
        block, base = tcn[f"TemporalBlock_{i}"], f"{prefix}tcn.network.{i}"
        _wn_conv(sd, base + ".conv1", block["WeightNormConv1d_0"])
        _wn_conv(sd, base + ".conv2", block["WeightNormConv1d_1"])
        if "Conv_0" in block:
            _conv1d(sd, base + ".downsample", block["Conv_0"])
    _lin(sd, prefix + "decoder", p["Dense_0"])


def _speaker(sd, p):
    sd["speaker_embedding.0.weight"] = _t(p["Embed_0"]["embedding"])
    _lin(sd, "speaker_embedding.1", p["Dense_0"])
    _lin(sd, "speaker_mu", p["Dense_1"])
    _lin(sd, "speaker_logvar", p["Dense_2"])


def pose_generator_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """The trimodal PoseGenerator's variables (any `input_context`) -> the
    port's PoseGenerator state_dict."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _speaker(sd, p["SpeakerLatent_0"])
    if "WavEncoder_0" in p:
        _wav_encoder(sd, "audio_encoder.", p["WavEncoder_0"], s["WavEncoder_0"])
    if "TextEncoderTCN_0" in p:
        _text_encoder_tcn(sd, "text_encoder.", p["TextEncoderTCN_0"])
    _gru(sd, "gru.", p["GRU_0"])
    _lin(sd, "out.0", p["Dense_0"])
    _lin(sd, "out.2", p["Dense_1"])
    return sd


def seq2seq_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """Seq2SeqNet variables -> the port's Seq2SeqNet state_dict (the
    decoder's normalisation has a scale and a bias, no running statistics)."""
    enc, dec = variables["params"]["EncoderRNN_0"], variables["params"]["_DecoderStep_0"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["encoder.embedding.weight"] = _t(enc["embedding"])
    _gru(sd, "encoder.gru.", enc["GRU_0"])
    d = "decoder.decoder."
    _lin(sd, d + "attn.attn", dec["Attn_0"]["Dense_0"])
    sd[d + "attn.v"] = _t(dec["Attn_0"]["v"])
    _lin(sd, d + "pre_linear.0", dec["Dense_0"])
    sd[d + "pre_linear.1.weight"] = _t(dec["bn_scale"])
    sd[d + "pre_linear.1.bias"] = _t(dec["bn_bias"])
    n_layers = sum(k.startswith("cell_") for k in dec)
    for k in range(n_layers):
        for name, arr in dec[f"cell_{k}"].items():
            torch_name = name.replace("w_", "weight_", 1).replace("b_", "bias_", 1)
            sd[f"{d}gru.{torch_name}_l{k}"] = _t(arr)
    _lin(sd, d + "out", dec["Dense_1"])
    return sd


def _conv_any(sd, name, p):
    """A 1d (k, in, out) or 2d (kh, kw, in, out) flax Conv -> Conv1d / Conv2d."""
    kernel = np.asarray(p["kernel"])
    perm = (3, 2, 0, 1) if kernel.ndim == 4 else (2, 1, 0)
    sd[name + ".weight"] = _t(kernel.transpose(perm))
    sd[name + ".bias"] = _t(p["bias"])


def _cnr(sd, name, p, s):
    """speech2gesture's ConvNormRelu: Conv_0 -> .0, BatchNorm_0 -> .1."""
    _conv_any(sd, name + ".0", p["Conv_0"])
    _bn_of(sd, name + ".1", p, s, "BatchNorm_0")


def s2g_generator_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """speech2gesture Generator variables -> the port's Generator state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    ep, es = p["AudioEncoder_0"], s["AudioEncoder_0"]
    bases = ([f"audio_encoder.first_net.{i}" for i in range(8)]
             + ["audio_encoder.down1.0", "audio_encoder.down1.1"]
             + [f"audio_encoder.down{i}" for i in range(2, 7)])
    for j, base in enumerate(bases):
        _cnr(sd, base, ep[f"ConvNormRelu_{j}"], es[f"ConvNormRelu_{j}"])
    for j in range(5):
        _cnr(sd, f"audio_encoder.up{j + 1}.conv", ep[f"UnetUp_{j}"]["ConvNormRelu_0"],
             es[f"UnetUp_{j}"]["ConvNormRelu_0"])
    _lin(sd, "pre_pose_encoder.0", p["Dense_0"])
    _bn_of(sd, "pre_pose_encoder.1", p, s, "BatchNorm_0")
    _lin(sd, "pre_pose_encoder.3", p["Dense_1"])
    for j in range(4):
        _cnr(sd, f"decoder.{j}", p[f"ConvNormRelu_{j}"], s[f"ConvNormRelu_{j}"])
    _conv1d(sd, "final_out", p["Conv_0"])
    return sd


def s2g_discriminator_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """speech2gesture Discriminator variables -> the port's state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _conv1d(sd, "net.0", p["Conv_0"])
    _cnr(sd, "net.2", p["ConvNormRelu_0"], s["ConvNormRelu_0"])
    _cnr(sd, "net.3", p["ConvNormRelu_1"], s["ConvNormRelu_1"])
    _conv1d(sd, "net.4", p["Conv_1"])
    return sd


def embedding_net_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """EmbeddingNet variables (numpy leaves) -> the port's EmbeddingNet
    state_dict: pose mode under the reference checkpoint's names; the
    joint-embedding mode adds `context_encoder.*` and decodes with
    PoseDecoderGRU's `decoder.*`."""
    p, s = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    if "context_encoder" in p:
        cp, cs, c = p["context_encoder"], s["context_encoder"], "context_encoder."
        _text_encoder_tcn(sd, c + "text_encoder.", cp["TextEncoderTCN_0"])
        _wav_encoder(sd, c + "audio_encoder.", cp["WavEncoder_0"], cs["WavEncoder_0"])
        _gru(sd, c + "gru.", cp["GRU_0"])
        _lin(sd, c + "out.0", cp["Dense_0"])
        _bn_of(sd, c + "out.1", cp, cs, "BatchNorm_0")
        _lin(sd, c + "out.3", cp["Dense_1"])
        _lin(sd, c + "fc_mu", cp["Dense_2"])
        _lin(sd, c + "fc_logvar", cp["Dense_3"])
        dp, ds = p["decoder"], s["decoder"]
        _lin(sd, "decoder.pre_pose_net.0", dp["Dense_0"])
        _bn_of(sd, "decoder.pre_pose_net.1", dp, ds, "BatchNorm_0")
        _lin(sd, "decoder.pre_pose_net.3", dp["Dense_1"])
        _gru(sd, "decoder.gru.", dp["GRU_0"])
        _lin(sd, "decoder.out.0", dp["Dense_2"])
        _lin(sd, "decoder.out.2", dp["Dense_3"])
    pe, pe_s = p["pose_encoder"], s["pose_encoder"]
    _conv_encoder(sd, "pose_encoder", pe, pe_s)
    _lin(sd, "pose_encoder.fc_mu", pe["Dense_3"])
    _lin(sd, "pose_encoder.fc_logvar", pe["Dense_4"])
    if "context_encoder" not in p:
        _conv_decoder(sd, p["decoder"], s["decoder"])
    return sd


def motion_ae_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """MotionAE variables (numpy leaves) -> the port's MotionAE state_dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _conv_encoder(sd, "encoder", p["encoder"], s["encoder"])
    _conv_decoder(sd, p["decoder"], s["decoder"])
    return sd


# ---- the hierarchy (HA2G) ----------------------------------------------------

def _conv2d(sd, name, p):
    """flax Conv (kh, kw, in, out) -> Conv2d (out, in, kh, kw), its bias where
    it has one."""
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])


def resnet_se_state_dict_from_jax(variables, prefix: str = "",
                                  layers=(3, 4, 6, 3)) -> "OrderedDict[str, torch.Tensor]":
    """ResNetSE variables -> the port's ResNetSE state_dict under `prefix`
    (the inverse of hop_tpu's `convert_resnet_se`)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _conv2d(sd, prefix + "conv1", p["conv1"])
    _bn_of(sd, prefix + "bn1", p, s, "BatchNorm_0")
    for k, n_blocks in enumerate(layers, start=1):
        for i in range(n_blocks):
            bp, bs, n = p[f"layer{k}_{i}"], s[f"layer{k}_{i}"], f"{prefix}layer{k}.{i}."
            _conv2d(sd, n + "conv1", bp["Conv_0"])
            _bn_of(sd, n + "bn1", bp, bs, "BatchNorm_0")
            _conv2d(sd, n + "conv2", bp["Conv_1"])
            _bn_of(sd, n + "bn2", bp, bs, "BatchNorm_1")
            _lin(sd, n + "se.fc.0", bp["SELayer_0"]["Dense_0"])
            _lin(sd, n + "se.fc.2", bp["SELayer_0"]["Dense_1"])
            if "Conv_2" in bp:
                _conv2d(sd, n + "downsample.0", bp["Conv_2"])
                _bn_of(sd, n + "downsample.1", bp, bs, "BatchNorm_2")
    for j, level in enumerate(("low", "mid", "high"), start=1):
        _conv2d(sd, f"{prefix}conv_{level}", p[f"conv_{level}"])
        _bn_of(sd, f"{prefix}bn_{level}", p, s, f"BatchNorm_{j}")
        _lin(sd, f"{prefix}fc_{level}", p[f"fc_{level}"])
    sd[prefix + "speaker_embedding.0.weight"] = _t(p["speaker_embed"]["embedding"])
    _lin(sd, prefix + "speaker_embedding.1", p["speaker_proj"])
    _lin(sd, prefix + "fc1", p["fc1"])
    _lin(sd, prefix + "fc2", p["fc2"])
    return sd


def gru_discriminator_state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """HierarchicalDiscriminator or the text-conditioned Discriminator
    (its `TextEncoderTCN_0` where it has one) -> the port's state_dict
    (`text_encoder.*`, `gru.*`, `out`, `out2`)."""
    p = variables["params"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    if "TextEncoderTCN_0" in p:
        _text_encoder_tcn(sd, "text_encoder.", p["TextEncoderTCN_0"])
    _gru(sd, "gru.", p["GRU_0"])
    _lin(sd, "out", p["Dense_0"])
    _lin(sd, "out2", p["Dense_1"])
    return sd


def hierarchy_state_dict_from_jax(variables, layers=(3, 4, 6, 3)
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """hop_tpu's hierarchy generator tree ({"audio", "text", "g1", ...}, as
    its train_main builds it) -> the port's HierarchyNet state_dict
    (`audio.*`, `text.*`, `stages.{k}.*`)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd.update(resnet_se_state_dict_from_jax(
        {"params": p["audio"], "batch_stats": s["audio"]}, "audio.", layers))
    _text_encoder_tcn(sd, "text.", p["text"]["TextEncoderTCN_0"])
    for k in range(sum(key.startswith("g") and key[1:].isdigit() for key in p)):
        # a stage has the trimodal generator's names without its WavEncoder
        for name, v in pose_generator_state_dict_from_jax({"params": p[f"g{k + 1}"]}).items():
            sd[f"stages.{k}.{name}"] = v
    return sd


# ---- the other way: the FGD feature nets as flax trees (export_eval_net) ----

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _lin_to(sd, name) -> dict:
    return {"kernel": _np(sd[name + ".weight"]).T, "bias": _np(sd[name + ".bias"])}


def _conv1d_to(sd, name) -> dict:
    return {"kernel": _np(sd[name + ".weight"]).transpose(2, 1, 0),
            "bias": _np(sd[name + ".bias"])}


def _conv_transpose1d_to(sd, name) -> dict:
    return {"kernel": _np(sd[name + ".weight"]).transpose(2, 0, 1)[::-1].copy(),
            "bias": _np(sd[name + ".bias"])}


def _bn_to(sd, name) -> tuple:
    """A BatchNorm -> the `models.common.BatchNorm` wrapper's (params,
    batch_stats) entries."""
    return ({"BatchNorm_0": {"scale": _np(sd[name + ".weight"]),
                             "bias": _np(sd[name + ".bias"])}},
            {"BatchNorm_0": {"mean": _np(sd[name + ".running_mean"]),
                             "var": _np(sd[name + ".running_var"])}})


def _conv_encoder_to(sd, prefix) -> tuple:
    p, s = {}, {}
    for i in range(3):
        bp, bs = _bn_to(sd, f"{prefix}.net.{i}.1")
        p[f"ConvNormRelu_{i}"] = {"Conv_0": _conv1d_to(sd, f"{prefix}.net.{i}.0"),
                                  "BatchNorm_0": bp}
        s[f"ConvNormRelu_{i}"] = {"BatchNorm_0": bs}
    p["Conv_0"] = _conv1d_to(sd, f"{prefix}.net.3")
    for j, (dense, norm) in enumerate(((0, 1), (3, 4))):
        p[f"Dense_{j}"] = _lin_to(sd, f"{prefix}.out_net.{dense}")
        p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"] = _bn_to(sd, f"{prefix}.out_net.{norm}")
    p["Dense_2"] = _lin_to(sd, f"{prefix}.out_net.6")
    return p, s


def _conv_decoder_to(sd) -> tuple:
    p, s = {"Dense_0": _lin_to(sd, "decoder.pre_net.0"),
            "Dense_1": _lin_to(sd, "decoder.pre_net.3")}, {}
    p["BatchNorm_0"], s["BatchNorm_0"] = _bn_to(sd, "decoder.pre_net.1")
    for j, (conv, norm) in enumerate(((0, 1), (3, 4))):
        p[f"ConvTranspose_{j}"] = _conv_transpose1d_to(sd, f"decoder.net.{conv}")
        p[f"BatchNorm_{j + 1}"], s[f"BatchNorm_{j + 1}"] = _bn_to(sd, f"decoder.net.{norm}")
    p["Conv_0"] = _conv1d_to(sd, "decoder.net.6")
    p["Conv_1"] = _conv1d_to(sd, "decoder.net.7")
    return p, s


def embedding_net_to_jax(sd) -> dict:
    """The port's pose-mode EmbeddingNet state_dict -> hop_tpu's variable
    tree (numpy leaves), the inverse of `embedding_net_state_dict_from_jax`."""
    pe, pe_s = _conv_encoder_to(sd, "pose_encoder")
    pe["Dense_3"] = _lin_to(sd, "pose_encoder.fc_mu")
    pe["Dense_4"] = _lin_to(sd, "pose_encoder.fc_logvar")
    dp, ds = _conv_decoder_to(sd)
    return {"params": {"pose_encoder": pe, "decoder": dp},
            "batch_stats": {"pose_encoder": pe_s, "decoder": ds}}


def motion_ae_to_jax(sd) -> dict:
    """The port's MotionAE state_dict -> hop_tpu's variable tree, the inverse
    of `motion_ae_state_dict_from_jax`."""
    ep, es = _conv_encoder_to(sd, "encoder")
    dp, ds = _conv_decoder_to(sd)
    return {"params": {"encoder": ep, "decoder": dp},
            "batch_stats": {"encoder": es, "decoder": ds}}


def save_npz_variables(path: str, variables: dict) -> None:
    """A variable tree -> the flat .npz that `hop_tpu.utils.checkpoint.
    save_arrays` writes (keys the tree's path joined by "/"), which
    `load_npz_variables` and hop_tpu's `--eval-net` read."""
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = np.asarray(v)
    walk(variables, ())
    np.savez(path, **flat)
