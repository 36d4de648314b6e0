"""flax HOPModel and ConvDiscriminator variables -> this port's state_dicts.

`state_dict_from_jax` is the inverse of
`hop_tpu.eval.torch_import_hop.convert_hop_model`, frozen BERT backbone
included (the inverse of `hop_tpu.models.bert.convert_hf_bert_params`); it
covers what `hop_tpu.eval.torch_export_hop.export_hop_state_dict` exports
plus the `llm_model.*` weights. `discriminator_state_dict_from_jax` is
the inverse of `hop_tpu.eval.torch_import_generator.
convert_conv_discriminator`. No jax here: the caller hands over the
variable tree `{"params": ..., "batch_stats": ...}` with numpy leaves
(unboxed).

Layout rules: Dense (in, out) -> Linear weight (out, in); Dense as 1x1
conv -> Conv2d (out, in, 1, 1); gwnet temporal conv (k, 1, in, out) ->
Conv2d (out, in, 1, k); Conv (k, in, out) -> Conv1d (out, in, k);
LayerNorm/BatchNorm scale -> weight; the GRU and the mapping layer
already keep torch's layout.
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

    _bert(sd, "llm_model.", params["llm"], cfg.llm.n_layers)

    sd["mapping_layer.weight"] = _t(params["mapping_layer"]["kernel"])
    sd["mapping_layer.bias"] = _t(params["mapping_layer"]["bias"])
    for name in ("query_projection", "key_projection",
                 "value_projection", "out_projection"):
        _lin(sd, f"reprogramming_layer.{name}",
             params["reprogramming_layer"][name])
    _lin(sd, "align_layer", params["align_layer"])

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
