"""Reference PyTorch checkpoints into the port's models (the counterpart of
hop_tpu/eval/torch_import.py, torch_import_generator.py and
torch_import_hop.py).

The reference saves its models as `torch.save` dicts (`.bin`): the TED
gesture autoencoder's `EmbeddingNet(mode='pose')`, the FGD feature net,
and the multimodal-context `PoseGenerator` under 'gen_dict', the
TED-Expressive FGD net under 'motion_ae', HOP under 'generator'
(run_ted.py:457-460). The port's models carry the reference's state_dict
names and layouts, so loading is key handling: `load_reference` checks the
payload's keys against the model's and names every missing and unexpected
entry, except for what the reference holds and the port does not build:

  - 'generator' may lack the frozen backbone (`llm_model.*`, left out by
    the reference-format exports; the model keeps its own), and may hold
    HuggingFace's extras (`llm_model.pooler.*`, `position_ids`,
    `rotary_emb.inv_freq`) and the reference's dead blocks (the WavEncoder
    `audio_encoder.*` it builds but never calls under use_gwnet,
    `gwnet.residual_convs.*`), which are ignored.

`load_torch_checkpoint` reads a `.bin` without the reference's code: the
objects a payload pickles besides tensors (its `args`, its `lang_model`
Vocab) come back as opaque stand-ins, and no class outside torch,
collections and numpy's array reconstruction is loaded.
"""

from __future__ import annotations

import pickle
import re
import types
from typing import Dict

import torch

#: payload key -> what it holds in the reference
PAYLOADS = {"gen_dict": "EmbeddingNet(mode='pose') or PoseGenerator",
            "motion_ae": "MotionAE", "generator": "HOPModel"}

_HOP_EXTRAS = re.compile(r"^(?:llm_model\.(?:.*\.)?(?:pooler\..*|position_ids"
                         r"|rotary_emb\.inv_freq)|gwnet\.residual_convs\..*)$")
_SAFE = {("collections", "OrderedDict"), ("numpy.core.multiarray", "_reconstruct"),
         ("numpy._core.multiarray", "_reconstruct"), ("numpy", "ndarray"),
         ("numpy", "dtype"), ("numpy.core.multiarray", "scalar"),
         ("numpy._core.multiarray", "scalar"), ("_codecs", "encode")}


class Opaque:
    """Stands in for an object of the reference's own code in a payload."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "torch" or (module, name) in _SAFE:
            return super().find_class(module, name)
        return Opaque


_pickle = types.ModuleType("hop_tpu_torch_reference_pickle")
_pickle.Unpickler = _Unpickler
_pickle.load = lambda f, **kw: _Unpickler(f, **kw).load()


def load_torch_checkpoint(path: str) -> Dict:
    """A reference `.bin` on the CPU: its dict of payloads (state dicts of
    tensors, and opaque stand-ins for anything of the reference's code)."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_pickle)


def _hop_allowances(model):
    use_gwnet = hasattr(model, "gwnet")

    def missing_ok(k):
        return k.startswith("llm_model.")

    def unexpected_ok(k):
        return bool(_HOP_EXTRAS.match(k)) or (use_gwnet and k.startswith("audio_encoder."))
    return missing_ok, unexpected_ok


def load_reference(model: torch.nn.Module, payload: Dict, key: str) -> list:
    """payload[key] into `model` (payload: a dict from
    `load_torch_checkpoint`). Raises KeyError naming the missing and the
    unexpected entries; returns the entries ignored."""
    if key not in payload:
        raise KeyError(f"payload has no {key!r} ({PAYLOADS.get(key, '?')}); "
                       f"it holds {sorted(payload)}")
    sd = payload[key]
    own = model.state_dict()
    missing_ok, unexpected_ok = (_hop_allowances(model) if key == "generator"
                                 else (lambda k: False, lambda k: False))
    missing = [k for k in own if k not in sd and not missing_ok(k)]
    unexpected = [k for k in sd if k not in own and not unexpected_ok(k)]
    if missing or unexpected:
        raise KeyError(f"{type(model).__name__} <- {key!r}: missing {missing}, "
                       f"unexpected {unexpected}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items() if k in own},
                          strict=False)
    return sorted(k for k in sd if k not in own)
