"""The validation pass on the card at the tiny size, against the same metric
functions on the CPU.

Needs an NVIDIA GPU (the generator's forward runs the CUDA kernels K1 and
K2, or K3 on the stack route); on a machine without a card it skips. On the
card run it without the JAX test harness (tests/conftest.py imports jax):

  python -m pytest tests/test_torch_eval_cuda.py --noconftest -m cuda -q

The CPU functions are fed the card's generated poses, targets, audio and
speaker ids, so the generator's own card-vs-CPU difference stays out:
what is left is f32 reductions and the feature net's convolutions in
another order, 1e-4 relative, and eigh on LAPACK against cuSOLVER for FGD
on covariances of fewer samples than dimensions (singular: the square root
of an eigenvalue at round-off), 1e-2 relative. The onset masks are equal.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from hop_tpu_torch.cli import common as C
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.data.dataset import SpeechMotionDataset
from hop_tpu_torch.data.preprocessor import DataPreprocessor
from hop_tpu_torch.data.synthetic import make_source_clips
from hop_tpu_torch.data.vocab import build_vocab
from hop_tpu_torch.eval.evaluate import evaluate_testset
from hop_tpu_torch.models.hop import build_hop_model
from hop_tpu_torch.ops import gru_fused as K2
from hop_tpu_torch.ops import gru_stack as K3
from hop_tpu_torch.ops import onset
from hop_tpu_torch.ops import reprogramming_attention as K1

pytestmark = pytest.mark.cuda

REL_TOL = 1e-4
FGD_REL_TOL = 1e-2
FIELDS = ("loss", "mae", "frechet_dist", "feat_dist", "bc", "diversity")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("gru_kernel", ["fused", "stack"])
def test_tiny_validation_pass_on_the_card_matches_cpu(device, gru_kernel):
    cfg = tiny_test_config()
    # K1 takes the reprogramming attention's head width of the real model
    cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, d_ff=K1.HEAD_DIM))
    path = tempfile.mkdtemp(prefix="hop_eval_") + "/val"
    n = DataPreprocessor(cfg.data, path).run(
        make_source_clips(cfg, n_videos=2, clip_seconds=6.0, seed=4))
    ds = SpeechMotionDataset(path, cfg.data)
    ds.set_lang_model(build_vocab("words", [[w for aux in ds._aux_cache
                                             for w in aux["words"]]], None, None, 300))
    model = build_hop_model(cfg, 10, seed=0, device=device)
    model.gru.kernel = gru_kernel
    record = []

    def gen(batch, vids, generator):
        with torch.inference_mode():
            out = model(batch["in_audio"], batch["log_mel"], batch["text_padded"],
                        batch["target_vec"][:, :16], vids, generator=generator)[0]
        record.append((batch, vids, out))
        return out
    K1.launches = K2.launches = K3.lean_launches = 0
    card = evaluate_testset(
        (C.device_batch(b, cfg, device=device)
         for b in ds.batches(4, shuffle=False, drop_last=False)),
        gen, C.make_fgd_evaluator(cfg, ds.lang_model.n_words, None, device),
        36, cfg, 10, generator=torch.Generator(device=device).manual_seed(0))
    n_batches = len(record)
    assert n_batches == -(-n // 4) >= 3
    layers = cfg.hop.gru_layers * n_batches
    assert (K1.launches, K2.launches, K3.lean_launches) == (
        n_batches, layers if gru_kernel == "fused" else 0,
        layers if gru_kernel == "stack" else 0)
    outs = iter([o.cpu() for _, _, o in record])
    cpu = evaluate_testset(
        iter([{k: v.cpu() for k, v in b.items()} for b, _, _ in record]),
        lambda b, v, g: next(outs),
        C.make_fgd_evaluator(cfg, ds.lang_model.n_words, None, "cpu"),
        36, cfg, 10, speaker_ids=iter([v.cpu() for _, v, _ in record]))
    for f in FIELDS:
        got, want = getattr(card, f), getattr(cpu, f)
        assert np.isfinite(got)
        tol = FGD_REL_TOL if f == "frechet_dist" else REL_TOL
        assert abs(got - want) <= tol * max(abs(want), 1e-12), (f, got, want)
    assert card.diversity > 0
    for b, _, _ in record:
        assert torch.equal(onset.onset_detect_mask(b["in_audio"]).cpu(),
                           onset.onset_detect_mask(b["in_audio"].cpu()))
