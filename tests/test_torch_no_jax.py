"""hop_tpu_torch imports neither jax nor flax nor hop_tpu, nor pyarrow, lmdb,
fasttext, safetensors or transformers: a fresh process imports every module
of the port and runs, on
the CPU at the tiny size, its long-form entry point for one window on both
GRU routes and on the backbone's block-attention route, the validation pass
(`--evaluate`: records, dataset, metrics) over 2 batches, `device_batch`,
one 3-forward GAN step on the stack route, the sequence-kernel stack
forward, the training entry point (`run_ted`: the epoch loop, a checkpoint,
a resume) with the long-form entry restoring what it saved, and the
importer (`data.import_ted --verify`) and the long-form entry
(`--data <LMDB>`) on a source LMDB the port's own codec wrote, and the
training entry point on the LLaMA backbone with its weights read from a
bf16 safetensors file the port's own writer wrote (`--llm-weights`), the
long-form entry restoring it, the training entry point on each family
of the baseline zoo and the hierarchy (`--model`), and the serving export
and its loader, `--render-video`, the TensorBoard mirror, a profiler trace,
the tools and a reference-format checkpoint written and read back.

The work runs as six fresh processes, one a part (`SECTIONS`), each with
its own time limit: each imports every module of the port first, and each
ends holding that nothing foreign was imported and that the port's modules
are all there. Each runs torch on one thread, beside the other test
workers."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a part's process may take
PART_SECONDS = 300

PRELUDE = r"""
import dataclasses, importlib, os, pkgutil, sys, tempfile
import torch
torch.set_num_threads(1)     # small CPU ops, beside the other test workers
import hop_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hop_tpu_torch.__path__,
                                                "hop_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from hop_tpu_torch.cli import run_ted, test_checkpoint
from hop_tpu_torch.config import tiny_test_config
from hop_tpu_torch.models.hop import build_hop_model
"""

SECTIONS = {
    "serve": r"""
out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2"])
assert out.shape == (34, 27), out.shape
out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                            "--gru-kernel", "stack"])
assert out.shape == (34, 27), out.shape
out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                            "--bert-attention", "block"])
assert out.shape == (34, 27), out.shape
out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                            "--evaluate", "--eval-videos", "1",
                            "--eval-batch-size", "16"])
assert out.shape == (34, 27), out.shape

from hop_tpu_torch.cli.common import device_batch
from hop_tpu_torch.data.synthetic import make_host_batch
from hop_tpu_torch.models.multimodal_context import build_discriminator
from hop_tpu_torch.ops.gru_seq import gru_forward_seq
from hop_tpu_torch.train.llm import make_hop_train_steps
cfg = tiny_test_config()
cfg = cfg.replace(hop=dataclasses.replace(cfg.hop, fused_step=False, gru_kernel="stack"),
                  data=dataclasses.replace(cfg.data, audio_wire="int16"))
model = build_hop_model(cfg, 10, seed=0, device="cpu")
disc = build_discriminator(cfg, seed=1, device="cpu")
_, gan, init_state = make_hop_train_steps(cfg, model, disc)
batch = device_batch(make_host_batch(cfg, 2, seed=0), cfg, device="cpu")
_, metrics = gan(init_state(), batch, torch.Generator().manual_seed(0))
assert all(torch.isfinite(v) for v in metrics.values()), metrics
y = gru_forward_seq(torch.zeros(2, 5, 8), disc.gru.state_dict(), 64, 4, True)
assert y.shape == (2, 5, 128), y.shape
print("PARITY STEP OK", sorted(metrics))
""",
    "run": r"""
with tempfile.TemporaryDirectory() as tmp:
    tempfile.tempdir = tmp
    run = ["--device", "cpu", "--tiny", "--synthetic-videos", "1", "--batch-size", "13",
           "--warmup-epochs", "0", "--checkpoint-dir", tmp + "/ck", "--metrics",
           tmp + "/m.jsonl"]
    run_ted.main(run + ["--epochs", "1"])
    run_ted.main(run + ["--epochs", "2", "--resume", "--prefetch", "1"])
    out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                                "--vid", "0", "--checkpoint-dir", tmp + "/ck"])
    assert out.shape == (34, 27), out.shape
    tempfile.tempdir = None
""",
    "import": r"""
from hop_tpu_torch.data import arrow_legacy, import_ted
from hop_tpu_torch.data.lmdbfile import write_lmdb
from hop_tpu_torch.data.synthetic import make_source_clips
with tempfile.TemporaryDirectory() as tmp:
    (vid, clips), = make_source_clips(tiny_test_config(), n_videos=1, clip_seconds=4.0)
    write_lmdb(tmp + "/src", {b"0": arrow_legacy.serialize({"vid": vid, "clips": [{
        "skeletons_3d": c.skeletons_3d, "audio_raw": c.audio_raw,
        "audio_feat": c.audio_spectrogram, "words": [list(w) for w in c.words],
        "start_frame_no": c.start_frame_no, "end_frame_no": c.end_frame_no,
        "start_time": c.start_time, "end_time": c.end_time} for c in clips]})})
    import_ted.main(["--src", tmp + "/src", "--out", tmp + "/rec", "--verify",
                     "--device", "cpu"])
    out = test_checkpoint.main(["--device", "cpu", "--tiny", "--data", tmp + "/src"])
    assert out.shape == (64, 27), out.shape
""",
    "llama": r"""
from hop_tpu_torch.config import tiny_llama_llm_config
from hop_tpu_torch.models.llama import LlamaEncoder
from hop_tpu_torch.utils import safetensors_io
with tempfile.TemporaryDirectory() as tmp:
    tempfile.tempdir = tmp
    os.makedirs(tmp + "/llama")
    sd = LlamaEncoder(tiny_llama_llm_config()).state_dict()
    safetensors_io.write({k: v.bfloat16() for k, v in sd.items()},
                         tmp + "/llama/model.safetensors")
    run_ted.main(["--device", "cpu", "--tiny", "--llm-model", "LLAMA", "--llm-weights",
                  tmp + "/llama", "--synthetic-videos", "1", "--batch-size", "13",
                  "--warmup-epochs", "0", "--epochs", "1", "--checkpoint-dir", tmp + "/ck",
                  "--metrics", tmp + "/m.jsonl"])
    out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "3",
                                "--checkpoint-dir", tmp + "/ck"])
    assert out.shape == (64, 27), out.shape
    tempfile.tempdir = None
print("LLAMA OK")
""",
    "zoo": r"""
with tempfile.TemporaryDirectory() as tmp:
    tempfile.tempdir = tmp
    # the hierarchy's full-depth ResNetSE on the records of one 6 s clip
    from hop_tpu_torch.data import synthetic
    from hop_tpu_torch.data.preprocessor import DataPreprocessor
    clip = synthetic.make_source_clips(tiny_test_config("TED"), n_videos=1,
                                       clip_seconds=6.0, seed=0)
    for split in ("train", "val"):
        DataPreprocessor(tiny_test_config("TED").data, tmp + "/clip_" + split).run(clip)
    for model in ("multimodal_context", "seq2seq", "speech2gesture", "joint_embedding",
                  "gesture_autoencoder", "hierarchy"):
        data = (["--data", tmp + "/clip_train", "--val-data", tmp + "/clip_val"]
                if model == "hierarchy" else ["--synthetic-videos", "1"])
        run_ted.main(["--device", "cpu", "--tiny", "--model", model, *data,
                      "--batch-size", "64", "--warmup-epochs", "0", "--epochs", "1",
                      "--checkpoint-dir", tmp + "/" + model, "--metrics", tmp + "/m.jsonl"])
        print("ZOO", model)
    tempfile.tempdir = None
""",
    "export": r"""
# the serving export, rendering, the metric mirror, the tools, the
# reference-format checkpoints
from hop_tpu_torch import infer
from hop_tpu_torch.eval import torch_export_hop, torch_import
from hop_tpu_torch.utils import metrics_export, profiling, render, tools
with tempfile.TemporaryDirectory() as tmp:
    cfg = tiny_test_config()
    model = build_hop_model(cfg, 5, seed=0, device="cpu")
    fwd = infer.load_exported(infer.export_forward(model, cfg, 1, device="cpu"))
    out = fwd(*infer.serving_inputs(cfg, 1, "cpu"))
    assert out.shape == (1, 34, 27), out.shape
    out = test_checkpoint.main(["--device", "cpu", "--tiny", "--clip-seconds", "2",
                                "--render-video", "--out", tmp + "/demo"])
    assert sorted(os.listdir(tmp + "/demo"))[0].startswith("demo_0."), os.listdir(tmp)
    w = metrics_export.TensorBoardMirror(tmp + "/tb")
    w.scalar("loss/val", 1.5, 0)
    w.close()
    with profiling.trace(tmp + "/trace"):
        torch.ones(3) + 1
    assert tools.adjust_learning_rate(3, 1e-3) == 2.5e-4
    torch.save({"generator": torch_export_hop.export_hop_state_dict(model, cfg)},
               tmp + "/g.bin")
    assert torch_import.load_reference(
        model, torch_import.load_torch_checkpoint(tmp + "/g.bin"), "generator") == []
print("EXPORT OK")
""",
}

EPILOGUE = r"""
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hop_tpu", "pyarrow",
                                    "lmdb", "fasttext", "safetensors", "transformers"))
for new in ("cli.common", "ops.gru_stack", "ops.gru_seq", "ops.attention",
            "ops.block_attention", "geometry", "data.records", "data.dataset",
            "eval.evaluate", "eval.fgd", "train.loops", "utils.checkpoint",
            "utils.prng", "utils.meters", "cli.train_main", "cli.run_ted",
            "cli.run_expressive", "data.lmdbfile", "data.arrow_legacy",
            "data.import_ted", "data.fasttext_export", "models.llama",
            "models.llm_weights", "utils.safetensors_io", "models.tcn",
            "models.seq2seq", "models.speech2gesture", "train.gan", "train.seq2seq",
            "train.speech2gesture", "train.embed", "utils.params", "models.resnet_se",
            "models.hierarchy", "train.hierarchy", "train.hierarchy_expressive_stats",
            "data.h36m", "cli.train_h36m_ae", "eval.export_eval_net", "infer",
            "cli.export_model", "utils.render", "utils.metrics_export", "utils.profiling",
            "utils.tools", "eval.torch_export_hop", "eval.torch_import"):
    assert "hop_tpu_torch." + new in names, new
print("MODULES", len(names), "FOREIGN", bad)
"""


def run_part(name: str) -> str:
    """The part's stdout, after the checks every part shares."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", PRELUDE + SECTIONS[name] + EPILOGUE],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=PART_SECONDS)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN []" in proc.stdout, proc.stdout
    assert int(proc.stdout.split("MODULES ")[1].split()[0]) >= 20
    return proc.stdout


def test_port_imports_no_jax():
    out = run_part("serve")
    assert out.count("generated 34 frames") == 4
    assert "evaluate: 26 windows in batches of 16" in out
    assert "[VAL] loss:" in out
    assert "PARITY STEP OK" in out and "'dis'" in out


def test_the_training_entry_runs_without_jax():
    out = run_part("run")
    assert "resumed from checkpoint epoch 0" in out
    assert "restored checkpoint step 1" in out
    assert out.count("generated 34 frames") == 1


def test_the_importer_runs_without_jax():
    out = run_part("import")
    assert "verify ok — mel: 1 clips" in out
    assert "clip 0 vid=vid0 (4.0s," in out
    assert "generated 64 frames" in out


def test_the_llama_backbone_runs_without_jax():
    out = run_part("llama")
    assert "loaded pretrained LLAMA backbone from" in out
    assert "LLAMA OK" in out and "generated 64 frames" in out


def test_the_zoo_and_the_hierarchy_run_without_jax():
    out = run_part("zoo")
    for model in ("multimodal_context", "seq2seq", "speech2gesture", "joint_embedding",
                  "gesture_autoencoder", "hierarchy"):
        assert f"ZOO {model}" in out


def test_the_export_and_the_tools_run_without_jax():
    out = run_part("export")
    assert "EXPORT OK" in out and "rendered video in" in out
    assert out.count("generated 34 frames") == 1
