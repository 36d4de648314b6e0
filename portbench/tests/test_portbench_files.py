"""The benchmark's files: the configurations against the port's presets, the
reference's tensors against the port's nets, the work counts against the
bounds the repository measured kernels by, and a cell, traffic mix, kind of
traffic and metric added as files alone."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil

import pytest
import torch

from portbench import cells, hop, peaks, work
from portbench.reference import model as ref_model

HERE = cells.HERE


@pytest.mark.parametrize("name,preset", [("hop_ted", "ted_config"),
                                         ("hop_expressive", "expressive_config")])
def test_config_file_is_the_preset(name, preset):
    from hop_tpu_torch import config
    from hop_tpu_torch.models.hop import gru_input_size
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = getattr(config, preset)()
    assert hop.program_config(conf) == cfg
    assert conf["derived"] == {"pose_dim": cfg.data.pose_dim,
                               "n_joints_graph": cfg.data.n_joints_graph,
                               "gru_input_size": gru_input_size(cfg)}


@pytest.mark.parametrize("name", ["hop_ted", "hop_expressive"])
def test_reference_tensors_are_the_nets(name):
    from hop_tpu_torch.models.hop import HOPModel
    from hop_tpu_torch.models.multimodal_context import ConvDiscriminator
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = hop.program_config(conf)
    with torch.device("meta"):
        gen = HOPModel(cfg, 33)
        disc = ConvDiscriminator(cfg.data.pose_dim, cfg.data.n_poses)
    for specs, net in ((ref_model.generator_specs(conf, 33), gen),
                       (ref_model.discriminator_specs(conf), disc)):
        assert {n: tuple(s) for n, s in specs} == {
            n: tuple(t.shape) for n, t in net.state_dict().items()}
    trained = {n for n, p in gen.named_parameters() if p.requires_grad}
    assert trained == {n for n, _ in ref_model.generator_specs(conf, 33)
                       if ref_model.trainable(n)}
    assert sum(t.numel() for t in gen.parameters()) > 130e6


def test_work_counts_match_the_measured_bounds():
    # the forward bounds the repository's kernel table states: K1 53.5
    # GFLOP at (B, L, H, E, S) = (256, 34, 8, 128, 1500), its backward's five
    # products 133.7; K2 49.1 GFLOP at (T, B, I, H, D) = (34, 256, 992, 350, 2),
    # its backward 98.1
    assert work.k1_fwd(256, 34, 8, 128, 1500)[0] == pytest.approx(53.5e9, rel=1e-3)
    assert work.k1_bwd(256, 34, 8, 128, 1500)[0] == pytest.approx(133.7e9, rel=1e-3)
    assert work.k2_fwd(34, 256, 992, 350, 2)[0] == pytest.approx(49.1e9, rel=1e-3)
    assert work.k2_bwd(34, 256, 992, 350, 2)[0] == pytest.approx(98.1e9, rel=1e-3)
    assert peaks.TF32X3_FLOPS == pytest.approx(165e12)


def test_step_counts_its_launches():
    conf = json.loads((HERE / "configs" / "hop_ted.json").read_text())
    train = work.k2_launches(conf, 256, True)
    # the repository's launch counts of a fused GAN step: K2 20 forward, 16 backward
    assert sum(k == "fwd" for k, _, _ in train) == 20
    assert sum(k == "bwd" for k, _, _ in train) == 16
    assert len(work.k2_launches(conf, 1024, False)) == 4
    assert [k for k, _, _ in work.k1_launches(conf, 256, True)] == ["fwd", "bwd"]
    step = work.train_step_flops(conf, 256)
    assert 2.5e12 < step < 3.2e12
    assert work.generate_flops(conf, 1024) > 4 * work.generate_flops(conf, 256) - 0.3e12


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    """A copy of the benchmark, its files' digests, and its BENCHMARK.json."""
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return root, _digest(root), json.loads((tmp_path / "BENCHMARK.json").read_text())


# a kind of traffic that no file of the benchmark knows: batched products of
# seeded matrices, closed loop, checked against float64 products
TOY_KIND = """
import time
from collections import defaultdict

import torch


class Driver:
    kind = "toy_matmul"

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.B = cell.traffic["batch"]
        self.spans, self.failed, self.phases = defaultdict(list), 0, {}

    def setup(self):
        g = torch.Generator().manual_seed(self.seed)
        n = self.cell.conf["n"]
        self.a, self.b = (torch.randn(self.B, n, n, generator=g) for _ in range(2))
        self.out = torch.bmm(self.a, self.b)

    def loop(self, until, spans, trace):
        n = 0
        while not until(n):
            t = time.perf_counter()
            self.out = torch.bmm(self.a, self.b)
            if spans:
                self.spans["bmm"].append(time.perf_counter() - t)
            n += 1
        return n

    def end_to_end(self, units, window_s):
        return {"toy_products_per_s": units * self.B / window_s}

    def release(self):
        self.prog = self.out.double()

    def reference(self, control=False):
        return torch.bmm(self.a.double(), self.b.double())

    def numbers(self, ref, prog=None):
        return {"toy_gap": float(((self.prog if prog is None else prog) - ref).abs().max())}

    def close(self):
        pass
"""


def test_a_cell_mix_and_metric_are_files_alone(tmp_path):
    """A later cell, traffic mix and per-layer metric, added as new files
    and entries in a copy, are found by name; no file there changes."""
    root, before, spec = _copy(tmp_path)
    conf = json.loads((root / "configs" / "hop_ted.json").read_text())
    conf["hop"] = dict(conf["hop"], gru_kernel="stack")
    (root / "configs" / "hop_ted_stack.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "traffic" / "generate_b1024.json").read_text())
    (root / "traffic" / "generate_b256.json").write_text(json.dumps(dict(traffic, batch=256)))
    (root / "metrics" / "calls.gen.py").write_text("def read(ctx):\n    return ctx.units\n")
    spec["configs"].append({"name": "hop_ted_stack", "source": "x", "file":
                            "portbench/configs/hop_ted_stack.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "hop_ted_stack.generate_b256", "config": "hop_ted_stack",
                              "traffic": "generate_b256", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls.gen", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "model forward, host",
                              "moves": "gen_windows_per_s",
                              "workloads": ["hop_ted_stack.generate_b256"]})
    spec["end_to_end"][1]["workloads"].append("hop_ted_stack.generate_b256")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load_cell("hop_ted_stack.generate_b256", root)
    assert cell.traffic["batch"] == 256 and cell.conf["hop"]["gru_kernel"] == "stack"
    assert hop.program_config(cell.conf).hop.gru_kernel == "stack"
    assert [m["name"] for m in cell.per_layer] == ["calls.gen"]
    assert {m["name"] for m in cell.end_to_end} == {"gen_windows_per_s", "peak_mem_gib",
                                                    "setup_s"}
    ctx = type("Ctx", (), {"units": 7})()
    assert cells.metric_reader("calls.gen", root)(ctx) == 7
    after = _digest(root)
    assert {p: d for p, d in after.items() if p in before} == before


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_kind_of_traffic_is_files_alone(tmp_path, trace):
    """A kind of traffic, with its configuration, mix, limits, end-to-end
    metric and per-layer metric, added as new files and entries in a copy,
    runs through the harness (on the CPU); no file there changes."""
    from portbench.run import run_cell
    root, before, spec = _copy(tmp_path)
    (root / "kinds" / "toy_matmul.py").write_text(TOY_KIND)
    (root / "configs" / "toy.json").write_text(json.dumps({"n": 32}))
    (root / "traffic" / "small.json").write_text(json.dumps(
        {"kind": "toy_matmul", "batch": 4, "trace_steps": 3}))
    (root / "limits" / "toy.small.json").write_text(json.dumps({"toy_gap": 1e-3}))
    (root / "metrics" / "bmm_ms.toy.py").write_text(
        "from portbench.readers import span_ms\n\n\n"
        "def read(ctx):\n    return span_ms(ctx, 'bmm') if ctx.kind == 'toy_matmul' else None\n")
    spec["configs"].append({"name": "toy", "source": "x", "file": "portbench/configs/toy.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "toy.small", "config": "toy", "traffic": "small",
                              "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "toy_products_per_s", "unit": "products/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["toy.small"]})
    spec["per_layer"].append({"name": "bmm_ms.toy", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "kernels",
                              "moves": "toy_products_per_s", "workloads": ["toy.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load_cell("toy.small", root)
    result = run_cell(cell, 2 ** 31 + 99, 0.3, trace, device="cpu")
    assert result["correct"] is True and result["failed"] == 0, result["compared"]
    assert result["compared"]["toy_gap"]["limit"] == 1e-3
    if trace:
        assert set(result["metrics"]) == {"bmm_ms.toy"}
        assert result["metrics"]["bmm_ms.toy"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"toy_products_per_s", "peak_mem_gib", "setup_s"}
        assert result["metrics"]["toy_products_per_s"]["value"] > 0
    after = _digest(root)
    assert {p: d for p, d in after.items() if p in before} == before


def test_benchmark_json_names_its_files():
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    assert {c["name"] for c in spec["configs"]} == {"hop_ted", "hop_expressive"}
    for w in spec["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.per_layer and any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2
        for m in cell.per_layer:
            assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for c in spec["configs"]:
        assert dataclasses.is_dataclass(hop.program_config(json.loads(
            (HERE.parent / c["file"]).read_text())))
