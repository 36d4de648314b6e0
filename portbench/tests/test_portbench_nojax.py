"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port. Module names are compared by their
whole top-level name: the port's `hop_tpu_torch` is not `hop_tpu`."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "hop_tpu"}


def loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {imports}; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    top = loaded_after("import portbench.run, portbench.hop, portbench.calibrate, "
                       "portbench.reference.train, portbench.reference.data; "
                       "from portbench import cells; "
                       "[cells.kind_driver(p.stem) for p in (cells.HERE / 'kinds').glob('*.py')]; "
                       "[cells.metric_reader(p.stem) for p in (cells.HERE / 'metrics').glob('*.py')]; "
                       "import "
                       "hop_tpu_torch.train.llm, hop_tpu_torch.infer, "
                       "hop_tpu_torch.cli.common, hop_tpu_torch.models.multimodal_context")
    assert "hop_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    top = loaded_after("import portbench.reference.model, portbench.reference.train, "
                       "portbench.reference.data, portbench.weights, portbench.check")
    assert "hop_tpu_torch" not in top
    assert not top & FORBIDDEN


def test_no_benchmark_file_reads_the_jax_benchmarks():
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("benchmarks/", "BENCH_r", "BASELINE.json", "MULTICHIP_"):
            assert name not in text, (path, name)
