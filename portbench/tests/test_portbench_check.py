"""The whole harness at tiny widths on the CPU: the plain reference against
the port (the training step and the forward), the check failing under each
planted fault, and the result line's keys."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import faults
from portbench.run import main, run_cell
from portbench.tests.tiny import tiny_cell

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def run(cell, trace=False, seconds=0.5):
    return run_cell(cell, 2 ** 31 + 4321, seconds, trace, device="cpu",
                    start=time.perf_counter())


@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_step_matches_reference(prefetch):
    result = run(tiny_cell("train_gan", "TED_expressive", prefetch=prefetch))
    assert result["correct"], result["compared"]
    assert list(result) == RESULT_KEYS
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}


def test_forward_matches_reference():
    result = run(tiny_cell("generate"))
    assert result["correct"], result["compared"]
    assert list(result) == RESULT_KEYS
    assert set(result["metrics"]) == {"gen_windows_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("kind,fault", [("train_gan", "frozen_state"),
                                        ("train_gan", "half_batch"),
                                        ("train_gan", "lr_high"),
                                        ("generate", "answer")])
def test_planted_fault_fails_the_check(kind, fault):
    with faults.planted(fault):
        result = run(tiny_cell(kind))
    assert result["correct"] is False, result["compared"]


def test_traced_line_has_the_trace_keys():
    result = run(tiny_cell("generate"), trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "compared"]
    assert {"busy_s", "window_s", "platform", "kind", "count",
            "memory_peak_bytes"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "host_forward_ms.gen" in result["metrics"]
    json.dumps(result)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", "hop_ted.generate_b1024", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
