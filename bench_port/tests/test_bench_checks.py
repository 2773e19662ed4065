"""Whole runs at a small size: the result line's shape, sound runs read
correct, and every fault planted under the timed path reads not correct
(on the CPU, the look for a chip skipped). On a card, the control (the
reference in TF32 in the program's place) reads not correct too."""

import pytest

from bench_port.lib import faults
from tiny import run_tiny

TRAIN = "occuseg-m64.train-b5"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_a_sound_run_is_correct():
    rc, res, err = run_tiny(TRAIN)
    assert rc == 0, err
    assert res["correct"], res["checks"]
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_traced_run_reads_its_layers():
    rc, res, err = run_tiny(TRAIN, "--trace", "1")
    assert rc == 0, err
    assert {"plan_wait_ms.train", "mfu.train"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_a_fault_reads_not_correct(fault):
    rc, res, err = run_tiny(TRAIN, "--fault", fault)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
def test_the_control_reads_not_correct_on_a_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control is TF32, which only a CUDA card computes")
    rc, res, err = run_tiny(TRAIN, "--control", "1", device="cuda")
    assert rc == 0, err
    assert res["correct"], res["checks"]
    limits = {name: limit for name, _, limit in res["checks"]}
    assert any(res["control"][k] > limits[k] for k in limits), res
