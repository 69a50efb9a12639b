"""The plain reference against the port's CPU path on a tiny dataset, the
whole run driven through the harness; and the same run with the timed
path broken underneath, which has to come out not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shoeprint_image_retrieval_torch.retrieval import engine


@pytest.mark.parametrize("mode", ["standing", "cold"])
def test_reference_agrees_with_the_port_on_the_cpu(run_tiny, mode):
    rc, line = run_tiny(mode)
    assert rc == 0
    assert line["correct"] is True
    assert line["attempted"] >= 2 and line["failed"] == 0
    checks = line["checks"]
    assert list(line)[-1] == "checks"
    assert checks["plan"]["value"] == 0 and checks["rank"]["value"] == 0
    assert checks["score_gap"]["value"] < 1e-6


def _altered_regroup(offset_rows):
    real = engine.regroup_max

    def regroup(scores, layout):
        out = real(scores, layout).clone()
        offset_rows(out)
        return out

    return regroup


def _answer_altered(out):
    out[0, 0] += 1e-3


def _half_left_out(out):
    half = out.shape[0] // 2 or 1
    out[:half] = out[half:].mean(dim=0) if out.shape[0] > 1 else 0.0


@pytest.mark.parametrize("fault", [_answer_altered, _half_left_out], ids=["answer", "half"])
def test_a_broken_score_comes_out_not_correct(run_tiny, monkeypatch, fault):
    monkeypatch.setattr(engine, "regroup_max", _altered_regroup(fault))
    rc, line = run_tiny("standing")
    assert rc == 0 and line["correct"] is False


def test_a_batch_that_returns_the_previous_answer_comes_out_not_correct(run_tiny, monkeypatch):
    real = engine.Pipeline.run_cluster
    last = {}

    def stale(self, plan, next_plan=None):
        out = real(self, plan, next_plan)
        prev, last["out"] = last.get("out"), out
        if prev is not None and len(prev.ranks) == len(out.ranks):
            out.scores = prev.scores
        return out

    monkeypatch.setattr(engine.Pipeline, "run_cluster", stale)
    rc, line = run_tiny("standing", seconds=0.5)
    assert rc == 0 and line["correct"] is False


def test_no_card_no_result(run_tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, line = run_tiny("standing", device="cuda")
    assert rc != 0 and line is None


def test_the_control_takes_the_programs_place(run_tiny):
    """With ``--control 1`` the line's checks, and so ``correct``, are the
    control's; the program's own numbers move to ``run.program_checks``."""
    rc, line = run_tiny("standing", control=1)
    assert rc == 0
    checks, program = line["checks"], line["run"]["program_checks"]
    assert program["score_gap"]["value"] < 1e-6
    assert checks["score_gap"]["value"] != program["score_gap"]["value"]
    assert line["correct"] is all(v["value"] <= v["limit"] for v in checks.values())


@pytest.mark.gpu
def test_tf32_control_fails_where_the_program_passes(run_tiny):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a card: the CPU has no TF32")
    readings = []
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        rc, line = run_tiny("standing", device="cuda", control=1, seed=seed, score_gap=1e-6)
        assert rc == 0
        program = line["run"]["program_checks"]
        readings.append((program["score_gap"]["value"], line["checks"]["score_gap"]["value"]))
        assert all(v["value"] <= v["limit"] for v in program.values()), readings
        assert line["correct"] is False, readings
    assert np.isfinite(readings).all()
