"""The port prices a resize from the card's own artifact.

`replay/restart_costs.py` is the JAX package's text but for
`MEASURED_PATH`: the port reads `doc/resize_measured_h100.json`, written on
an H100 by `scripts/capture_gpu_resize.py` (the port's benchrunner over
resize points), and never the JAX package's TPU file
`doc/resize_measured.json`, which the reference goes on reading. Where the
card's file is absent the reference's own fallback applies: the assumed
costs, tagged `assumed`.
"""

import json
import math
import os

import pytest

from vodascheduler_tpu.replay import restart_costs as ref
from vodascheduler_tpu_torch.replay import restart_costs as port
from vodascheduler_tpu_torch.replay.trace import MODEL_FAMILIES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_FILE = os.path.join(REPO, "doc", "resize_measured_h100.json")
TPU_FILE = os.path.join(REPO, "doc", "resize_measured.json")


def test_the_port_names_the_card_file_and_never_the_tpu_file():
    assert port.MEASURED_PATH == CARD_FILE
    assert ref.MEASURED_PATH == TPU_FILE
    assert os.path.basename(port.MEASURED_PATH) != "resize_measured.json"


def _points():
    with open(CARD_FILE) as f:
        doc = json.load(f)
    return doc["points"]


def test_the_card_artifact_is_complete_and_names_its_card():
    points = _points()
    assert sorted(p["model"] for p in points) == ["llama_350m",
                                                  "mixtral_small"]
    for p in points:
        assert port._complete(p), p["model"]
        assert p["backend"] == "gpu"
        assert "H100" in p["device"] and p["device"].endswith(" W")
        assert p["session"]
        assert p["batch"] == 8
        # The fast row is measured: one NCCL rank resized 1 -> 1 in place,
        # its first step the prepare child's same step.
        fast = {r["path"]: r for r in p["resize_paths"]}["fast"]
        assert p["fast_resize_ms"] > 0 and not p.get("fast_error")
        assert fast == {"path": "fast", "seconds": round(
            p["fast_resize_ms"] / 1000.0, 2), "from_chips": 1, "to_chips": 1}
        assert 0 < p["fast_resize_ms"] / 1000.0 < p["resize_cost_seconds"]
        a, b = p["prepare_next_step_loss"], p["fast_first_step_loss"]
        assert abs(a - b) <= 1e-5 * abs(a)
        assert (p["fast_memory_before_bytes"] < p["fast_peak_bytes"]
                < 80e9)
        for a, b in ((p["prepare_next_step_loss"],
                      p["restart_first_step_loss"]),
                     (p["prepare_second_step_loss"],
                      p["restart_second_step_loss"])):
            assert abs(a - b) <= 1e-3 * abs(a)


def test_family_costs_derive_from_the_card_artifact():
    costs = port.family_restart_costs()
    assert set(costs) == set(MODEL_FAMILIES)
    assert costs == port.derive_costs(_points())
    for fam, cost in costs.items():
        assert math.isfinite(cost.restart_s) and cost.restart_s > 0, fam
        assert cost.provenance.startswith("scaled:")
        assert cost.provenance.endswith(
            "(measured on llama_350m,mixtral_small)")
        # The fast points give the in-place costs: a measured share of
        # the cold ones.
        assert cost.inplace_provenance.startswith("scaled:")
        assert cost.inplace_provenance.endswith(
            "(measured on llama_350m,mixtral_small)")
        assert 0.5 <= cost.inplace_s < cost.restart_s


def test_the_reference_still_derives_from_the_tpu_file():
    with open(TPU_FILE) as f:
        tpu = [p for p in json.load(f)["points"] if ref._complete(p)]
    assert ref.family_restart_costs() == ref.derive_costs(tpu)
    assert {c.restart_s for c in port.family_restart_costs().values()} != {
        c.restart_s for c in ref.family_restart_costs().values()}


def test_without_the_card_file_the_costs_are_assumed(monkeypatch, tmp_path):
    monkeypatch.setattr(port, "MEASURED_PATH",
                        os.fspath(tmp_path / "resize_measured_h100.json"))
    costs = port.family_restart_costs()
    assert {c.provenance for c in costs.values()} == {"assumed"}
    assert {f: c.restart_s for f, c in costs.items()} == \
        port.ASSUMED_RESTART_S


@pytest.mark.parametrize("fn,attr", [
    ("default_restart_seconds", "restart_s"),
    ("default_inplace_seconds", "inplace_s")])
def test_the_fallbacks_weigh_the_card_costs(fn, attr):
    costs = port.family_restart_costs()
    num = sum(float(s["weight"]) * getattr(costs[f], attr)
              for f, s in MODEL_FAMILIES.items())
    den = sum(float(s["weight"]) for s in MODEL_FAMILIES.values())
    assert getattr(port, fn)() == round(num / den, 1)
