"""The port's benchmark orchestration plane (vodascheduler_tpu_torch/
benchrunner/): each test of `tests/test_benchrunner.py` against the port's
package (per-point subprocess isolation, watchdog kills, provenance-tagged
cache back-fill, crash-safe journal resume, the dry run end to end), then
the port's own worker on the CPU under ``VODA_HWBENCH_ON_CPU=1``: real
attention, model and resize points through the subprocess machinery, a
failing model point reported as its error and never retried on the plain
attention, the ici point skipped (it needs two cards), a point without
CUDA or the switch refused, and the memory telemetry of a point.
"""

import json
import os

import pytest

from vodascheduler_tpu_torch.benchrunner import (
    BenchOrchestrator,
    BenchPoint,
    default_registry,
    ordered,
    run_key_for,
    to_hardware_section,
    validate_summary,
)
from vodascheduler_tpu_torch.benchrunner.cache import ResultCache
from vodascheduler_tpu_torch.benchrunner.journal import RunJournal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ok_point(pid, data=None, risk=0, section=None):
    return BenchPoint(pid, "debug",
                      {"behavior": "ok", "data": data or {"id": pid}},
                      risk=risk, section=section)


def orch(points, tmp_path, **kw):
    return BenchOrchestrator(
        points, repo_dir=REPO,
        cache_path=os.fspath(tmp_path / "cache.json"),
        journal_path=os.fspath(tmp_path / "journal.jsonl"), **kw)


class TestRegistry:
    def test_risk_ordering_riskiest_last(self):
        pts = default_registry(
            model_points=[("llama_350m", 8), ("llama_1b", 4),
                          ("llama_350m_af", 8)],
            attention_points=[(8, 1024), (1, 8192)],
            moe_batch=8, resize_points=[("llama_350m", 8)])
        ids = [p.point_id for p in pts]
        # meta probes first; the known-good flagship before the risky
        # compiles; resize last (its children must own the chip).
        assert ids[0] == "meta"
        assert ids.index("model:llama_350m:b8") < ids.index(
            "model:llama_350m_af:b8")
        assert ids.index("model:llama_350m_af:b8") < ids.index(
            "model:llama_1b:b4")
        assert ids.index("attention:b8:s1024") < ids.index(
            "attention:b1:s8192")
        assert ids[-1] == "resize:llama_350m:b8"

    def test_ordering_is_stable_within_tier(self):
        pts = [ok_point("a", risk=5), ok_point("b", risk=5),
               ok_point("c", risk=1)]
        assert [p.point_id for p in ordered(pts)] == ["c", "a", "b"]

    def test_config_hash_tracks_spec(self):
        a = BenchPoint("x", "model", {"model_name": "m", "global_batch_size": 8})
        b = BenchPoint("x", "model", {"model_name": "m", "global_batch_size": 16})
        c = BenchPoint("x", "model", {"global_batch_size": 8, "model_name": "m"})
        assert a.config_hash() != b.config_hash()
        assert a.config_hash() == c.config_hash()  # key order irrelevant

    def test_run_key_changes_with_point_set(self):
        a = [ok_point("a"), ok_point("b")]
        assert run_key_for(a) != run_key_for(a[:1])


class TestWatchdog:
    def test_wedged_point_killed_later_points_complete(self, tmp_path):
        """The acceptance scenario: a hang (the wedged-compile stand-in,
        unkillable from inside on a real chip) is killed by the per-point
        watchdog; every other point still measures; every registered row
        is tagged; there is no whole-stream stall error."""
        points = [
            ok_point("first", {"v": 1}, risk=0),
            BenchPoint("wedge", "debug", {"behavior": "hang", "seconds": 600},
                       risk=5, timeout_seconds=2.0),
            ok_point("after-the-wedge", {"v": 2}, risk=10),
        ]
        summary = orch(points, tmp_path).run()
        assert validate_summary(summary, points) == []
        rows = {r["point_id"]: r for r in summary["rows"]}
        assert rows["first"]["provenance"] == "measured"
        assert rows["after-the-wedge"]["provenance"] == "measured"
        assert rows["wedge"]["provenance"].startswith(
            "skipped:watchdog_timeout")
        assert summary["stats"] == {"total": 3, "measured": 2, "cached": 0,
                                    "skipped": 1}

    def test_budget_exhaustion_eats_the_risky_tail(self, tmp_path):
        """A slow point that consumes the whole budget leaves the later
        (riskier) points tagged budget_exhausted — never silently absent."""
        points = [
            BenchPoint("slow", "debug", {"behavior": "slow", "seconds": 2.0},
                       risk=0, timeout_seconds=30.0),
            ok_point("tail", risk=10),
        ]
        summary = orch(points, tmp_path, total_budget_seconds=2.2).run()
        rows = {r["point_id"]: r for r in summary["rows"]}
        assert rows["tail"]["provenance"].startswith(
            ("skipped:budget_exhausted", "skipped:watchdog_timeout"))
        assert validate_summary(summary, points) == []

    def test_failing_point_isolated(self, tmp_path):
        points = [ok_point("good"),
                  BenchPoint("bad", "debug",
                             {"behavior": "fail", "message": "boom"}, risk=1)]
        summary = orch(points, tmp_path).run()
        rows = {r["point_id"]: r for r in summary["rows"]}
        assert rows["good"]["provenance"] == "measured"
        assert rows["bad"]["provenance"] == "skipped:point_error"
        assert "boom" in rows["bad"]["error"]


class TestCacheBackfill:
    def test_backfill_emits_cached_from(self, tmp_path):
        """A point that fails live back-fills from the last same-config
        measurement with an explicit per-row cached_from tag."""
        flaky = BenchPoint("flaky", "debug",
                           {"behavior": "fail", "message": "transient"})
        cache = ResultCache(os.fspath(tmp_path / "cache.json"))
        cache.put("flaky", flaky.config_hash(), {"mfu": 0.42})

        summary = orch([ok_point("good"), flaky], tmp_path).run()
        rows = {r["point_id"]: r for r in summary["rows"]}
        assert rows["flaky"]["provenance"].startswith("cached_from:")
        assert rows["flaky"]["data"] == {"mfu": 0.42}
        assert "transient" in rows["flaky"]["error"]  # live failure kept
        assert validate_summary(summary, [ok_point("good"), flaky]) == []

    def test_stale_config_does_not_backfill(self, tmp_path):
        """A cached row measured under a DIFFERENT spec must not back-fill
        — stale-config replay is worse than an honest skip."""
        cache = ResultCache(os.fspath(tmp_path / "cache.json"))
        old = BenchPoint("p", "debug", {"behavior": "fail", "message": "x",
                                        "extra": "old-config"})
        cache.put("p", old.config_hash(), {"mfu": 0.99})
        new = BenchPoint("p", "debug", {"behavior": "fail", "message": "x"})
        summary = orch([new], tmp_path).run()
        assert summary["rows"][0]["provenance"] == "skipped:point_error"

    def test_measured_points_written_through_to_cache(self, tmp_path):
        p = ok_point("keeper", {"step_time_ms": 7.0})
        orch([p], tmp_path).run()
        cache = ResultCache(os.fspath(tmp_path / "cache.json"))
        hit = cache.get("keeper", p.config_hash())
        assert hit["data"] == {"step_time_ms": 7.0}
        assert hit["captured_at"]

    def test_corrupt_cache_is_survivable(self, tmp_path):
        (tmp_path / "cache.json").write_text("{not json")
        summary = orch([ok_point("a")], tmp_path).run()
        assert summary["stats"]["measured"] == 1


class TestJournalResume:
    def test_interrupted_run_resumes_without_rerunning(self, tmp_path):
        """Completed points replay from the journal: the resumed run must
        NOT re-execute them. The already-done point is a hang — if resume
        is broken the watchdog fires and the provenance gives it away."""
        done = BenchPoint("expensive", "debug",
                          {"behavior": "hang", "seconds": 600},
                          timeout_seconds=3.0)
        rest = ok_point("remaining", risk=5)
        points = [done, rest]
        # Simulate the interrupted run: run_start + the expensive point's
        # point_done, no run_end (the crash).
        j = RunJournal(os.fspath(tmp_path / "journal.jsonl"),
                       run_key_for(ordered(points)))
        j.open()
        j.point_done("expensive", done.config_hash(), {"mfu": 0.4})
        # no j.end(): the orchestrator died here

        summary = orch(points, tmp_path).run()
        rows = {r["point_id"]: r for r in summary["rows"]}
        assert rows["expensive"]["provenance"] == "measured"
        assert rows["expensive"]["data"] == {"mfu": 0.4}
        assert rows["remaining"]["provenance"] == "measured"

    def test_completed_run_starts_fresh(self, tmp_path):
        """A journal WITH run_end is a finished capture: the next run
        re-measures (same-config staleness is the cache's job, with its
        explicit tag — journal replay must not silently age evidence)."""
        p = ok_point("a", {"v": 1})
        o = orch([p], tmp_path)
        o.run()
        # Second run: journal has run_end, so nothing resumes; the point
        # re-measures (observable: journal now has a fresh run_start).
        summary = orch([p], tmp_path).run()
        assert summary["rows"][0]["provenance"] == "measured"
        lines = [json.loads(line) for line in
                 (tmp_path / "journal.jsonl").read_text().splitlines()]
        assert [x["event"] for x in lines] == [
            "run_start", "point_done", "run_end"]

    def test_different_point_set_invalidates_journal(self, tmp_path):
        old = [ok_point("a")]
        j = RunJournal(os.fspath(tmp_path / "journal.jsonl"),
                       run_key_for(old))
        j.open()
        j.point_done("a", old[0].config_hash(), {"v": 1})
        new_points = [ok_point("a"), ok_point("b")]
        o = orch(new_points, tmp_path)
        assert o.journal.load_resumable() == {}

    def test_torn_final_line_tolerated(self, tmp_path):
        p = ok_point("a")
        path = tmp_path / "journal.jsonl"
        j = RunJournal(os.fspath(path), run_key_for([p]))
        j.open()
        j.point_done("a", p.config_hash(), {"v": 1})
        with open(path, "a") as f:
            f.write('{"event": "point_done", "point_id": "tor')  # the crash
        resumable = RunJournal(os.fspath(path),
                               run_key_for([p])).load_resumable()
        assert resumable["a"]["data"] == {"v": 1}


class TestSummaryContract:
    def test_validate_summary_catches_gaps(self):
        points = [ok_point("a"), ok_point("b")]
        summary = {"rows": [
            {"point_id": "a", "provenance": "measured", "data": {}}]}
        problems = validate_summary(summary, points)
        assert any("missing row for b" in p for p in problems)

    def test_validate_summary_catches_untagged(self):
        points = [ok_point("a")]
        summary = {"rows": [{"point_id": "a", "provenance": "", "data": {}}]}
        assert any("untagged" in p
                   for p in validate_summary(summary, points))

    def test_to_hardware_section_shapes(self, tmp_path):
        points = [
            BenchPoint("meta", "debug",
                       {"behavior": "ok", "data": {"backend": "fake"}},
                       risk=-1, section="meta"),
            BenchPoint("model:m:b8", "debug",
                       {"behavior": "ok", "data": {"model": "m", "batch": 8,
                                                   "mfu": 0.4}},
                       section="model"),
            BenchPoint("attention:b2:s128", "debug",
                       {"behavior": "fail"}, section="attention"),
        ]
        hw = to_hardware_section(orch(points, tmp_path).run())
        assert hw["backend"] == "fake"
        assert hw["meta_provenance"] == "measured"
        assert hw["models"][0]["mfu"] == 0.4
        assert hw["models"][0]["provenance"] == "measured"
        att = hw["attention"][0]
        assert att["provenance"].startswith("skipped:")
        assert "error" in att
        assert hw["benchrunner"]["stats"]["skipped"] == 1


class TestSilentEmptyAttentionRegression:
    """BENCH_r05 shipped `attention: []` when the stream wedged — absence
    indistinguishable from not-configured. The contract now: a wedged
    point costs its row (skipped:watchdog_timeout), budget exhaustion
    tags the rest, and EVERY registered attention shape appears in the
    artifact with its reason, even with no cache to fall back on."""

    SHAPES = [(8, 1024), (8, 4096), (1, 8192)]

    def _attention_points(self, wedge_first: bool):
        pts = []
        for i, (b, s) in enumerate(self.SHAPES):
            # batch/seq ride in the spec like real attention points —
            # that spec is what identifies a skipped row in the artifact.
            spec = ({"behavior": "hang", "seconds": 600,
                     "batch": b, "seq": s}
                    if (wedge_first and i == 0) else
                    {"behavior": "ok", "batch": b, "seq": s,
                     "data": {"batch": b, "seq": s, "flash_ms": 1.0}})
            pts.append(BenchPoint(f"attention:b{b}:s{s}", "debug", spec,
                                  risk=i, section="attention",
                                  timeout_seconds=2.0))
        return pts

    def test_wedged_point_leaves_skipped_rows_for_every_shape(self, tmp_path):
        """The injected wedge eats the whole budget: its row is a
        watchdog kill, the remaining shapes are budget_exhausted — and
        the artifact carries all three, none silently absent."""
        points = self._attention_points(wedge_first=True)
        summary = orch(points, tmp_path, total_budget_seconds=6.0).run()
        assert validate_summary(summary, points) == []
        hw = to_hardware_section(summary)
        assert len(hw["attention"]) == len(self.SHAPES)
        by_shape = {(a.get("batch"), a.get("seq")): a
                    for a in hw["attention"]}
        assert set(by_shape) == set(self.SHAPES)
        for shape, row in by_shape.items():
            assert row["provenance"].startswith("skipped:"), (shape, row)
        assert by_shape[self.SHAPES[0]]["provenance"].startswith(
            "skipped:watchdog_timeout")

    def test_bench_fallback_keeps_skipped_rows_without_cache(self, tmp_path):
        """bench.py's nothing-measured path: with no last-good cache the
        artifact must still be the summary's provenance-tagged rows plus
        the error — never a bare error with an empty attention list."""
        import sys
        sys.path.insert(0, REPO)
        from bench import _cached_fallback

        points = self._attention_points(wedge_first=True)
        summary = orch(points, tmp_path, total_budget_seconds=6.0).run()
        assert summary["stats"]["measured"] == 0
        out = _cached_fallback(os.fspath(tmp_path / "no-cache-here"),
                               "no point measured", summary=summary)
        assert out["error"] == "no point measured"
        assert len(out["attention"]) == len(self.SHAPES)
        assert all(a["provenance"].startswith("skipped:")
                   for a in out["attention"])


def test_bench_dryrun_end_to_end(tmp_path):
    """`make bench-dryrun`, in-process: the orchestrator runs end-to-end
    on the fake backend (real subprocess workers, a real watchdog kill)
    and the artifact validates with zero problems."""
    from vodascheduler_tpu_torch.benchrunner.dryrun import run_dryrun

    result = run_dryrun(workdir=os.fspath(tmp_path))
    assert result["ok"], result["problems"]
    assert result["stats"]["measured"] == 4
    assert result["stats"]["skipped"] == 2
    hw = result["hardware"]
    assert {m["provenance"] for m in hw["models"]} == {
        "measured", "skipped:watchdog_timeout(2s)"}
    assert hw["resize"][0]["provenance"] == "measured"


def test_worker_runs_real_tiny_attention_point_on_cpu(monkeypatch, tmp_path):
    """The real worker path, hermetically: one tiny attention point
    through the full subprocess isolation machinery, measured (on the CPU
    the kernels' wrapper takes the plain version)."""
    monkeypatch.setenv("VODA_HWBENCH_ON_CPU", "1")
    points = [BenchPoint("attention:b1:s64", "attention",
                         {"batch": 1, "seq": 64, "heads": 2, "head_dim": 8},
                         timeout_seconds=560.0)]
    summary = orch(points, tmp_path).run()
    assert validate_summary(summary, points) == []
    row = summary["rows"][0]
    assert row["provenance"] == "measured", row
    assert row["data"]["flash_ms"] > 0
    assert row["data"]["plain_ms"] > 0


# ---- the port's worker -------------------------------------------------------


def test_model_and_resize_points_measure_on_cpu(monkeypatch, tmp_path):
    """A model point (its peak given: the CPU has none) and a resize point,
    each in its own worker; the resize row's telemetry is its children's,
    which on the CPU read nothing."""
    monkeypatch.setenv("VODA_HWBENCH_ON_CPU", "1")
    points = [
        BenchPoint("meta", "meta", {}, risk=-100),
        BenchPoint("model:llama_tiny:b2", "model",
                   {"model_name": "llama_tiny", "global_batch_size": 2,
                    "k_small": 1, "k_big": 2, "reps": 1,
                    "peak_flops": 1e12}),
        BenchPoint("resize:mnist_mlp:b8", "resize",
                   {"model_name": "mnist_mlp", "global_batch_size": 8},
                   risk=60),
    ]
    summary = orch(points, tmp_path).run()
    assert validate_summary(summary, points) == []
    rows = {r["point_id"]: r for r in summary["rows"]}
    assert {r["provenance"] for r in rows.values()} == {"measured"}
    assert rows["meta"]["data"]["backend"] == "cpu"
    assert rows["model:llama_tiny:b2"]["data"]["step_time_ms"] > 0
    resize = rows["resize:mnist_mlp:b8"]
    assert resize["data"]["resize_cost_seconds"] > 0
    assert "child_telemetry" not in resize["data"]
    assert "telemetry" not in resize
    hw = to_hardware_section(summary)
    assert hw["resize"][0]["provenance"] == "measured"


def test_failing_model_point_is_an_error_row_not_a_retry(monkeypatch,
                                                          capsys):
    """The reference retries a failed model point on the XLA attention;
    the port reports the failure: one call, the flag untouched."""
    from vodascheduler_tpu_torch.benchrunner import worker
    from vodascheduler_tpu_torch.runtime import hwbench

    monkeypatch.setenv("VODA_HWBENCH_ON_CPU", "1")
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    calls = []

    def failing(**kw):
        calls.append(os.environ.get("VODA_FLASH_ATTENTION"))
        raise RuntimeError("flash kernel failed")

    monkeypatch.setattr(hwbench, "bench_model_step", failing)
    worker.main([json.dumps({"point_id": "model:m:b8", "kind": "model",
                             "spec": {"model_name": "m",
                                      "global_batch_size": 8}})])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    from vodascheduler_tpu_torch.benchrunner.points import RESULT_PREFIX
    out = json.loads(line[len(RESULT_PREFIX):])
    assert out == {"point_id": "model:m:b8",
                   "error": "RuntimeError: flash kernel failed"}
    assert calls == [None]
    assert "VODA_FLASH_ATTENTION" not in os.environ


def test_ici_point_is_skipped_with_its_reason(monkeypatch, tmp_path):
    monkeypatch.setenv("VODA_HWBENCH_ON_CPU", "1")
    points = default_registry(attention_points=(), moe_batch=None)
    summary = orch(points, tmp_path).run()
    rows = {r["point_id"]: r for r in summary["rows"]}
    assert rows["meta"]["provenance"] == "measured"
    assert rows["ici:r0"]["provenance"] == "skipped:point_error"
    assert "NVLink" in rows["ici:r0"]["error"]


@pytest.mark.parametrize("kind", ["meta", "model", "attention", "moe"])
def test_point_without_cuda_or_the_switch_is_refused(kind, monkeypatch):
    from vodascheduler_tpu_torch.benchrunner import worker
    monkeypatch.delenv("VODA_HWBENCH_ON_CPU", raising=False)
    with pytest.raises(RuntimeError, match="requires a CUDA device"):
        worker.run_point(kind, {})


class _FakeNvml:
    def device_count(self):
        return 1

    def read(self, index):
        return {"memory_bytes_in_use": 5.0, "memory_bytes_total": 80.0,
                "memory_bytes_free": 75.0, "utilization_pct": 3.0,
                "power_watts": 90.0, "power_limit_watts": 700.0}


def test_telemetry_snapshot_reads_nvml_and_never_raises(monkeypatch):
    from vodascheduler_tpu_torch.runtime import gpu_monitor
    monkeypatch.setattr(gpu_monitor, "NvmlReader", _FakeNvml)
    assert gpu_monitor.telemetry_snapshot() == {"nvml": {"0": {
        "memory_bytes_in_use": 5.0, "memory_bytes_total": 80.0,
        "power_limit_watts": 700.0}}}

    class Broken:
        def __init__(self):
            raise OSError("no libnvidia-ml")
    monkeypatch.setattr(gpu_monitor, "NvmlReader", Broken)
    assert gpu_monitor.telemetry_snapshot() == {}
    assert gpu_monitor.hbm_in_use_bytes() is None


def test_worker_telemetry_is_the_children_for_a_resize(monkeypatch):
    from vodascheduler_tpu_torch.benchrunner import worker
    data = {"resize_cost_seconds": 1.0, "child_telemetry": {
        "prepare": {"memory": {"0": {"allocated_bytes.all.peak": 9.0}}},
        "restart": {}}}
    assert worker._telemetry(data) == {
        "prepare": {"memory": {"0": {"allocated_bytes.all.peak": 9.0}}}}
    assert data == {"resize_cost_seconds": 1.0}
    monkeypatch.setenv("VODA_BENCH_TELEMETRY", "0")
    data = {"child_telemetry": {"prepare": {"nvml": {}}}}
    assert worker._telemetry(data) is None and data == {}
