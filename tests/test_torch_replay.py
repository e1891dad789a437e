"""The port's replay package replays and plans exactly as the JAX package's.

`ReplayHarness` runs the same `philly_like_trace` (24 jobs, seed 5) on a
16-chip pool (a 4x2x2 torus of 2x2x1 hosts) in each package, under
ElasticFIFO and ElasticTiresias. When two thirds of the trace have
arrived, `Scheduler.whatif` plans every running job; then the replay runs to
its end. Compared for equality: the trace, the what-if reports (less the
fields that time the host) and the whole `ReplayReport`.

Both packages price a restart from the same artifact: the port's
`replay/restart_costs.py` reads the card's own
(`doc/resize_measured_h100.json`), so each test pins it to the JAX
package's `doc/resize_measured.json` (`one_restart_artifact`), and the
costs, and with them the reports, match.
"""

import importlib

import pytest

from tests.test_torch_scheduler import _strip


@pytest.fixture
def one_restart_artifact(monkeypatch):
    """Both packages price restarts from one artifact, the JAX package's
    `doc/resize_measured.json`; unpinned, the port reads the card's own
    (`doc/resize_measured_h100.json`). `test_torch_rest.py` uses it too."""
    from vodascheduler_tpu.replay import restart_costs as ref
    from vodascheduler_tpu_torch.replay import restart_costs as port
    monkeypatch.setattr(port, "MEASURED_PATH", ref.MEASURED_PATH)


pytestmark = pytest.mark.usefixtures("one_restart_artifact")

PKGS = ("vodascheduler_tpu", "vodascheduler_tpu_torch")
N_JOBS, SEED = 24, 5


def _replay(pkg, algorithm):
    replay = importlib.import_module(f"{pkg}.replay")
    topology = importlib.import_module(f"{pkg}.placement").PoolTopology(
        torus_dims=(4, 2, 2), host_block=(2, 2, 1))
    trace = replay.philly_like_trace(num_jobs=N_JOBS, seed=SEED)
    h = replay.ReplayHarness(trace, algorithm=algorithm, topology=topology)
    midway = trace[2 * N_JOBS // 3].submit_offset_seconds + h.clock.now()
    while h.clock.now() < midway:
        h.clock.advance_to(h.clock.next_timer())
    running = sorted(h.backend.running_jobs())
    assert running
    whatif = [h.scheduler.whatif(name) for name in running]
    report = h.run()
    return {"trace": [t.__dict__ for t in trace],
            "whatif": _strip(whatif),
            "report": report.to_dict()}


@pytest.mark.parametrize("algorithm", ["ElasticFIFO", "ElasticTiresias"])
def test_replay_report_and_whatif_equal_the_reference(algorithm):
    ref, port = (_replay(pkg, algorithm) for pkg in PKGS)
    assert ref["report"]["completed"] == N_JOBS
    assert any(c["modeled_remaining_s"] > 0
               for w in ref["whatif"] for c in w["candidates"])
    for key in ref:
        assert port[key] == ref[key], key
