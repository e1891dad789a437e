"""The port's REST layer answers exactly as the JAX package's does.

In each package a scheduler on the fake cluster (2 hosts x 4 chips,
ElasticTiresias, a journal on memory storage, a tracer on a
`VirtualClock`) sits behind `make_service_server` and
`make_scheduler_server` on free ports. The same requests go to both, with
the clock advanced between them: three jobs `POST /training` (YAML, as the
CLI sends it), one bad spec, `GET /training` on both servers, `DELETE
/training` of one job and of an unknown one, `PUT /ratelimit`, `GET
/debug/resched`, `/debug/whatif/<job>`, `/debug/trace/<job>`,
`/debug/journal` and `/pools`. Every status and JSON body must be equal,
less the fields that time the host.
"""

import importlib
import json
import urllib.error
import urllib.request

import pytest
import yaml

from tests.test_torch_replay import one_restart_artifact  # noqa: F401
from tests.test_torch_scheduler import HOST_TIMED, START, _strip

# `/debug/whatif` prices restarts: both packages from one artifact.
pytestmark = pytest.mark.usefixtures("one_restart_artifact")

PKGS = ("vodascheduler_tpu", "vodascheduler_tpu_torch")
EPOCH_SECONDS = 200.0


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _call(url, method="GET", body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _spec(name, lo, hi, epochs):
    return yaml.safe_dump({"name": name, "pool": "pool",
                           "config": {"min_num_chips": lo,
                                      "max_num_chips": hi,
                                      "epochs": epochs}}).encode()


def _session(pkg):
    clock = _mod(pkg, "common.clock").VirtualClock(start=START)
    tracer = _mod(pkg, "obs.tracer").Tracer(clock=clock)
    registry = _mod(pkg, "common.metrics").Registry()
    store = _mod(pkg, "common.store").JobStore()
    bus = _mod(pkg, "common.events").EventBus()
    fake = _mod(pkg, "cluster.fake")
    backend = fake.FakeClusterBackend(clock, restart_overhead_seconds=5.0)
    for i in range(2):
        backend.add_host(f"host-{i}", 4, announce=False)
    journal_mod = _mod(pkg, "durability.journal")
    sched = _mod(pkg, "scheduler").Scheduler(
        "pool", backend, store,
        _mod(pkg, "allocator").ResourceAllocator(store), clock, bus=bus,
        placement_manager=_mod(pkg, "placement").PlacementManager("pool"),
        algorithm="ElasticTiresias", rate_limit_seconds=1.0, tracer=tracer,
        registry=registry,
        journal=journal_mod.Journal(storage=journal_mod.MemoryStorage(),
                                    clock=clock))
    admission = _mod(pkg, "service").AdmissionService(
        store, bus, clock, registry=registry, tracer=tracer)
    rest = _mod(pkg, "service.rest")
    service = rest.make_service_server(admission, registry,
                                       host="127.0.0.1", port=0)
    scheduler = rest.make_scheduler_server(sched, registry,
                                           host="127.0.0.1", port=0)
    service.start()
    scheduler.start()
    svc = f"http://127.0.0.1:{service.port}"
    sch = f"http://127.0.0.1:{scheduler.port}"
    answers = []

    def ask(url, method="GET", body=None):
        answers.append((method, url.split(":", 2)[2].split("/", 1)[1],
                        *_call(url, method, body)))
        return answers[-1][-1]

    try:
        names = []
        for i, (lo, hi, epochs) in enumerate([(1, 4, 3), (2, 8, 2),
                                              (1, 2, 5)]):
            backend.register_profile(f"r{i}", fake.WorkloadProfile(
                epoch_seconds_at_1=EPOCH_SECONDS))
            out = ask(f"{svc}/training", "POST", _spec(f"r{i}", lo, hi,
                                                       epochs))
            names.append(out["name"])
            clock.advance(5.0)
        ask(f"{svc}/training", "POST", b"name: bad\nconfig: {min_num_chips: 0}")
        clock.advance(30.0)
        ask(f"{svc}/training")
        ask(f"{sch}/training")
        ask(f"{svc}/training?name={names[1]}", "DELETE")
        ask(f"{svc}/training?name=nope", "DELETE")
        ask(f"{sch}/ratelimit", "PUT", b"2.0")
        clock.advance(30.0)
        ask(f"{sch}/training")
        ask(f"{sch}/debug/resched?n=5")
        ask(f"{sch}/debug/whatif/{names[0]}")
        ask(f"{sch}/debug/whatif/nope")
        ask(f"{sch}/debug/trace/{names[2]}")
        ask(f"{sch}/pools")
        clock.advance(3000.0)
        ask(f"{svc}/training")
        ask(f"{sch}/debug/journal")
    finally:
        service.stop()
        scheduler.stop()
        sched.stop()
    return answers


# The snapshot's age in the journal's stats is wall time.
JOURNAL_HOST_FIELDS = {"snapshot_age_seconds"}


def _clean(answers):
    out = []
    for method, path, status, body in answers:
        if path.startswith("debug/journal") and isinstance(body, dict):
            body = {k: v for k, v in body.items()
                    if k not in JOURNAL_HOST_FIELDS}
        out.append((method, path, status, _strip(body)))
    return out


def test_rest_answers_equal_the_reference():
    ref, port = (_session(pkg) for pkg in PKGS)
    statuses = [status for _, _, status, _ in ref]
    assert statuses == [200, 200, 200, 400, 200, 200, 200, 400, 200, 200,
                        200, 200, 404, 200, 200, 200, 200], statuses
    assert _clean(port) == _clean(ref)
    (resched,) = [body for _, path, _, body in ref
                  if path.startswith("debug/resched")]
    assert len(resched) == 4
    # what the comparison leaves out is there to leave out
    assert HOST_TIMED & set(resched[-1])
    finished = [j["status"] for j in ref[-2][3]]
    assert finished == ["Completed", "Canceled", "Completed"], finished
