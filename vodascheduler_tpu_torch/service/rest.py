"""REST API layer: reference-parity endpoints over stdlib http.server.

Reference counterparts (SURVEY.md §1 layer map):
- Training service :55587 — POST/DELETE/GET /training, GET /metrics
  (pkg/service/service/service.go:31-36)
- Scheduler :55588 — GET /training, PUT /algorithm, PUT /ratelimit,
  GET /metrics (pkg/scheduler/scheduler/scheduler.go:256-261)
- Resource allocator :55589 — POST /allocation, GET /metrics
  (pkg/allocator/allocator/resource_allocator.go:41-44)

Job specs are accepted as YAML or JSON (YAML is a superset); the reference
accepts Kubernetes MPIJob YAML (handlers.go:142).

`RemoteAllocator` is the scheduler-side client for a split deployment —
the reference runs the allocator as a separate 2-replica microservice and
the scheduler POSTs each resched (scheduler.go:377-430). In-process use
(passing ResourceAllocator directly) remains the default.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import yaml

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.allocator import AllocationRequest, ResourceAllocator
from vodascheduler_tpu_torch.common.job import JobSpec
from vodascheduler_tpu_torch.common.metrics import Registry
from vodascheduler_tpu_torch.common.store import job_from_dict, job_to_dict
from vodascheduler_tpu_torch.obs import tracer as obs_tracer
from vodascheduler_tpu_torch.service.admission import (
    BATCH_SIBLING_REJECTED,
    AdmissionError,
    AdmissionService,
    AdmissionShed,
    NotLeader,
)

log = logging.getLogger(__name__)

# route table: (method, path) -> fn(body_bytes, query_dict) -> (status, payload)
# payload: dict/list (JSON), (content_type, str) for raw text, or a Raw
# (pre-serialized bytes written straight to the socket — the ingestion
# plane's cached snapshots are encoded once, not per request). A handler
# may return a third element: a dict of extra response headers (429 uses
# it for Retry-After).
# A path ending in "/*" is a prefix route: the remainder of the request
# path (e.g. the job name in /debug/trace/<job>) is passed to the handler
# as query["__path__"][0].
Route = Callable[[bytes, Dict[str, list]], Tuple[int, object]]


class Raw:
    """A pre-serialized response body: `_reply` writes the bytes as-is.
    Lets cached snapshots (scheduler status table, service job list,
    metrics exposition) serialize once per state change instead of once
    per request."""

    __slots__ = ("content_type", "data")

    def __init__(self, content_type: str, data: bytes):
        self.content_type = content_type
        self.data = data


class RestServer:
    """A route-table HTTP server on a background thread."""

    def __init__(self, routes: Dict[Tuple[str, str], Route],
                 host: str = "127.0.0.1", port: int = 0):
        # Exposed for tests/introspection: handlers are plain callables
        # of (body, query), so a route can be exercised without a
        # socket round trip.
        self.routes = routes
        class Handler(BaseHTTPRequestHandler):
            # Socket read timeout: a client that connects and never
            # sends a request line (or stalls mid-headers) must not pin
            # a handler thread forever — at fleet scale leaked threads
            # are the service's OOM. BaseHTTPRequestHandler honors this
            # attr via socket.settimeout.
            timeout = 30.0

            def log_message(self, fmt, *args):
                # The raw BaseHTTPRequestHandler line is dropped (klog-
                # level-5 noise); the structured http_access event emitted
                # by _dispatch is the access log.
                log.debug("%s - %s", self.address_string(), fmt % args)

            def _resolve(self, method: str, path: str):
                fn = routes.get((method, path))
                if fn is not None:
                    return fn, None
                # Longest-prefix wildcard match: ("GET", "/debug/trace/*")
                # serves /debug/trace/<job>.
                best = None
                for (m, pat), candidate in routes.items():
                    if m != method or not pat.endswith("/*"):
                        continue
                    prefix = pat[:-1]  # keep the trailing slash
                    if path.startswith(prefix) and (
                            best is None or len(prefix) > best[0]):
                        best = (len(prefix), candidate, path[len(prefix):])
                if best is None:
                    return None, None
                # Decode the segment: the CLI percent-encodes job names
                # (quote(name, safe='')), and the ?job= form decodes via
                # parse_qs — the two access paths must agree.
                from urllib.parse import unquote
                return best[1], unquote(best[2])

            def _dispatch(self, method: str) -> None:
                import time as _walltime

                parsed = urlparse(self.path)
                fn, wildcard = self._resolve(method, parsed.path)
                if fn is None:
                    self._reply(404, {"error": f"no route {method} {parsed.path}"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                query = parse_qs(parsed.query)
                if wildcard is not None:
                    query["__path__"] = [wildcard]
                # Cross-process trace propagation: a caller that sent
                # X-Voda-Trace-Id (RemoteAllocator does) has its context
                # installed as ambient for the handler, so spans opened
                # inside (allocator.allocate) stitch into its trace.
                ctx = obs_tracer.TraceContext.from_headers(self.headers)
                t0 = _walltime.monotonic()
                headers: Optional[Dict[str, str]] = None
                try:
                    with obs_tracer.use_context(ctx):
                        result = fn(body, query)
                    status, payload = result[0], result[1]
                    if len(result) > 2:
                        headers = result[2]
                except NotLeader as e:
                    # Deposed control plane (doc/durability.md): never
                    # ack a mutation the fenced scheduler would drop —
                    # 503 tells the client to retry against the
                    # current leader.
                    status, payload = 503, {"error": str(e)}
                except AdmissionShed as e:
                    # Backpressure (doc/observability.md "Ingestion
                    # plane"): the pool's event queue is past its shed
                    # watermark — tell the client when to come back
                    # instead of queueing it into an OOM.
                    status, payload = 429, {
                        "error": str(e),
                        "retry_after_seconds": e.retry_after}
                    headers = {"Retry-After":
                               str(max(1, int(round(e.retry_after))))}
                except (AdmissionError, KeyError, ValueError) as e:
                    status, payload = 400, {"error": str(e)}
                except Exception as e:
                    log.exception("handler error")
                    status, payload = 500, {"error": str(e)}
                # Structured access event (the log_message pass above
                # would otherwise silently drop all access logs): the
                # /debug endpoints are themselves observable.
                try:
                    rec = {
                        "kind": "http_access",
                        "method": method,
                        "path": parsed.path,
                        "status": int(status),
                        "duration_ms": round(
                            (_walltime.monotonic() - t0) * 1000.0, 3),
                    }
                    if ctx is not None:
                        rec["trace_id"] = ctx.trace_id
                    obs_tracer.get_tracer().emit(rec)
                except Exception:  # noqa: BLE001 - never fail a reply
                    log.debug("access event emit failed", exc_info=True)
                self._reply(status, payload, headers)

            def _reply(self, status: int, payload,
                       extra_headers: Optional[Dict[str, str]] = None
                       ) -> None:
                if isinstance(payload, Raw):
                    ctype, data = payload.content_type, payload.data
                elif (isinstance(payload, tuple) and len(payload) == 2
                        and isinstance(payload[0], str)):
                    ctype, text = payload
                    data = text if isinstance(text, bytes) else text.encode()
                else:
                    ctype = "application/json"
                    data = (json.dumps(payload) + "\n").encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for key, value in (extra_headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        class Server(ThreadingHTTPServer):
            # Explicitly pinned (stdlib default since 3.7, but this is
            # load-bearing): handler threads must never block process
            # exit — a stalled client on a dying control plane would
            # otherwise hang shutdown.
            daemon_threads = True

            def process_request_thread(self, request, client_address):
                # ThreadingMixIn names its threads Thread-N; rename so
                # RaceWitness and stack dumps attribute handler work to
                # the rest role (ROLE_PREFIXES in analysis/vodarace.py).
                threading.current_thread().name = \
                    f"voda-rest-{self.server_address[1]}"
                super().process_request_thread(request, client_address)

        self.httpd = Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name=f"voda-rest-accept-{self.port}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # shutdown() blocks until serve_forever acknowledges — which
        # never happens if start() was never called (socketserver
        # semantics); a constructed-but-unstarted server must still stop
        # cleanly (e.g. VodaApp torn down before start()).
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


_METRICS_CTYPE = "text/plain; version=0.0.4"


def _metrics_route(registry: Registry,
                   cache_seconds: Optional[float] = None) -> Route:
    """Prometheus exposition, serialized to bytes once per scrape. With
    a TTL (`VODA_METRICS_CACHE_SECONDS` > 0) concurrent scrapers inside
    the window share one rebuild — a fleet-wide scrape storm costs one
    exposition walk, at the price of up-to-TTL-stale counters (exact
    values remain the default: TTL 0)."""
    import time as _walltime

    ttl = config.METRICS_CACHE_SECONDS if cache_seconds is None \
        else cache_seconds
    state = {"at": -float("inf"), "data": b""}
    lock = threading.Lock()

    def metrics(body, query):
        if ttl > 0:
            with lock:
                # Single-flight: the rebuild happens under the lock, so
                # scrapers racing an expired stamp queue behind one
                # rebuild and then hit the fresh-stamp fast path —
                # K concurrent scrapers cost one exposition walk.
                if _walltime.monotonic() - state["at"] > ttl:
                    state["data"] = registry.exposition().encode()
                    state["at"] = _walltime.monotonic()
                return 200, Raw(_METRICS_CTYPE, state["data"])
        return 200, Raw(_METRICS_CTYPE, registry.exposition().encode())
    return metrics


def _job_name_from(body: bytes, query: Dict[str, list]) -> str:
    if query.get("name"):
        return query["name"][0]
    if body:
        data = yaml.safe_load(body)
        if isinstance(data, str):
            return data.strip()
        if isinstance(data, dict) and "name" in data:
            return str(data["name"])
    raise ValueError("job name required (?name= or JSON body {name})")


def make_service_server(admission: AdmissionService, registry: Registry,
                        host: str = "0.0.0.0",
                        port: int = config.SERVICE_PORT) -> RestServer:
    """Training-service API (reference: service.go:31-36)."""

    def create(body, query):
        data = yaml.safe_load(body)
        if not isinstance(data, dict):
            raise ValueError("body must be a YAML/JSON job spec mapping")
        spec = JobSpec.from_dict(data)
        name = admission.create_training_job(spec)
        return 200, {"name": name}

    def create_batch(body, query):
        """Bulk admission (doc/observability.md "Ingestion plane"): a
        YAML/JSON list of job specs (or `{specs: [...]}`) admitted
        atomically — per-item results, 200 only when every spec was
        admitted, 400 with zero residue otherwise (one store commit, one
        cross-pool-atomic publish_many_multi)."""
        data = yaml.safe_load(body)
        if isinstance(data, dict) and "specs" in data:
            data = data["specs"]
        if not isinstance(data, list) or not data:
            raise ValueError("body must be a non-empty list of job "
                             "specs (or {specs: [...]})")
        specs: list = []
        parse_errors: Dict[int, str] = {}
        for i, item in enumerate(data):
            try:
                if not isinstance(item, dict):
                    raise ValueError("spec must be a mapping")
                specs.append(JobSpec.from_dict(item))
            except Exception as e:  # noqa: BLE001 - per-item outcome
                parse_errors[i] = str(e)
                specs.append(None)
        if parse_errors:
            # Atomicity holds before admission is even consulted: a
            # batch with any malformed spec admits nothing.
            results = [
                {"name": (item.get("name", "?")
                          if isinstance(item, dict) else "?"),
                 "error": parse_errors.get(i, BATCH_SIBLING_REJECTED)}
                for i, item in enumerate(data)]
            return 400, {"admitted": 0, "results": results}
        results = admission.create_training_jobs(specs)
        admitted = sum(1 for r in results if "error" not in r)
        status = 200 if admitted == len(results) else 400
        return status, {"admitted": admitted, "results": results}

    def delete(body, query):
        name = _job_name_from(body, query)
        admission.delete_training_job(name)
        return 200, {"deleted": name}

    # GET /training snapshot cache: rebuilt only when the store's
    # mutation stamp moves, so a 10k-job fleet under poll load serves
    # the same pre-encoded bytes until something actually changes.
    jobs_cache = {"version": -1, "data": b""}
    jobs_cache_lock = threading.Lock()

    def get_jobs(body, query):
        with jobs_cache_lock:
            # Single-flight (the _metrics_route idiom): the rebuild runs
            # under the lock, so K pollers racing a store-version bump
            # queue behind ONE list_jobs + serialization and then hit
            # the fresh-stamp fast path. Stamped with the version read
            # BEFORE the rebuild: a write racing the rebuild just forces
            # the next reader to rebuild again — never a stale hit.
            version = admission.store.version
            if jobs_cache["version"] != version:
                jobs = admission.store.list_jobs()
                rows = [{
                    "name": j.name, "pool": j.pool,
                    "status": j.status.value, "priority": j.priority,
                    "submit_time": j.submit_time,
                } for j in sorted(jobs, key=lambda j: j.submit_time)]
                jobs_cache["version"] = version
                jobs_cache["data"] = (json.dumps(rows) + "\n").encode()
            return 200, Raw("application/json", jobs_cache["data"])

    def debug_ingest(body, query):
        """Ingestion-plane stats (shed/drop counters, queue depth,
        recent admission p50/p99, last burst) — backs `voda top`'s
        ingestion section (doc/observability.md "Ingestion plane")."""
        return 200, admission.ingest_stats()

    return RestServer({
        ("POST", "/training"): create,
        ("POST", "/training/batch"): create_batch,
        ("DELETE", "/training"): delete,
        ("GET", "/training"): get_jobs,
        ("GET", "/debug/ingest"): debug_ingest,
        ("GET", "/metrics"): _metrics_route(registry),
    }, host, port)


def make_scheduler_server(scheduler, registry: Registry,
                          host: str = "0.0.0.0",
                          port: int = config.SCHEDULER_PORT,
                          fleet=None,
                          standby_stats=None) -> RestServer:
    """Scheduler API (reference: scheduler.go:256-261).

    Accepts a single Scheduler or a {pool: Scheduler} dict; with several
    pools the `?pool=` query (or a "pool" body key) routes the request —
    the single-port composition of the reference's one-service-per-pool
    deployment. Default: the sole pool, else 400 listing the choices.
    """
    schedulers = scheduler if isinstance(scheduler, dict) else \
        {getattr(scheduler, "pool_id", "default"): scheduler}

    def pick(body, query):
        pool = (query.get("pool", [None])[0]
                if isinstance(query.get("pool"), list) else query.get("pool"))
        if pool is None and body:
            try:
                data = yaml.safe_load(body)
                if isinstance(data, dict):
                    pool = data.get("pool")
            except Exception:
                pool = None
        if pool is None:
            if len(schedulers) == 1:
                return next(iter(schedulers.values()))
            raise ValueError(
                f"multiple pools {sorted(schedulers)}: pass ?pool=<name>")
        if pool not in schedulers:
            raise ValueError(f"unknown pool {pool!r}; have {sorted(schedulers)}")
        return schedulers[pool]

    def get_training(body, query):
        # Pre-encoded snapshot bytes (scheduler.status_table_json): the
        # cache is stamped by the scheduler's state version and read
        # lock-free, so scrapes stay live — and cheap — while a resched
        # pass is in flight.
        return 200, Raw("application/json",
                        pick(body, query).status_table_json())

    def put_algorithm(body, query):
        data = yaml.safe_load(body)
        name = data["algorithm"] if isinstance(data, dict) else str(data).strip()
        pick(body, query).set_algorithm(name)
        return 200, {"algorithm": name}

    def put_ratelimit(body, query):
        data = yaml.safe_load(body)
        seconds = float(data["seconds"] if isinstance(data, dict) else data)
        pick(body, query).set_rate_limit(seconds)
        return 200, {"seconds": seconds}

    def get_pools(body, query):
        return 200, {name: {"algorithm": s.algorithm,
                            "total_chips": s.total_chips}
                     for name, s in schedulers.items()}

    def debug_resched(body, query):
        """Last K decision-audit records (?n=K, default 20) — the
        machine-readable why of recent rescheds (doc/observability.md)."""
        n = int(query.get("n", ["20"])[0])
        return 200, pick(body, query).audit_records(n)

    def debug_trace(body, query):
        """Decision history + spans for one job: /debug/trace/<job> or
        ?job=<name>. Backs `voda explain <job>`. `perf` is the newest
        phase-level perf_report whose pass acted on the job (where the
        time went; null when no profiled pass touched it)."""
        job = (query.get("__path__", [None])[0]
               or query.get("job", [None])[0])
        if not job:
            raise ValueError("job name required: /debug/trace/<job>")
        sched = pick(body, query)
        return 200, {
            "job": job,
            "records": sched.explain_job(job),
            "spans": sched.tracer.spans_for_job(job, limit=200),
            "perf": sched.explain_profile(job),
        }

    def debug_profile(body, query):
        """Last K phase-level perf_report records (?n=K, default 20) —
        the performance observatory's per-pass breakdowns, same shape as
        /debug/resched (doc/observability.md). Backs `voda top`."""
        n = int(query.get("n", ["20"])[0])
        return 200, pick(body, query).profile_records(n)

    def debug_journal(body, query):
        """The durability plane's health (doc/durability.md): journal
        size, last seq, fencing epoch, snapshot age, torn-tail count,
        and the last crash recovery's audited report. Backs the
        `voda top` durability line; `voda fsck` is the offline
        counterpart."""
        return 200, pick(body, query).journal_stats()

    def debug_whatif(body, query):
        """What-if shadow plan for one job (doc/learned-models.md):
        /debug/whatif/<job> or ?job=<name>. Backs `voda explain
        --whatif <job>`. Runs on the scheduler's bounded planner
        worker — read-only, never on the decide critical path."""
        job = (query.get("__path__", [None])[0]
               or query.get("job", [None])[0])
        if not job:
            raise ValueError("job name required: /debug/whatif/<job>")
        try:
            return 200, pick(body, query).whatif(job)
        except KeyError as e:
            return 404, {"error": str(e)}

    def debug_standby(body, query):
        """The hot-standby surface (doc/durability.md "Hot standby"):
        whether this leader was born from a warm standby takeover (the
        takeover_report fields: budget, suffix drained, divergences),
        plus the process's standby-phase shipping stats when it ran
        one. Backs the `voda top` durability line's takeover row."""
        out = {"takeovers": {
            name: dict(s._last_takeover)
            for name, s in sorted(schedulers.items())
            if s._last_takeover is not None}}
        if standby_stats is not None:
            try:
                out["standby"] = standby_stats()
            except Exception as e:  # noqa: BLE001 - surface, never 500
                out["standby_error"] = str(e)
        return 200, out

    def _journal_of(body, query):
        jnl = pick(body, query).journal
        if jnl is None:
            raise ValueError("journal disabled on this pool "
                             "(VODA_JOURNAL=0): nothing to ship")
        return jnl

    def journal_segment(body, query):
        """Shipped-segment fetch (doc/durability.md "Hot standby"): the
        active journal segment's raw framed bytes from ?offset=N — what
        a cross-host standby's HttpTailSource polls. ?stat=1 answers
        just the size, so the poll loop pays one cheap probe per idle
        cycle instead of a full transfer."""
        jnl = _journal_of(body, query)
        if query.get("stat"):
            return 200, {"size_bytes": jnl.size_bytes(),
                         "epoch": jnl.epoch}
        # Suffix served via a storage-level offset read (a seek, not a
        # whole-file read-and-slice): a caught-up standby polling every
        # second must cost the leader the suffix, not the segment.
        offset = max(0, int(query.get("offset", ["0"])[0]))
        return 200, Raw("application/octet-stream",
                        jnl.storage.read(offset))

    def journal_snapshot(body, query):
        """The journal's latest snapshot (raw JSON; empty body when no
        fold has happened yet) — the bootstrap half of the shipped-
        segment fetch path: a fresh cross-host standby loads this, then
        follows the segment suffix."""
        snap = _journal_of(body, query).load_snapshot()
        if snap is None:
            return 200, Raw("application/json", b"")
        return 200, Raw("application/json",
                        json.dumps(snap, default=str).encode())

    def debug_fleet(body, query):
        """One fleet view over every pool (doc/observability.md "Fleet
        decide"): lock-free per-pool load snapshot, per-pool decide/
        actuate + phase percentiles, the last fleet fan-out, and the
        cross-pool router's decision stats. Backs `voda top --fleet`.
        Served even without a coordinator (single-pool deployments get
        the aggregation over their one scheduler)."""
        n = int(query.get("n", ["50"])[0])
        if fleet is not None:
            return 200, fleet.fleet_stats(n)
        from vodascheduler_tpu_torch.scheduler.fleet import FleetCoordinator
        return 200, FleetCoordinator(schedulers).fleet_stats(n)

    return RestServer({
        ("GET", "/training"): get_training,
        ("PUT", "/algorithm"): put_algorithm,
        ("PUT", "/ratelimit"): put_ratelimit,
        ("GET", "/pools"): get_pools,
        ("GET", "/debug/resched"): debug_resched,
        ("GET", "/debug/trace"): debug_trace,
        ("GET", "/debug/trace/*"): debug_trace,
        ("GET", "/debug/profile"): debug_profile,
        ("GET", "/debug/whatif"): debug_whatif,
        ("GET", "/debug/whatif/*"): debug_whatif,
        ("GET", "/debug/journal"): debug_journal,
        ("GET", "/debug/standby"): debug_standby,
        ("GET", "/journal/segment"): journal_segment,
        ("GET", "/journal/snapshot"): journal_snapshot,
        ("GET", "/debug/fleet"): debug_fleet,
        ("GET", "/metrics"): _metrics_route(registry),
    }, host, port)


def make_allocator_server(allocator: ResourceAllocator, registry: Registry,
                          host: str = "0.0.0.0",
                          port: int = config.ALLOCATOR_PORT) -> RestServer:
    """Stateless allocation API (reference: resource_allocator.go:41-44)."""

    def allocate(body, query):
        data = json.loads(body)
        topology = None
        if data.get("topology"):
            from vodascheduler_tpu_torch.placement.topology import PoolTopology
            topology = PoolTopology(
                torus_dims=tuple(data["topology"]["torus_dims"]),
                host_block=tuple(data["topology"]["host_block"]))
        request = AllocationRequest(
            scheduler_id=data.get("scheduler_id", ""),
            num_chips=int(data["num_chips"]),
            algorithm=data.get("algorithm", config.DEFAULT_ALGORITHM),
            ready_jobs=[job_from_dict(j) for j in data.get("ready_jobs", [])],
            topology=topology,
        )
        return 200, allocator.allocate(request)

    return RestServer({
        ("POST", "/allocation"): allocate,
        ("GET", "/metrics"): _metrics_route(registry),
    }, host, port)


class RemoteAllocator:
    """Scheduler-side client for a remote allocator service
    (reference: getResourceAllocation, scheduler.go:377-430)."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def allocate(self, request: AllocationRequest):
        import urllib.request

        payload = json.dumps({
            "scheduler_id": request.scheduler_id,
            "num_chips": request.num_chips,
            "algorithm": request.algorithm,
            "ready_jobs": [job_to_dict(j) for j in request.ready_jobs],
            "topology": (
                {"torus_dims": list(request.topology.torus_dims),
                 "host_block": list(request.topology.host_block)}
                if request.topology is not None else None),
        }).encode()
        headers = {"Content-Type": "application/json"}
        # Propagate the resched trace across the HTTP hop: the allocator
        # server installs these as its handler's ambient context, so the
        # remote allocator.allocate span stitches into the scheduler's
        # trace exactly like the in-process call.
        ctx = obs_tracer.current_context()
        if ctx is not None:
            headers.update(ctx.to_headers())
        req = urllib.request.Request(
            f"{self.base_url}/allocation", data=payload,
            headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return {k: int(v) for k, v in json.load(resp).items()}
