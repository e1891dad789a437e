"""`voda` CLI: submit, delete, and inspect training jobs over REST.

Reference counterpart: cmd/ (urfave/cli app, cmd/main.go:19-49 +
cmd/cmd/cmd.go:17-101): `voda create -f job.yaml`, `voda delete <job>`,
`voda get jobs`. The reference hardcodes the service IP at compile time
(config.go); here `--server` / VODA_SERVER override localhost.

Usage:
  python -m vodascheduler_tpu_torch.cli create -f job.yaml
  python -m vodascheduler_tpu_torch.cli delete <job-name>
  python -m vodascheduler_tpu_torch.cli get jobs
  python -m vodascheduler_tpu_torch.cli get status      # scheduler's table
  python -m vodascheduler_tpu_torch.cli algorithm <name>
  python -m vodascheduler_tpu_torch.cli explain <job>   # decision-audit history
  python -m vodascheduler_tpu_torch.cli top             # live per-phase profile
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request
from typing import Optional

from vodascheduler_tpu_torch import config


def _request(url: str, method: str = "GET", body: Optional[bytes] = None,
             content_type: str = "application/json",
             return_error: bool = False):
    """GET/POST JSON. With return_error=True an HTTP error returns
    (status_code, parsed_body) instead of exiting — the batch-create
    path renders per-item error bodies from a 400/429 response."""
    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            status = resp.status
            data = resp.read().decode()
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        if return_error:
            try:
                return e.code, json.loads(detail)
            except json.JSONDecodeError:
                return e.code, {"error": detail.strip()}
        raise SystemExit(f"error: {e.code} {detail.strip()}")
    except urllib.error.URLError as e:
        raise SystemExit(f"error: cannot reach {url}: {e.reason} "
                         "(is the server running? python -m vodascheduler_tpu_torch.service)")
    try:
        parsed = json.loads(data)
    except json.JSONDecodeError:
        # Non-JSON body on a 2xx (e.g. a proxy answering text/plain):
        # return_error callers still get their (status, dict) shape.
        return (status, {"error": data.strip()}) if return_error else data
    return (status, parsed) if return_error else parsed


def _print_table(rows, columns) -> None:
    if not rows:
        print("(none)")
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    print("  ".join(c.upper().ljust(widths[c]) for c in columns))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in columns))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="voda", description=__doc__)
    parser.add_argument("--server",
                        default=os.environ.get(
                            "VODA_SERVER",
                            f"http://{config.SERVICE_HOST}:{config.SERVICE_PORT}"),
                        help="training-service base URL")
    parser.add_argument("--scheduler-server",
                        default=os.environ.get(
                            "VODA_SCHEDULER_SERVER",
                            f"http://{config.SERVICE_HOST}:{config.SCHEDULER_PORT}"),
                        help="scheduler base URL (get status / algorithm / ratelimit)")
    parser.add_argument("--pool", default=os.environ.get("VODA_POOL"),
                        help="target pool on a multi-pool control plane "
                             "(scheduler commands)")
    sub = parser.add_subparsers(dest="command", required=True)

    p_create = sub.add_parser("create", help="submit a training job")
    p_create.add_argument("-f", "--filename", required=True,
                          help="job spec YAML/JSON")

    p_delete = sub.add_parser("delete", help="delete a training job")
    p_delete.add_argument("name")

    p_get = sub.add_parser("get", help="list jobs / scheduler status")
    p_get.add_argument("what", choices=["jobs", "status"])

    p_algo = sub.add_parser("algorithm", help="switch scheduling algorithm")
    p_algo.add_argument("name")

    p_rate = sub.add_parser("ratelimit", help="set resched rate limit")
    p_rate.add_argument("seconds", type=float)

    p_explain = sub.add_parser(
        "explain",
        help="why did the scheduler resize this job? (decision-audit "
             "history from GET /debug/trace/<job>)")
    p_explain.add_argument("name")
    p_explain.add_argument("-n", type=int, default=20,
                           help="max decisions to show (newest last)")
    p_explain.add_argument("--whatif", action="store_true",
                           help="what-if shadow plan instead of history: "
                                "score the job's feasible chip counts on "
                                "the placement-sensitive step-time model, "
                                "learned vs prior (GET /debug/whatif/"
                                "<job>; doc/learned-models.md)")

    p_fsck = sub.add_parser(
        "fsck",
        help="check a write-ahead journal offline (framing, checksums, "
             "seq/epoch monotonicity; doc/durability.md) — or, with "
             "--live, the running scheduler's GET /debug/journal")
    p_fsck.add_argument("path", nargs="?", default=None,
                        help="journal file, e.g. "
                             "~/.voda/journal/default.wal")
    p_fsck.add_argument("--live", action="store_true",
                        help="query the running scheduler instead of "
                             "reading a file")

    p_top = sub.add_parser(
        "top",
        help="where the scheduler's milliseconds go: per-phase p50/p95 "
             "over recent passes and the slowest passes with their "
             "dominant phase (GET /debug/profile)")
    p_top.add_argument("-n", type=int, default=50,
                       help="recent passes to aggregate")
    p_top.add_argument("-k", type=int, default=5,
                       help="slowest passes to list")
    p_top.add_argument("--fleet", action="store_true",
                       help="one fleet view over every pool (GET "
                            "/debug/fleet): per-pool load + decide "
                            "percentiles and the cross-pool router's "
                            "decision stats")

    args = parser.parse_args(argv)
    from urllib.parse import quote as _q
    pool_q = f"?pool={_q(args.pool, safe='')}" if args.pool else ""

    if args.command == "create":
        with open(args.filename, "rb") as f:
            body = f.read()
        import yaml as _yaml
        docs = [d for d in _yaml.safe_load_all(body) if d is not None]
        # A document may itself be a list of specs; flatten so a list
        # doc followed by further docs loses nothing.
        specs = [s for d in docs for s in (d if isinstance(d, list) else [d])]
        many = len(specs) > 1 or any(isinstance(d, list) for d in docs)
        if many:
            # Multi-doc (or list) spec file -> one atomic bulk admission
            # (POST /training/batch): per-item outcomes, nothing
            # admitted on a 400/429.
            # default=str: YAML parses bare dates/timestamps to native
            # objects json can't encode — stringify and let the server's
            # spec validation judge them (same outcome the raw-YAML
            # single-doc path gets).
            status, out = _request(
                f"{args.server}/training/batch", "POST",
                json.dumps({"specs": specs}, default=str).encode(),
                return_error=True)
            if status == 429:
                raise SystemExit(
                    f"error: 429 {out.get('error', 'admission shed')} "
                    "(backpressure engaged; retry later)")
            results = out.get("results", [])
            for res in results:
                if "error" in res:
                    print(f"error: {res.get('name', '?')}: {res['error']}")
                else:
                    print(f"job created: {res['name']}")
            if status == 200 and not results:
                print("warning: no per-item results in response: "
                      f"{out.get('error', out)}")
            if status != 200:
                if not results:
                    # A failure shape without per-item bodies (e.g. a
                    # 500): still say what happened, never exit mute.
                    raise SystemExit(
                        f"error: {status} {out.get('error', out)}")
                raise SystemExit(1)
        else:
            out = _request(f"{args.server}/training", "POST", body,
                           content_type="application/yaml")
            print(f"job created: {out['name']}")
    elif args.command == "delete":
        from urllib.parse import quote
        out = _request(f"{args.server}/training?name={quote(args.name, safe='')}",
                       "DELETE")
        print(f"job deleted: {out['deleted']}")
    elif args.command == "get" and args.what == "jobs":
        rows = _request(f"{args.server}/training")
        _print_table(rows, ["name", "pool", "status", "priority"])
    elif args.command == "get" and args.what == "status":
        rows = _request(f"{args.scheduler_server}/training{pool_q}")
        _print_table(rows, ["name", "status", "chips", "priority",
                            "running_seconds", "waiting_seconds",
                            "chip_seconds"])
    elif args.command == "algorithm":
        out = _request(f"{args.scheduler_server}/algorithm{pool_q}", "PUT",
                       json.dumps({"algorithm": args.name}).encode())
        print(f"algorithm set: {out['algorithm']}")
    elif args.command == "ratelimit":
        out = _request(f"{args.scheduler_server}/ratelimit{pool_q}", "PUT",
                       json.dumps({"seconds": args.seconds}).encode())
        print(f"rate limit set: {out['seconds']}s")
    elif args.command == "fsck" and args.live:
        stats = _request(f"{args.scheduler_server}/debug/journal{pool_q}")
        _print_journal(stats)
        if stats.get("corrupt"):
            return 1
    elif args.command == "fsck":
        if not args.path:
            raise SystemExit("error: fsck needs a journal path "
                             "(or --live)")
        from vodascheduler_tpu_torch.durability.journal import fsck as _fsck
        report = _fsck(args.path)
        print(json.dumps(report, indent=1, default=str))
        return 1 if report["problems"] else 0
    elif args.command == "explain" and args.whatif:
        from urllib.parse import quote
        out = _request(f"{args.scheduler_server}/debug/whatif/"
                       f"{quote(args.name, safe='')}{pool_q}")
        _print_whatif(out)
    elif args.command == "explain":
        from urllib.parse import quote
        out = _request(f"{args.scheduler_server}/debug/trace/"
                       f"{quote(args.name, safe='')}{pool_q}")
        _print_explain(args.name, out, limit=args.n)
    elif args.command == "top" and args.fleet:
        stats = _request(f"{args.scheduler_server}/debug/fleet?n={args.n}")
        _print_fleet(stats)
    elif args.command == "top":
        q = f"?n={args.n}"
        if args.pool:
            q += f"&pool={_q(args.pool, safe='')}"
        records = _request(f"{args.scheduler_server}/debug/profile{q}")
        # Ingestion-plane stats ride the service port; best-effort so
        # `voda top` against a scheduler-only deployment still renders
        # the profile.
        try:
            ingest = _request(f"{args.server}/debug/ingest")
        except SystemExit:
            ingest = None
        # Durability line (doc/durability.md): best-effort for
        # pre-journal servers; the standby/takeover row likewise for
        # pre-failover ones.
        try:
            journal = _request(
                f"{args.scheduler_server}/debug/journal{pool_q}")
        except SystemExit:
            journal = None
        try:
            standby = _request(f"{args.scheduler_server}/debug/standby")
        except SystemExit:
            standby = None
        _print_top(records, k=args.k, ingest=ingest, journal=journal,
                   standby=standby)
    return 0


def _pctl(values, fraction: float) -> float:
    """Nearest-rank percentile over a small sample — the one shared
    implementation (common/metrics.py), which also fixes the float-ceil
    fuzz this helper used to carry (ceil(0.95 * 20) == 20)."""
    from vodascheduler_tpu_torch.common.metrics import nearest_rank_percentile
    return nearest_rank_percentile(values, fraction)


def _dominant_phase(rec: dict):
    """(name, wall_ms) of the record's costliest phase, or None."""
    phases = rec.get("phases") or {}
    if not phases:
        return None
    name = max(phases, key=lambda p: phases[p].get("wall_ms", 0.0))
    return name, phases[name].get("wall_ms", 0.0)


def _print_ingest(ingest: dict) -> None:
    """Ingestion-plane lines for `voda top` (GET /debug/ingest): how an
    operator sees backpressure engage — shed count climbing, queue depth
    at the watermark, admission tails stretching."""
    recent = ingest.get("recent_admit_ms") or {}
    depth = ingest.get("queue_depth") or {}
    depth_s = " ".join(f"{t}={n}" for t, n in sorted(depth.items())) or "-"
    print("ingestion plane:")
    print(f"  admitted={ingest.get('admitted_total', 0):.0f} "
          f"shed={ingest.get('shed_total', 0):.0f} "
          f"events_dropped={ingest.get('events_dropped_total', 0):.0f} "
          f"queue_depth[{depth_s}]")
    print(f"  admit latency (last {recent.get('count', 0)} requests): "
          f"p50={recent.get('p50', 0.0):.3f}ms "
          f"p99={recent.get('p99', 0.0):.3f}ms")
    burst = ingest.get("last_burst")
    if burst:
        print(f"  last burst: {burst.get('admitted', 0)}/"
              f"{burst.get('size', 0)} admitted in "
              f"{burst.get('total_ms', 0.0):.3f}ms "
              f"({burst.get('per_item_ms', 0.0):.4f}ms/job)")


def _print_journal(stats: dict) -> None:
    """Durability line(s) for `voda top` / `voda fsck --live`
    (GET /debug/journal): how an operator sees the journal grow, the
    snapshot age, a torn tail survived, or — the loud one — mid-file
    corruption."""
    if not stats.get("enabled"):
        print("durability: journal disabled (VODA_JOURNAL=0)")
        return
    age = stats.get("snapshot_age_seconds")
    print(f"durability: journal {stats.get('size_bytes', 0)}B "
          f"seq={stats.get('last_seq', 0)} "
          f"epoch={stats.get('epoch', 0)} "
          f"records={stats.get('records', 0)} "
          f"torn_tail={stats.get('torn_tail_count', 0)} "
          f"snapshot_age={'-' if age is None else f'{age:.0f}s'}"
          + (" FENCED" if stats.get("fenced") else ""))
    if stats.get("corrupt"):
        print(f"  CORRUPT: {stats['corrupt']}")
    last = stats.get("last_recovery")
    if last:
        print(f"  last recovery: {last.get('records', 0)} record(s) "
              f"replayed, {len(last.get('divergences', []))} "
              f"divergence(s), {last.get('duration_ms', 0.0):.1f}ms "
              f"(epoch {last.get('epoch')})")


def _print_standby(stats: dict) -> None:
    """Hot-standby rows for `voda top` (GET /debug/standby,
    doc/durability.md "Hot standby"): whether this leader was born
    from a warm takeover and what the takeover cost end to end."""
    takeovers = stats.get("takeovers") or {}
    for pool, t in sorted(takeovers.items()):
        print(f"  takeover[{pool}]: {t.get('duration_ms', 0.0):.1f}ms "
              f"lease-loss->first-commit (recovery "
              f"{t.get('recovery_ms', 0.0):.1f}ms, suffix "
              f"{t.get('suffix_records', 0)} record(s), "
              f"{t.get('divergences', 0)} divergence(s), epoch "
              f"{t.get('epoch')})")
    for row in stats.get("standby") or ():
        print(f"  standby[{row.get('pool')}]: applied seq "
              f"{row.get('applied_seq', 0)} over "
              f"{row.get('polls', 0)} poll(s), lag "
              f"{row.get('records_behind', 0)} record(s), "
              f"{row.get('resyncs', 0)} resync(s)")


def _print_top(records: list, k: int = 5, ingest: Optional[dict] = None,
               journal: Optional[dict] = None,
               standby: Optional[dict] = None) -> None:
    """Human rendering of /debug/profile: per-phase p50/p95 over the
    window, then the slowest passes with their dominant phase and the
    jobs whose deltas triggered them."""
    if ingest:
        _print_ingest(ingest)
    if journal:
        _print_journal(journal)
    if standby and (standby.get("takeovers") or standby.get("standby")):
        _print_standby(standby)
    if not records:
        print("no profiled passes yet (ring empty; run or trigger a "
              "resched first)")
        return
    placement = next((r["placement"] for r in reversed(records)
                      if r.get("placement")), None)
    if placement:
        # Fleet placement columns (doc/placement.md): how spread out
        # the pool is and what the comms-weighted objective scores it.
        print(f"placement: jobs_cross_host="
              f"{placement.get('jobs_cross_host', 0)} "
              f"contiguity_cost={placement.get('contiguity_cost', 0)} "
              f"comms_score={placement.get('comms_score', 0)}")
        frac = placement.get("fractional")
        if frac:
            # Fractional-sharing totals (doc/fractional-sharing.md):
            # how much of the pool is co-tenant and what the tenants
            # currently pay in interference price.
            print(f"fractional: jobs={frac.get('fractional_jobs', 0)} "
                  f"cotenant_hosts={frac.get('cotenant_hosts', 0)} "
                  f"interference_price="
                  f"{frac.get('interference_price', 0)}")
    print(f"scheduler profile over last {len(records)} pass(es):")
    per_phase = {}
    for rec in records:
        for name, stats in (rec.get("phases") or {}).items():
            per_phase.setdefault(name, []).append(stats.get("wall_ms", 0.0))
    header = f"  {'PHASE':<18}{'P50_MS':>10}{'P95_MS':>10}{'PASSES':>8}"
    print(header)
    rows = [("decide", [r.get("decide_ms", 0.0) for r in records]),
            ("actuate", [r.get("actuate_ms", 0.0) for r in records])]
    rows += sorted(per_phase.items(), key=lambda kv: -_pctl(kv[1], 0.5))
    for name, vals in rows:
        print(f"  {name:<18}{_pctl(vals, 0.5):>10.3f}"
              f"{_pctl(vals, 0.95):>10.3f}{len(vals):>8}")
    slowest = sorted(records, key=lambda r: -r.get("duration_ms", 0.0))[:k]
    print(f"slowest {len(slowest)} pass(es):")
    for rec in slowest:
        dom = _dominant_phase(rec)
        dom_s = f"{dom[0]} {dom[1]:.3f}ms" if dom else "n/a"
        jobs = rec.get("jobs", [])
        jobs_s = ",".join(jobs[:4]) + (f" (+{len(jobs) - 4})"
                                       if len(jobs) > 4 else "")
        print(f"  resched#{rec.get('seq')} {rec.get('duration_ms', 0):.3f}ms "
              f"(decide {rec.get('decide_ms', 0):.3f} / actuate "
              f"{rec.get('actuate_ms', 0):.3f}) dominant: {dom_s} "
              f"triggers={'+'.join(rec.get('triggers', ()))} "
              f"jobs=[{jobs_s}]")


def _print_fleet(stats: dict) -> None:
    """Human rendering of GET /debug/fleet: one row per pool (load +
    decide tails), the fleet totals, the last fan-out, and the router's
    decision mix (doc/observability.md "Fleet decide")."""
    totals = stats.get("totals") or {}
    print(f"fleet: {totals.get('pools', 0)} pool(s), "
          f"{totals.get('booked_chips', 0)}/{totals.get('total_chips', 0)} "
          f"chips booked, {totals.get('ready_jobs', 0)} ready jobs "
          f"(generation {stats.get('generation', 0)})")
    pools = stats.get("pools") or {}
    profile = stats.get("profile") or {}
    header = (f"  {'POOL':<14}{'CHIPS':>12}{'READY':>8}{'WAIT':>7}"
              f"{'DECIDE_P50':>12}{'DECIDE_P95':>12}{'ACTUATE_P95':>13}")
    print(header)
    for name in sorted(pools):
        p = pools[name]
        prof = profile.get(name) or {}
        chips = f"{p.get('booked_chips', 0)}/{p.get('total_chips', 0)}"
        print(f"  {name:<14}{chips:>12}{p.get('ready_jobs', 0):>8}"
              f"{p.get('waiting_jobs', 0):>7}"
              f"{prof.get('decide_ms_p50', 0.0):>12.3f}"
              f"{prof.get('decide_ms_p95', 0.0):>12.3f}"
              f"{prof.get('actuate_ms_p95', 0.0):>13.3f}")
    last = stats.get("last_pass")
    if last:
        print(f"  last fleet pass: {len(last.get('pools', ()))} pool(s) in "
              f"{last.get('wall_ms', 0.0):.3f}ms "
              f"(generation {last.get('generation')})")
    router = stats.get("router")
    if router:
        mix = " ".join(f"{k}={v}" for k, v in
                       sorted((router.get("by_reason") or {}).items()))
        ms = router.get("route_ms") or {}
        print(f"router: enabled={router.get('enabled')} "
              f"decisions={router.get('decisions_total', 0)} [{mix or '-'}]")
        print(f"  route latency (last {ms.get('count', 0)}): "
              f"p50={ms.get('p50', 0.0):.4f}ms p99={ms.get('p99', 0.0):.4f}ms")


def _print_whatif(rec: dict) -> None:
    """Human rendering of one whatif_report (doc/learned-models.md):
    the shadow allocator's would-be grant, the learned-vs-prior model
    fractions, and the candidate table."""
    print(f"what-if plan for {rec.get('job')} "
          f"(pool {rec.get('pool')}, {rec.get('algorithm')}, "
          f"model={rec.get('model')}):")
    print(f"  current: {rec.get('current_chips')} chips "
          f"(spread {rec.get('current_spread', 0.0)}); shadow allocator "
          f"would grant {rec.get('would_grant')}")
    print(f"  comms fraction: learned "
          f"{rec.get('comms_fraction_learned')} vs prior "
          f"{rec.get('comms_fraction_prior')}; drift ratio "
          f"{rec.get('drift_ratio')}")
    if rec.get("shadow_error"):
        print(f"  (shadow decide failed: {rec['shadow_error']})")
    header = (f"  {'CHIPS':>6}{'SPREAD':>8}{'STEP_X':>8}"
              f"{'REMAIN_S':>12}{'PRIOR_S':>12}")
    print(header)
    for c in rec.get("candidates", ()):
        marker = " <- current" if c.get("chips") == rec.get(
            "current_chips") else (
            " <- would grant" if c.get("chips") == rec.get("would_grant")
            else "")
        print(f"  {c.get('chips'):>6}{c.get('spread'):>8}"
              f"{c.get('modeled_step_ratio'):>8}"
              f"{c.get('modeled_remaining_s'):>12}"
              f"{c.get('prior_remaining_s'):>12}{marker}")
    total = rec.get("candidates_total", 0)
    shown = len(rec.get("candidates", ()))
    if total > shown:
        print(f"  ({shown} of {total} feasible counts shown)")
    print(f"  planned in {rec.get('duration_ms', 0.0):.1f}ms off the "
          f"decide path")


def _print_explain(job: str, payload: dict, limit: int = 20) -> None:
    """Human rendering of the decision-audit history: one line per resched
    that touched the job, with its trigger(s) and reason codes."""
    records = payload.get("records", [])[-limit:]
    if not records:
        print(f"no recorded decisions for {job!r} (ring empty or job "
              "unknown; the JSONL sink under VODA_TRACE_DIR keeps the "
              "long tail)")
        return
    print(f"decision history for {job} (oldest first):")
    for rec in records:
        delta = next((d for d in rec.get("deltas", ())
                      if d.get("job") == job), None)
        if delta is None:
            continue
        reasons = ",".join(delta.get("reasons", ()))
        extra = ""
        if "resize_seconds" in delta:
            # For a `migrated` delta this is the PRICED resharding cost
            # of the move (doc/placement.md "Priced migrations").
            extra = f" in {delta['resize_seconds']}s"
        comms = delta.get("comms")
        if comms:
            extra += (f" comms[w={comms.get('weight')} "
                      f"contig={comms.get('contiguity')} "
                      f"score={comms.get('score')}]")
        frac = delta.get("fractional")
        if frac:
            # Fractional grant columns (doc/fractional-sharing.md):
            # the sub-host partition, who shares its host block, and
            # the priced interference.
            tenants = ",".join(frac.get("co_tenants", ())) or "-"
            extra += (f" fractional[{frac.get('partition')}chips"
                      f"@{'+'.join(frac.get('hosts', ()))} "
                      f"co_tenants={tenants} "
                      f"price={frac.get('interference_price')}]")
        print(f"  [{rec.get('ts', 0):.1f}] resched#{rec.get('seq')} "
              f"({'+'.join(rec.get('triggers', ()))}, "
              f"{rec.get('algorithm')}): "
              f"{delta.get('before')} -> {delta.get('after')} chips "
              f"[{reasons}]{extra}")
    perf = payload.get("perf")
    if perf:
        # Where the time went the last time a pass acted on this job,
        # with the job's even share of the pass cost (K jobs shared the
        # pass; per-phase attribution would need per-job stage timing
        # the hot path deliberately doesn't pay for).
        touched = max(1, len(perf.get("jobs", ())) or 1)
        share = perf.get("duration_ms", 0.0) / touched
        print(f"last pass phase costs (resched#{perf.get('seq')}, "
              f"{touched} job(s) touched, ~{share:.3f}ms/job share): "
              f"decide {perf.get('decide_ms', 0):.3f}ms / "
              f"actuate {perf.get('actuate_ms', 0):.3f}ms")
        phases = perf.get("phases") or {}
        for name in sorted(phases, key=lambda p: -phases[p]["wall_ms"]):
            stats = phases[name]
            print(f"  {name:<18}{stats['wall_ms']:>10.3f}ms wall"
                  f"{stats['cpu_ms']:>10.3f}ms cpu  x{stats['count']}")
    spans = payload.get("spans", [])
    if spans:
        print(f"recent spans ({len(spans)}):")
        for s in spans[-limit:]:
            attrs = s.get("attrs", {})
            path = f" path={attrs['path']}" if "path" in attrs else ""
            print(f"  [{s.get('start', 0):.1f}] {s.get('name')} "
                  f"{s.get('duration_ms')}ms "
                  f"status={s.get('status')}{path} "
                  f"trace={s.get('trace_id')}")


if __name__ == "__main__":
    sys.exit(main())
