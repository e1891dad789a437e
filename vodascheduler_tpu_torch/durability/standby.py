"""Hot-standby failover: a warm standby process that tails the leader's
journals, applies them continuously, and takes over in a bounded budget
(doc/durability.md "Hot standby").

Composition per pool: a shipping tailer (shipping.py) feeds a
`StandbyApplier` (recover.py) — so at every instant the standby holds
the fully-materialized statuses/bookings/placement/resize-clock/
learned-model state of the journal's committed prefix, and takeover
work is only what CANNOT be done ahead of time:

1. observe the lease expired and `try_acquire()` it (the fencing epoch
   bump that deposes the old leader at its next append);
2. one final tailer poll — finish the suffix the poll cadence hadn't
   fed yet;
3. open the journal at the new epoch with the tailer's `resume_hint`
   (no re-parse: the standby already parsed every byte; the dead
   leader's torn tail is trimmed from the hint's clean length);
4. hand the materialized state to the Scheduler constructor
   (`recovered_state=`), whose recovery reconciles vs the live backend
   and commits the first decide before returning.

`PoolStandby` owns one pool's tailer+applier and steps 2-3;
`HotStandby` watches the lease over N pools and is what VodaApp runs
when it starts against a live leader with VODA_STANDBY=1. The measured
end-to-end budget (lease-loss -> first committed pass) is the
perf_scale schema-9 `failover` section's takeover column, pinned
< 1 s p95 at 10k jobs.
"""

from __future__ import annotations

import time as _walltime
from typing import Callable, Dict, List, Optional

from vodascheduler_tpu_torch.common.clock import Clock
from vodascheduler_tpu_torch.durability.recover import StandbyApplier
from vodascheduler_tpu_torch.durability.shipping import JournalTailer
from vodascheduler_tpu_torch.obs import audit as obs_audit


class PoolStandby:
    """One pool's warm standby: tailer + applier + takeover protocol."""

    def __init__(self, pool: str, source,
                 registry=None) -> None:
        self.pool = pool
        self.applier = StandbyApplier()
        self.tailer = JournalTailer(source, self.applier.apply,
                                    bootstrap=self.applier.bootstrap)
        self._lag_gauge = None
        if registry is not None:
            self._lag_gauge = registry.gauge(
                "voda_standby_apply_lag_records",
                "Records the standby was behind at its last shipping "
                "poll (0 = continuously caught up); the takeover "
                "suffix drain is one more poll of this",
                const_labels={"pool": pool})

    def poll(self) -> int:
        """One shipping cycle: feed every complete new frame into the
        applier; sample the apply lag."""
        fed = self.tailer.poll()
        if self._lag_gauge is not None:
            self._lag_gauge.set(float(fed))
        return fed

    @property
    def last_seq(self) -> int:
        return self.applier.last_seq

    def stats(self) -> Dict[str, object]:
        return {
            "pool": self.pool,
            "applied_seq": self.applier.last_seq,
            "records_fed": self.tailer.records_fed,
            "records_behind": self.tailer.records_behind,
            "polls": self.tailer.polls,
            "resyncs": self.tailer.resyncs,
            "jobs": len(self.applier.state.statuses),
        }

    def prepare_takeover(self) -> Dict[str, object]:
        """Steps 2-3 of the takeover: finish the suffix, compute the
        warm-open hint. Returns what the caller needs to construct the
        new leader's Journal + Scheduler: `state` (the materialized
        JournalState — consumed by recovery), `resume_hint`, and
        `suffix_records` (how many records the final drain fed — the
        lag the poll cadence had accumulated)."""
        suffix = self.poll()
        clean_bytes, _ = self.tailer.clean_offset()
        return {
            "state": self.applier.state,
            "resume_hint": {"last_seq": self.applier.last_seq,
                            "clean_bytes": clean_bytes},
            "suffix_records": suffix,
        }


def finish_takeover(sched, pool_standby: PoolStandby,
                    t_lease_loss: float, epoch: int,
                    suffix_records: int,
                    registry=None) -> Dict[str, object]:
    """Stamp a completed takeover on the new leader: the end-to-end
    budget (lease-loss -> the Scheduler constructor returned, i.e. the
    first decide committed), the audited `takeover_report` record, the
    `voda_scheduler_takeover_seconds` gauge, and the /debug/standby
    surface (`sched._last_takeover`)."""
    duration = _walltime.monotonic() - t_lease_loss
    rec = {
        "kind": "takeover_report",
        "schema": obs_audit.SCHEMA_VERSION,
        "ts": sched.clock.now(),
        "pool": sched.pool_id,
        "epoch": int(epoch),
        "suffix_records": int(suffix_records),
        "applied_seq": pool_standby.applier.last_seq,
        "records_fed": pool_standby.tailer.records_fed,
        "resyncs": pool_standby.tailer.resyncs,
        "duration_ms": round(duration * 1000.0, 3),
        "recovery_ms": (sched._last_recovery_report or {}).get(
            "duration_ms", 0.0),
        "divergences": len((sched._last_recovery_report or {}).get(
            "divergences", ())),
    }
    sched.tracer.emit(dict(rec))
    # vodarace: ignore[unguarded-shared-write] written once at takeover,
    # before the promoted pool serves traffic; REST readers see either
    # None or the complete report (atomic reference swap)
    sched._last_takeover = {k: v for k, v in rec.items() if k != "kind"}
    if registry is not None:
        registry.gauge(
            "voda_scheduler_takeover_seconds",
            "Wall time of the last hot-standby takeover, lease-loss to "
            "first committed decide (doc/durability.md 'Hot standby')",
            const_labels={"pool": sched.pool_id}).set(duration)
    return rec


class HotStandby:
    """The process-level standby loop VodaApp runs under VODA_STANDBY=1
    while another leader holds the lease: poll every pool's shipping
    tailer on the standby cadence, watch the lease, and return the
    pools' prepared takeovers the moment the lease is won.

    `sources`: pool -> shipping source (FileTailSource for the shared-
    workdir deployment; HttpTailSource for a cross-host standby).
    `acquire`: zero-arg callable that attempts the lease and returns
    the new fencing epoch, raising LeaseHeld while the leader lives
    (FileLease.try_acquire).
    """

    def __init__(self, sources: Dict[str, object], acquire: Callable[[], int],
                 clock: Optional[Clock] = None,
                 poll_seconds: Optional[float] = None,
                 registry=None) -> None:
        from vodascheduler_tpu_torch import config as _config
        self.pools: Dict[str, PoolStandby] = {
            pool: PoolStandby(pool, source, registry=registry)
            for pool, source in sources.items()}
        self.acquire = acquire
        self.clock = clock or Clock()
        self.poll_seconds = (_config.STANDBY_POLL_SECONDS
                             if poll_seconds is None else float(poll_seconds))

    def poll_once(self) -> int:
        """One shipping cycle over every pool."""
        return sum(p.poll() for p in self.pools.values())

    def run_until_leader(self,
                        stop: Optional[Callable[[], bool]] = None) -> int:
        """Tail-and-watch until the lease is won; returns the new
        fencing epoch. `stop` aborts the loop (returns 0) — the
        process is shutting down while still a standby."""
        from vodascheduler_tpu_torch.durability.leader import LeaseHeld

        while True:
            if stop is not None and stop():
                return 0
            self.poll_once()
            try:
                return int(self.acquire())
            except LeaseHeld:
                self.clock.sleep(self.poll_seconds)

    def prepare_takeovers(self) -> Dict[str, Dict[str, object]]:
        """Finish every pool's suffix and hand back the per-pool warm
        takeover bundles (PoolStandby.prepare_takeover)."""
        return {pool: p.prepare_takeover()
                for pool, p in self.pools.items()}

    def stats(self) -> List[Dict[str, object]]:
        return [self.pools[pool].stats() for pool in sorted(self.pools)]
