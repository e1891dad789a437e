"""In-process event bus: bounded per-pool job-lifecycle queues with a
batched, backpressure-aware drain.

Reference counterpart: pkg/common/rabbitmq/rabbitmq.go — one RabbitMQ queue
per GPU type carrying `{verb, job_name}` messages from the admission service
to that type's scheduler. In a single control-plane process a broker is pure
overhead; a thread-safe topic→queue map preserves the decoupling (admission
never calls the scheduler directly, and publish can be rolled back by a
compensating delete, handlers.go:119-134) without the network hop.

Ingestion-plane semantics (doc/observability.md "Ingestion plane"):

- **Every event is queued, then drained.** Publication enqueues under the
  bus lock and returns; delivery happens OUTSIDE the lock, by whichever
  thread won the per-topic drain (one drainer at a time preserves FIFO).
  A publisher is therefore never blocked behind a slow subscriber, and a
  subscriber exception can never leave the bus lock held against
  concurrent publishers.
- **Bounded queues.** Each topic queue holds at most `queue_max` events
  (`VODA_EVENT_QUEUE_MAX`); beyond that new events are DROPPED and
  counted (`voda_events_dropped_total`). Admission sheds with 429 at the
  `saturated()` watermark well before the bound, so drops only hit
  direct publishers during a pathological storm — never silently.
- **Batch subscribers.** A subscriber registered with `batch=True`
  receives the whole drained burst as ONE `callback(list_of_events)`
  call — the scheduler turns N admission events into one lock
  acquisition and one coalesced resched trigger instead of N serialized
  callbacks.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Callable, Dict, List, Optional, Set

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.common.types import EventVerb


class EventQueueFull(Exception):
    """An all-or-nothing publish found fewer free slots than events.
    NOTHING was enqueued — the caller still owns the hand-off (admission
    rolls its batch back and sheds with 429)."""

    def __init__(self, topic: str, events: int, free: int):
        super().__init__(
            f"topic {topic!r} queue cannot take {events} event(s) "
            f"({free} free slot(s) under the bound)")
        self.topic = topic
        self.events = events
        self.free = free


@dataclasses.dataclass(frozen=True)
class JobEvent:
    """Reference: rabbitmq.Msg{Verb, JobName} (rabbitmq.go:15-26)."""

    verb: EventVerb
    job_name: str


class EventBus:
    """Named bounded queues (one per TPU pool), publish/subscribe.

    Two consumption modes, matching how the reference consumes RabbitMQ:
    a subscriber callback (the scheduler's readMsgs analog; per-event, or
    per-burst with `batch=True`) or explicit polling via get(). Events
    published before a topic has a subscriber queue up and are drained on
    subscribe.
    """

    def __init__(self, registry=None,
                 queue_max: Optional[int] = None,
                 shed_watermark: Optional[int] = None) -> None:
        self._queues: Dict[str, "queue.Queue[JobEvent]"] = {}
        self._subscribers: Dict[str, Callable] = {}
        self._batch_mode: Dict[str, bool] = {}
        # Topics with a drain in flight: the drainer loops until its
        # topic's queue is empty, so publishers that lose the race just
        # enqueue and return — single-drainer-per-topic keeps FIFO.
        self._draining: Set[str] = set()
        self._dropped: Dict[str, int] = {}
        self._queue_max = (config.EVENT_QUEUE_MAX
                           if queue_max is None else int(queue_max))
        self._shed_watermark = min(
            self._queue_max,
            config.EVENT_SHED_WATERMARK
            if shed_watermark is None else int(shed_watermark))
        # RLock: a subscriber may itself publish from a drain; the lock
        # only ever guards map/queue bookkeeping — delivery always runs
        # with it released.
        self._lock = threading.RLock()
        # Daemon drainer threads handed the remainder of a capped drain:
        # named (voda-event-drain-<topic>), enumerable, and joined by
        # close() — at fleet scale (pools >> 8) leaked drainers are the
        # teardown race the 16-pool hygiene test pins.
        self._drainer_threads: Set[threading.Thread] = set()
        self._closed = False
        self._registry = registry
        self._m_dropped = None
        if registry is not None:
            self._m_dropped = registry.counter(
                "voda_events_dropped_total",
                "Events dropped at a full bounded topic queue "
                "(VODA_EVENT_QUEUE_MAX)", labels=("topic",))

    def _queue(self, topic: str) -> "queue.Queue[JobEvent]":
        with self._lock:
            return self._queue_locked(topic)

    def _queue_locked(self, topic: str) -> "queue.Queue[JobEvent]":
        q = self._queues.get(topic)
        if q is None:
            q = self._queues[topic] = queue.Queue(maxsize=self._queue_max)
            self._dropped.setdefault(topic, 0)
            if self._registry is not None:
                # One gauge per topic via const-labels (the pool idiom):
                # depth is read live at scrape time.
                self._registry.gauge(
                    "voda_event_queue_depth",
                    "Event-bus queue depth (events waiting for the "
                    "topic's drain)", fn=q.qsize,
                    const_labels={"topic": topic})
        return q

    def subscribe(self, topic: str, callback: Callable,
                  batch: bool = False) -> None:
        """Register the topic's consumer and drain any events queued
        before it existed (e.g. jobs admitted while the pool's scheduler
        was down). With `batch=True` the callback receives the whole
        drained burst as one `List[JobEvent]` argument. The backlog is
        delivered OUTSIDE the bus lock — a raising subscriber cannot
        wedge concurrent publishers."""
        with self._lock:
            self._subscribers[topic] = callback
            self._batch_mode[topic] = bool(batch)
            self._queue_locked(topic)
        self._drain(topic)

    def publish(self, topic: str, event: JobEvent) -> None:
        """Hand off one event (a batch of one — see publish_many)."""
        self.publish_many(topic, (event,))

    def publish_many(self, topic: str, events,
                     all_or_nothing: bool = False) -> None:
        """Hand off a burst of events under ONE lock acquisition.
        Publication succeeds once the events are queued; subscriber
        exceptions are contained in the drain (the consumer's failure is
        not the producer's rollback trigger — admission's rollback fires
        only when hand-off itself fails).

        Hand-off failure at the queue bound has two shapes:
        `all_or_nothing=True` (the admission path) enqueues NOTHING
        unless the whole burst fits and raises `EventQueueFull` — the
        caller still owns every event and can roll back / shed with 429;
        the default best-effort mode keeps the fitting prefix and drops
        the rest, counted (`voda_events_dropped_total`) and logged,
        never silently."""
        events = list(events)
        dropped = 0
        with self._lock:
            if self._closed:
                # A closed bus takes no new hand-offs: the all-or-nothing
                # path still owns its events (rollback works), the
                # best-effort path logs instead of silently queueing into
                # a bus nobody will ever drain again.
                if all_or_nothing:
                    raise EventQueueFull(topic, len(events), 0)
                logging.getLogger(__name__).warning(
                    "event bus closed: dropping %d event(s) for %r",
                    len(events), topic)
                return
            q = self._queue_locked(topic)
            if all_or_nothing:
                free = self._queue_max - q.qsize()
                if free < len(events):
                    raise EventQueueFull(topic, len(events), free)
            for event in events:
                try:
                    q.put_nowait(event)
                except queue.Full:
                    dropped += 1
            if dropped:
                self._dropped[topic] += dropped
        if dropped:
            logging.getLogger(__name__).error(
                "event queue %r full (max %d): dropped %d event(s)",
                topic, self._queue_max, dropped)
            if self._m_dropped is not None:
                self._m_dropped.inc(dropped, topic=topic)
        self._drain(topic)

    def publish_many_multi(
            self, by_topic: Dict[str, List[JobEvent]]) -> None:
        """All-or-nothing hand-off across SEVERAL topics in ONE lock
        acquisition: every topic must take its whole burst or NOTHING is
        enqueued anywhere and `EventQueueFull` names the first topic
        that could not fit. A cross-pool admission batch needs this —
        with sequential per-topic publishes, a later pool's overflow
        would roll back store jobs whose CREATEs an earlier pool's
        scheduler had already consumed (ghost jobs there, double admits
        on the client's retry). Drains run only after every queue is
        loaded, so no subscriber can observe a partially-queued batch."""
        items = [(topic, list(events))
                 for topic, events in sorted(by_topic.items()) if events]
        if not items:
            return
        with self._lock:
            if self._closed:
                raise EventQueueFull(items[0][0], len(items[0][1]), 0)
            for topic, events in items:
                q = self._queue_locked(topic)
                free = self._queue_max - q.qsize()
                if free < len(events):
                    raise EventQueueFull(topic, len(events), free)
            for topic, events in items:
                q = self._queues[topic]
                for event in events:
                    q.put_nowait(event)
        for topic, _ in items:
            self._drain(topic)

    # How many delivery rounds one drain winner performs before handing
    # the remainder to a daemon drainer thread. Under a sustained storm
    # the winner is somebody's HTTP request thread — it must not spend
    # the whole storm delivering every OTHER publisher's events (its
    # client would time out and retry an admission that in fact landed).
    _DRAIN_LOOPS_MAX = 8

    def _drain(self, topic: str) -> None:
        """Deliver the topic's queued events to its subscriber, outside
        the bus lock. One drainer at a time per topic: losers enqueue and
        return; the winner loops until the queue is empty (re-checking
        after each delivery, so events published mid-delivery are never
        stranded behind the draining flag). The winner's captivity is
        bounded: after `_DRAIN_LOOPS_MAX` rounds a daemon drainer thread
        takes over the remainder."""
        for _ in range(self._DRAIN_LOOPS_MAX):
            with self._lock:
                if topic in self._draining:
                    return
                sub = self._subscribers.get(topic)
                if sub is None:
                    return
                q = self._queues.get(topic)
                batch: List[JobEvent] = []
                if q is not None:
                    while True:
                        try:
                            batch.append(q.get_nowait())
                        except queue.Empty:
                            break
                if not batch:
                    return
                self._draining.add(topic)
                batch_mode = self._batch_mode.get(topic, False)
            try:
                if batch_mode:
                    self._deliver_batch(sub, batch)
                else:
                    for event in batch:
                        self._deliver(sub, event)
            finally:
                with self._lock:
                    self._draining.discard(topic)
            # Loop: a publisher that saw _draining set relied on us to
            # pick up what it enqueued during our delivery.
        # Loop cap hit with the queue still refilling: hand the
        # remainder to a daemon drainer so this thread's latency stays
        # bounded. The new thread races for the drain like any
        # publisher — if someone else already won, it no-ops; either
        # way nothing strands.
        if self.pending(topic):
            thread = threading.Thread(target=self._drain_and_untrack,
                                      args=(topic,),
                                      name=f"voda-event-drain-{topic}",
                                      daemon=True)
            with self._lock:
                if self._closed:
                    return
                self._drainer_threads.add(thread)
            thread.start()

    def _drain_and_untrack(self, topic: str) -> None:
        try:
            self._drain(topic)
        finally:
            with self._lock:
                self._drainer_threads.discard(threading.current_thread())

    def drainer_threads(self) -> List[threading.Thread]:
        """Live daemon drainer threads (enumerable by name for teardown
        hygiene checks; the transient winners draining inline on
        publisher threads are not listed — they are the publisher)."""
        with self._lock:
            return [t for t in self._drainer_threads if t.is_alive()]

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting events and join every daemon drainer thread.
        Idempotent. In-flight deliveries finish (subscriber callbacks
        are never interrupted mid-event); events still queued after the
        join are intentionally left undelivered — the control plane is
        tearing down, and a late CREATE firing into a closed scheduler
        would be the worse bug."""
        with self._lock:
            self._closed = True
            threads = list(self._drainer_threads)
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=timeout)
        with self._lock:
            leaked = [t.name for t in self._drainer_threads if t.is_alive()]
        if leaked:
            logging.getLogger(__name__).warning(
                "event-bus close: drainer thread(s) still alive after "
                "%.1fs: %s", timeout, leaked)

    @staticmethod
    def _deliver(sub: Callable[[JobEvent], None], event: JobEvent) -> None:
        try:
            sub(event)
        except Exception:
            logging.getLogger(__name__).exception(
                "event subscriber failed handling %s", event)

    @staticmethod
    def _deliver_batch(sub: Callable[[List[JobEvent]], None],
                       batch: List[JobEvent]) -> None:
        try:
            sub(batch)
        except Exception:
            logging.getLogger(__name__).exception(
                "batch event subscriber failed handling %d event(s)",
                len(batch))

    def get(self, topic: str, timeout: Optional[float] = None) -> Optional[JobEvent]:
        """Pop the next event, or None on timeout / immediately when
        timeout=0 and the queue is empty."""
        try:
            if timeout == 0:
                return self._queue(topic).get_nowait()
            return self._queue(topic).get(timeout=timeout)
        except queue.Empty:
            return None

    def pending(self, topic: str) -> int:
        """Queue depth — read-only: an unknown topic reports 0 without
        minting a queue (admission probes with not-yet-validated pool
        names; creating state per probe would leak a queue and a
        per-topic depth gauge for every typo'd pool)."""
        with self._lock:
            q = self._queues.get(topic)
        return 0 if q is None else q.qsize()

    def saturated(self, topic: str) -> bool:
        """Whether the topic is past its shed watermark — the admission
        service's backpressure signal (429 + Retry-After)."""
        return self.pending(topic) >= self._shed_watermark

    def free_slots(self, topic: str) -> int:
        """Slots under the queue bound — read-only like pending(); an
        unknown topic has the full bound free."""
        return self._queue_max - self.pending(topic)

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._queues)

    def dropped(self, topic: Optional[str] = None) -> int:
        """Events dropped at the queue bound — per topic, or total."""
        with self._lock:
            if topic is not None:
                return self._dropped.get(topic, 0)
            return sum(self._dropped.values())
