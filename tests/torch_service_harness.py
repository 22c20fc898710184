"""Deterministic virtual-clock harness for the port's SolverService tests.

The counterpart of ``tests/service_harness.py`` for
``repro_torch.runtime.service``; it imports nothing of the JAX package.

Every timestamp, deadline comparison, and chunk-size decision inside the
service flows through its injected ``clock``; this module supplies a
:class:`VirtualClock` whose time only moves when a test says so, and a
:class:`ServiceHarness` that advances it by a fixed tick per service
step.  Scheduling behavior then depends only on submit order, tick size,
and solver arithmetic — no ``time.sleep``, no wall-clock flake: a
latency of ``3.0`` means "retired on the third step", always.

:func:`assert_consistent` is the shared invariant checker the property
and failure-injection tests run after every scenario: each ticket takes
exactly one terminal transition, the stats partition adds up, batch
state matches ticket state, and incompatible requests never share a
batch.
"""
from collections import Counter

from repro_torch.runtime.service import TERMINAL_STATES, SolverService


class VirtualClock:
    """Monotonic clock that advances only when told to."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"a monotonic clock cannot rewind (dt={dt})")
        self._now += float(dt)
        return self._now


class ServiceHarness:
    """A SolverService driven on a virtual clock, one tick per step.

    With ``tick=1.0`` (the default) virtual time counts service steps:
    a request submitted at step a and retired at step b has latency
    ``b - a`` exactly.  Deadlines passed to ``submit(deadline=...)`` are
    therefore "number of steps from now" — deterministic deadline tests
    pick the step at which expiry must happen.
    """

    def __init__(self, registry, *, tick: float = 1.0, start: float = 0.0,
                 **service_kwargs):
        self.clock = VirtualClock(start)
        self.tick = float(tick)
        self.service = SolverService(registry, clock=self.clock,
                                     **service_kwargs)

    def submit(self, *args, **kwargs):
        return self.service.submit(*args, **kwargs)

    def cancel(self, ticket) -> bool:
        return self.service.cancel(ticket)

    def step(self) -> int:
        """One service step, then one clock tick."""
        chunks = self.service.step()
        self.clock.advance(self.tick)
        return chunks

    def drain(self, max_steps: int = 10_000):
        """Step (advancing the clock) until nothing is pending."""
        steps = 0
        while self.service.pending:
            if steps >= max_steps:
                raise AssertionError(
                    f"harness did not drain in {max_steps} steps "
                    f"({self.service.pending} pending): "
                    f"{self.service.describe()}")
            self.step()
            steps += 1
        return self.service.completed

    def run_until(self, predicate, max_steps: int = 10_000) -> int:
        """Step until ``predicate()`` holds; returns steps taken."""
        steps = 0
        while not predicate():
            if steps >= max_steps:
                raise AssertionError(
                    f"predicate still false after {max_steps} steps: "
                    f"{self.service.describe()}")
            self.step()
            steps += 1
        return steps


def assert_consistent(service: SolverService, tickets=()):
    """Service-wide invariants that must hold at ANY step boundary.

    * every known ticket is in a legal state, and resolved tickets took
      exactly one terminal transition (the ``_terminal_transitions``
      counter is the service's own tamper-evidence);
    * ``submitted == done + cancelled + expired + rejected + pending``
      — the stats partition, no request lost or double-counted;
    * batch bookkeeping is shape-consistent and every slotted ticket is
      ``running`` with the batch's own key — incompatible requests
      (different matrix/solver/precond/store_dtype/block/bucket) can
      never share a batch because the key IS the compatibility class;
    * the ``completed`` log holds admitted terminal tickets only, at
      most once each, and never a rejected one.
    """
    stats = service.stats
    tickets = list(tickets)
    for t in tickets:
        if t.status not in TERMINAL_STATES and t.status not in (
                "queued", "running"):
            raise AssertionError(f"illegal status on {t!r}")
        expected = 1 if t.status in TERMINAL_STATES else 0
        if t._terminal_transitions != expected:
            raise AssertionError(
                f"{t!r} took {t._terminal_transitions} terminal "
                f"transitions (expected {expected})")
        if t.status == "rejected" and t.result is not None:
            raise AssertionError(f"rejected ticket with a result: {t!r}")
        if t.status == "cancelled" and t.result is not None:
            raise AssertionError(f"cancelled ticket with a result: {t!r}")
        if t.status == "done" and t.result is None:
            raise AssertionError(f"done ticket without a result: {t!r}")

    resolved = stats["retired"] + stats["cancelled"] + stats["expired"] \
        + stats["rejected"]
    if resolved + service.pending != stats["submitted"]:
        raise AssertionError(
            f"stats partition broken: retired={stats['retired']} + "
            f"cancelled={stats['cancelled']} + expired={stats['expired']} + "
            f"rejected={stats['rejected']} + pending={service.pending} != "
            f"submitted={stats['submitted']}")

    slotted = []
    for key, batch in service._batches.items():
        if not (len(batch.slots) == len(batch.insert_it) == batch.width):
            raise AssertionError(
                f"batch {key} shape drift: {len(batch.slots)} slots, "
                f"{len(batch.insert_it)} insert_its, width {batch.width}")
        if batch.width > service.block_width:
            raise AssertionError(
                f"batch {key} width {batch.width} exceeds the "
                f"block_width cap {service.block_width}")
        for t in batch.slots:
            if t is None:
                continue
            slotted.append(t)
            if t.status != "running":
                raise AssertionError(
                    f"{t!r} sits in batch {key} but is not running")
            if t.key != key:
                raise AssertionError(
                    f"{t!r} (key {t.key}) sits in batch {key}: "
                    f"incompatible requests share a batch")
    if len(set(id(t) for t in slotted)) != len(slotted):
        raise AssertionError("one ticket occupies two batch slots")

    log_counts = Counter(id(t) for t in service.completed)
    if log_counts and max(log_counts.values()) > 1:
        raise AssertionError("a ticket appears twice in the completed log")
    for t in service.completed:
        if t.status not in TERMINAL_STATES:
            raise AssertionError(f"non-terminal ticket in completed: {t!r}")
        if t.status == "rejected":
            raise AssertionError(
                f"rejected (never admitted) ticket in completed: {t!r}")
    # queued live-counts agree with the heaps they summarize
    for key, q in service._queues.items():
        alive = sum(1 for (_, _, _, t) in q._heap if t.status == "queued")
        if alive != len(q):
            raise AssertionError(
                f"queue {key} live count {len(q)} != {alive} actually "
                f"queued entries")
