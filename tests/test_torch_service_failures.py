"""The port's counterparts of ``tests/test_service_failures.py``, on the
CPU (``device="cpu"``).

Failure-injection tests: the scheduling edges where state could tear.

Each scenario forces one specific hazard — cancel landing mid-chunk (and
racing a convergence at the same boundary), a deadline expiring during a
refill on the column AND the block warm-restart path, admission
rejection at a full queue, and a whole queue expiring before its batch
ever initializes — then checks the service's counters, ``completed``
log, and batch state with the same invariant checker the property tests
use.  All on the virtual clock: every scenario is exact and repeatable.
"""
import numpy as np
import pytest

from repro_torch.matrices import laplace3d
from repro_torch.runtime import MatrixRegistry
from torch_service_harness import ServiceHarness, assert_consistent


@pytest.fixture(scope="module")
def lap():
    r, c, v, n = laplace3d(6)
    return r, c, v, n


@pytest.fixture()
def reg(lap):
    r, c, v, n = lap
    registry = MatrixRegistry()
    registry.register("lap", rows=r, cols=c, vals=v, shape=(n, n), C=16,
                      sigma=32, w_align=4, dtype=np.float32, device="cpu")
    return registry


def _b(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


class TestCancelMidChunk:
    @pytest.mark.parametrize("block", [False, True])
    def test_cancel_running_lands_at_next_boundary(self, reg, lap, block):
        *_, n = lap
        h = ServiceHarness(reg, block_width=2, chunk_iters=4)
        t = h.submit("lap", _b(n, 1), tol=1e-10, maxiter=500, block=block)
        peer = h.submit("lap", _b(n, 2), tol=1e-10, maxiter=500,
                        block=block)
        h.step()                               # both running, mid-solve
        assert t.status == "running"
        assert h.cancel(t) is True
        assert t.status == "running"           # not yet — chunk boundary
        h.step()
        assert t.status == "cancelled" and t.result is None
        assert h.cancel(t) is False            # second cancel is a no-op
        assert h.service.stats["cancelled"] == 1
        assert t in h.service.completed
        h.drain()
        assert peer.status == "done" and peer.result.converged
        assert h.service.stats["retired"] == 1
        assert_consistent(h.service, [t, peer])

    def test_cancel_wins_over_convergence_at_same_boundary(self, reg, lap):
        """A cancel issued mid-chunk sticks even if the column converges
        inside that very chunk: cancel() == True must always mean the
        ticket ends cancelled (never 'done-anyway')."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=64)
        t = h.submit("lap", _b(n), tol=1e-3, maxiter=500)  # converges in 1
        # step() is atomic from the outside, so emulate the mid-chunk
        # moment: open the batch (admits the ticket), cancel, THEN run
        # the chunk that would converge it
        for key, q in list(h.service._queues.items()):
            if q:
                h.service._open_batch(key)
        assert t.status == "running"
        assert h.cancel(t) is True
        h.step()                               # chunk runs and converges
        assert t.status == "cancelled"         # but cancel won
        assert t.result is None
        assert h.service.stats["retired"] == 0
        assert h.service.stats["converged"] == 0
        assert_consistent(h.service, [t])

    def test_cancel_queued_never_admitted(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=4)
        hog = h.submit("lap", _b(n, 1), tol=1e-10, maxiter=500)
        waiting = h.submit("lap", _b(n, 2), tol=1e-10, maxiter=500)
        h.step()
        assert waiting.status == "queued"
        assert h.cancel(waiting) is True
        assert waiting.status == "cancelled"   # queued cancels are instant
        assert waiting.started_at is None
        h.drain()
        assert hog.status == "done"
        # the lazily-removed heap entry never resurfaced
        assert h.service.stats["cancelled"] == 1
        assert h.service.stats["retired"] == 1
        assert_consistent(h.service, [hog, waiting])


class TestDeadlineDuringRefill:
    def test_column_refill_expires_stale_request(self, reg, lap):
        """Deadline passes while queued behind a full column batch: the
        refill gate expires it — no slot, no result, counters exact."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=4)
        hog = h.submit("lap", _b(n, 1), tol=1e-4, maxiter=500)
        h.step()                               # hog takes the only slot
        stale = h.submit("lap", _b(n, 2), tol=1e-4, deadline=1.0)
        fresh = h.submit("lap", _b(n, 3), tol=1e-4, maxiter=500)
        h.run_until(lambda: stale.resolved)
        assert stale.status == "expired"
        assert stale.started_at is None and stale.result is None
        assert stale in h.service.completed
        h.drain()
        # the non-deadline sibling behind it was admitted and completed
        assert fresh.status == "done" and fresh.result.converged
        s = h.service.stats
        assert (s["expired"], s["retired"]) == (1, 2)
        assert_consistent(h.service, [hog, stale, fresh])

    def test_block_warm_restart_expires_stale_request(self, reg, lap):
        """Same hazard on the block path: the expiry fires inside
        _refill_block, before the warm restart admits newcomers, and the
        restart must stay consistent for the survivors."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=2, chunk_iters=4)
        quick = h.submit("lap", _b(n, 1), tol=1e-3, maxiter=500,
                         block=True)
        slow = h.submit("lap", _b(n, 2), tol=1e-10, maxiter=500,
                        block=True)
        h.step()                               # block batch of two, full
        stale = h.submit("lap", _b(n, 3), tol=1e-4, deadline=1.0,
                         block=True)
        late = h.submit("lap", _b(n, 4), tol=1e-4, maxiter=500,
                        block=True)
        h.run_until(lambda: stale.resolved)
        assert stale.status == "expired"
        assert stale.started_at is None and stale.result is None
        h.drain()
        assert quick.result.converged and slow.result.converged
        assert late.result.converged           # admitted by the restart
        # per-ticket iteration accounting survived the warm restart(s)
        assert slow.result.iters > 0 and late.result.iters > 0
        s = h.service.stats
        assert (s["expired"], s["retired"]) == (1, 3)
        assert_consistent(h.service, [quick, slow, stale, late])

    @pytest.mark.parametrize("block", [False, True])
    def test_whole_queue_expires_before_batch_init(self, reg, lap, block):
        """Every queued request is already past its deadline when the
        batch opens: the batch must come up empty (state None), expire
        them all without running a chunk, and get torn down cleanly."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=2, chunk_iters=4)
        a = h.submit("lap", _b(n, 1), tol=1e-4, deadline=1.0, block=block)
        b = h.submit("lap", _b(n, 2), tol=1e-4, deadline=1.5, block=block)
        h.clock.advance(5.0)                   # both deadlines long gone
        h.step()
        assert a.status == b.status == "expired"
        assert a.result is None and b.result is None
        assert h.service.stats["chunks"] == 0  # no chunk ever ran
        assert not h.service._batches          # batch torn down
        assert h.service.pending == 0
        assert_consistent(h.service, [a, b])
        # the service is still healthy afterwards
        ok = h.submit("lap", _b(n, 3), tol=1e-4, maxiter=500, block=block)
        h.drain()
        assert ok.status == "done" and ok.result.converged


class TestAdmissionRejection:
    def test_full_queue_rejects_and_recovers(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=4, max_queue=2)
        admitted = [h.submit("lap", _b(n, i), tol=1e-4, maxiter=500)
                    for i in range(2)]
        overflow = [h.submit("lap", _b(n, 9), tol=1e-4, maxiter=500)
                    for _ in range(3)]
        for t in overflow:
            assert t.rejected and t.result is None
            assert t.finished_at is not None and t.latency == 0.0
            assert t not in h.service.completed   # never admitted
        s = h.service.stats
        assert s["rejected"] == 3 and s["submitted"] == 5
        assert_consistent(h.service, admitted + overflow)
        # draining frees queue capacity: the next submit is admitted
        h.drain()
        again = h.submit("lap", _b(n, 10), tol=1e-4, maxiter=500)
        assert not again.rejected
        h.drain()
        assert again.status == "done"
        assert (h.service.stats["retired"], h.service.stats["rejected"]) \
            == (3, 3)
        assert_consistent(h.service, admitted + overflow + [again])

    def test_rejection_is_per_key(self, reg, lap):
        """The bound is per batch key: a full cg queue must not reject
        minres traffic."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=4, max_queue=1)
        h.submit("lap", _b(n, 1), tol=1e-4)            # fills the cg queue
        rej = h.submit("lap", _b(n, 2), tol=1e-4)
        ok = h.submit("lap", _b(n, 3), tol=1e-4, solver="minres")
        assert rej.rejected and not ok.rejected
        h.drain()
        assert ok.status == "done"
        assert_consistent(h.service)

    def test_cancelled_queue_entry_frees_capacity(self, reg, lap):
        """cancel() on a queued ticket must release its admission slot
        even though the heap removes entries lazily."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=4, max_queue=1)
        queued = h.submit("lap", _b(n, 1), tol=1e-4)
        assert h.submit("lap", _b(n, 2), tol=1e-4).rejected
        h.cancel(queued)
        ok = h.submit("lap", _b(n, 3), tol=1e-4)       # capacity is back
        assert not ok.rejected
        h.drain()
        assert ok.status == "done" and queued.status == "cancelled"
        assert_consistent(h.service, [queued, ok])
