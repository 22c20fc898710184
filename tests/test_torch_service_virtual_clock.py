"""The port's counterparts of ``tests/test_service_virtual_clock.py``, on
the CPU (``device="cpu"``).

Deterministic scheduling tests on the virtual-clock harness.

Everything here is exact: deadlines are tick counts, latencies are whole
numbers of steps, and no assertion depends on how fast the machine runs
the chunks.  Covers the injectable clock itself, deadline expiry on the
queued and running paths, priority/EDF ordering, the deadline-driven
chunk shrinking, bucketed admission keys, the dispatcher's
anti-starvation aging, and adaptive batch width.
"""
import time

import numpy as np
import pytest

from repro_torch.matrices import laplace3d
from repro_torch.runtime import MatrixRegistry, SolverService
from repro_torch.solvers.stepper import snap_chunk
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


class TestInjectableClock:
    def test_default_clock_is_perf_counter(self, reg):
        assert SolverService(reg).clock is time.perf_counter

    def test_all_timestamps_come_from_injected_clock(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, start=100.0, block_width=2, chunk_iters=8)
        t = h.submit("lap", _b(n), tol=1e-4, maxiter=500)
        assert t.submitted_at == 100.0
        h.drain()
        assert t.started_at == 100.0            # admitted on the first step
        assert t.finished_at == 100.0 + t.latency
        assert t.latency == int(t.latency) >= 1  # whole ticks, ≥ one step

    def test_latency_counts_steps_exactly(self, reg, lap):
        """Two identical services on the virtual clock retire the same
        workload with identical tick latencies — the determinism claim."""
        *_, n = lap
        lat = []
        for _ in range(2):
            h = ServiceHarness(reg, block_width=2, chunk_iters=8)
            ts = [h.submit("lap", _b(n, seed=i), tol=1e-5, maxiter=500)
                  for i in range(5)]
            h.drain()
            lat.append([t.latency for t in ts])
        assert lat[0] == lat[1]

    def test_queue_wait_is_visible(self, reg, lap):
        """A request admitted only after a refill shows its queued ticks."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=4)
        first = h.submit("lap", _b(n, 1), tol=1e-6, maxiter=500)
        second = h.submit("lap", _b(n, 2), tol=1e-6, maxiter=500)
        h.drain()
        assert first.queue_wait == 0.0
        assert second.queue_wait == first.latency   # admitted when #1 left
        assert_consistent(h.service, [first, second])


class TestDeadlines:
    def test_running_request_expires_at_chunk_boundary(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=2, chunk_iters=4)
        t = h.submit("lap", _b(n), tol=1e-30, maxiter=10**6, deadline=3.0)
        ok = h.submit("lap", _b(n, 5), tol=1e-4, maxiter=500)
        h.drain()
        assert t.status == "expired"
        assert t.latency == 3.0                  # the boundary right at it
        assert t.result is not None              # best-effort iterate
        assert not t.result.converged and t.result.iters > 0
        assert ok.status == "done" and ok.result.converged
        assert h.service.stats["expired"] == 1
        assert_consistent(h.service, [t, ok])

    def test_queued_request_expires_at_refill(self, reg, lap):
        """Deadline passes while waiting in the queue: the request is
        expired at the refill gate, never occupies a slot, gets no
        result."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=4)
        hog = h.submit("lap", _b(n, 1), tol=1e-30, maxiter=10**6)
        h.step()                                 # hog takes the only slot
        starved = h.submit("lap", _b(n, 2), tol=1e-4, deadline=2.0)
        for _ in range(4):
            h.step()
        assert starved.status == "queued"        # hog still holds the slot
        h.cancel(hog)
        h.drain()
        assert starved.status == "expired"
        assert starved.result is None and starved.started_at is None
        assert_consistent(h.service, [hog, starved])

    def test_deadline_validation(self, reg, lap):
        *_, n = lap
        svc = SolverService(reg)
        with pytest.raises(ValueError, match="deadline"):
            svc.submit("lap", _b(n), deadline=0.0)
        with pytest.raises(ValueError, match="deadline"):
            svc.submit("lap", _b(n), deadline=-1.0)


class TestPriorityAndEDF:
    def _drain_order(self, h, tickets):
        h.drain()
        done = [t for t in h.service.completed if t in tickets]
        return [tickets.index(t) for t in done]

    def test_higher_priority_dequeues_first(self, reg, lap):
        """Width-1 batch, three queued: admission order follows priority,
        visible in started_at ticks."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=8)
        lo = h.submit("lap", _b(n, 1), tol=1e-4, priority=0)
        hi = h.submit("lap", _b(n, 2), tol=1e-4, priority=5)
        mid = h.submit("lap", _b(n, 3), tol=1e-4, priority=2)
        h.step()                                  # admits exactly one
        assert (hi.status, mid.status, lo.status) == (
            "running", "queued", "queued")
        h.drain()
        assert hi.started_at < mid.started_at < lo.started_at

    def test_edf_within_priority_fifo_on_ties(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=8)
        no_dl = h.submit("lap", _b(n, 1), tol=1e-4)
        late = h.submit("lap", _b(n, 2), tol=1e-4, deadline=1000.0)
        soon = h.submit("lap", _b(n, 3), tol=1e-4, deadline=500.0)
        h.step()
        # earliest deadline admitted first; the no-deadline request last
        assert soon.status == "running"
        h.drain()
        assert soon.started_at < late.started_at < no_dl.started_at
        # pure FIFO on full ties: same priority, no deadlines
        h2 = ServiceHarness(reg, block_width=1, chunk_iters=8)
        a = h2.submit("lap", _b(n, 4), tol=1e-4)
        b = h2.submit("lap", _b(n, 5), tol=1e-4)
        h2.drain()
        assert a.started_at <= b.started_at


class TestDeadlineChunkShrinking:
    def test_snap_chunk(self):
        assert snap_chunk(100, 16) == 16
        assert snap_chunk(16, 16) == 16
        assert snap_chunk(15, 16) == 8
        assert snap_chunk(5, 16) == 4
        assert snap_chunk(1, 16) == 1
        assert snap_chunk(0, 16) == 1
        assert snap_chunk(-3, 16) == 1
        with pytest.raises(ValueError, match="k_max"):
            snap_chunk(4, 0)

    def test_tight_deadline_shrinks_chunks(self, reg, lap):
        """With a seconds-per-iteration hint and a deadline shorter than
        a full chunk, the service cuts the chunk so the boundary lands
        near the deadline (power-of-two sizes only)."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=16,
                           iter_time_hint=lambda key: 1.0)  # 1 iter = 1 tick
        t = h.submit("lap", _b(n), tol=1e-30, maxiter=10**6, deadline=6.0)
        h.step()
        # 6 ticks of slack at 1 tick/iter → snap_chunk(6,16)=4, not 16
        assert int(h.service._batches[t.key].state.it) == 4
        assert h.service.stats["deadline_chunks"] == 1
        h.drain()
        assert t.status == "expired"
        assert_consistent(h.service, [t])

    def test_no_deadline_runs_full_chunks(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, chunk_iters=16,
                           iter_time_hint=lambda key: 1.0)
        t = h.submit("lap", _b(n), tol=1e-30, maxiter=64)
        h.step()
        assert int(h.service._batches[t.key].state.it) == 16
        h.drain()
        assert h.service.stats["deadline_chunks"] == 0
        assert t.status == "done"


class TestBucketedAdmission:
    def test_difficulty_buckets_split_batch_keys(self, reg, lap):
        """Same matrix/solver, very different tol: bucketed admission
        separates the keys; fifo keeps them together."""
        *_, n = lap
        fifo = ServiceHarness(reg, block_width=4)
        easy_f = fifo.submit("lap", _b(n, 1), tol=1e-2, maxiter=10**6)
        hard_f = fifo.submit("lap", _b(n, 2), tol=1e-12, maxiter=10**6)
        assert easy_f.key == hard_f.key and easy_f.key[6] == ""
        assert easy_f.pred_iters is None         # fifo never predicts

        buck = ServiceHarness(reg, block_width=4, admission="bucketed",
                              bucket_base=2.0)
        easy = buck.submit("lap", _b(n, 1), tol=1e-2, maxiter=10**6)
        hard = buck.submit("lap", _b(n, 2), tol=1e-12, maxiter=10**6)
        assert easy.key[:6] == hard.key[:6]      # same config...
        assert easy.key[6] != hard.key[6]        # ...different bucket
        assert 0 < easy.pred_iters < hard.pred_iters
        buck.drain()
        assert buck.service.stats["batches_opened"] == 2
        assert easy.result.converged and hard.status == "done"
        assert_consistent(buck.service, [easy, hard])

    def test_predicted_iters_scales_with_tol_and_clamps(self, reg):
        p_loose = reg.predicted_iters("lap", tol=1e-2)
        p_tight = reg.predicted_iters("lap", tol=1e-12)
        assert 1 <= p_loose < p_tight
        assert reg.predicted_iters("lap", tol=1e-12, maxiter=7) == 7
        with pytest.raises(ValueError, match="unknown solver"):
            reg.predicted_iters("lap", solver="gmres")
        with pytest.raises(ValueError, match="tol"):
            reg.predicted_iters("lap", tol=0.0)
        # the prediction rides the cached bounds: no second Lanczos run
        assert reg.stats["bounds_computed"] == 1

    def test_dispatcher_advances_one_batch_per_step(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=2, admission="bucketed",
                           bucket_base=2.0)
        h.submit("lap", _b(n, 1), tol=1e-2, maxiter=10**6)
        h.submit("lap", _b(n, 2), tol=1e-12, maxiter=500)
        assert h.step() == 1                     # one chunk, not two
        h.drain()
        assert_consistent(h.service)

    def test_no_starvation_under_aging(self, reg, lap):
        """A straggler batch must still be scheduled within
        starvation_limit rounds even while short work keeps arriving."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=1, admission="bucketed",
                           bucket_base=2.0, chunk_iters=4,
                           starvation_limit=3)
        hard = h.submit("lap", _b(n, 0), tol=1e-12, maxiter=10**6)
        h.step()                                 # open + advance hard batch
        hard_key = hard.key
        progress = [int(h.service._batches[hard_key].state.it)]
        for i in range(12):
            h.submit("lap", _b(n, i + 1), tol=1e-2, maxiter=10**6,
                     priority=10)                # a stream of urgent work
            h.step()
            bt = h.service._batches.get(hard_key)
            progress.append(int(bt.state.it) if bt is not None else
                            progress[-1])
        # the straggler advanced despite never winning the urgency score
        assert progress[-1] > progress[0], progress
        h.drain()
        assert hard.status == "done"
        assert_consistent(h.service, [hard])


class TestAdaptiveWidth:
    def test_column_batch_width_tracks_queue_depth(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=8, admission="bucketed",
                           chunk_iters=8)
        t = h.submit("lap", _b(n), tol=1e-10, maxiter=500)
        h.step()
        assert h.service._batches[t.key].width == 1   # one request: width 1
        h.drain()

        h2 = ServiceHarness(reg, block_width=8, admission="bucketed",
                            chunk_iters=8)
        ts = [h2.submit("lap", _b(n, i), tol=1e-10, maxiter=500)
              for i in range(3)]
        h2.step()
        assert h2.service._batches[ts[0].key].width == 4  # pow2ceil(3)
        h2.drain()
        assert all(t.result.converged for t in ts)

    def test_fifo_keeps_fixed_width(self, reg, lap):
        *_, n = lap
        h = ServiceHarness(reg, block_width=8, chunk_iters=8)
        t = h.submit("lap", _b(n), tol=1e-10, maxiter=500)
        h.step()
        assert h.service._batches[t.key].width == 8
        h.drain()

    def test_block_batch_width_adapts_at_warm_restart(self, reg, lap):
        """Block batches re-init on refill; the restart repacks the
        survivors and resizes to demand."""
        *_, n = lap
        h = ServiceHarness(reg, block_width=4, admission="bucketed",
                           chunk_iters=8)
        first = [h.submit("lap", _b(n, i), tol=1e-5, maxiter=500,
                          block=True) for i in range(4)]
        h.step()
        key = first[0].key
        assert h.service._batches[key].width == 4
        # after the first wave retires, a single follow-up shrinks it
        h.run_until(lambda: all(t.resolved for t in first))
        late = h.submit("lap", _b(n, 9), tol=1e-5, maxiter=500, block=True)
        h.run_until(lambda: late.started_at is not None)
        assert h.service._batches[key].width < 4
        h.drain()
        assert late.result.converged
        assert_consistent(h.service, first + [late])
