"""The port's counterparts of ``tests/test_service_properties.py``, on the
CPU (``device="cpu"``).

Property tests over random arrival mixes on the virtual-clock harness.

One scenario runner drives both entry points: a Hypothesis ``@given``
over generated request mixes (solver × precond × block × store_dtype ×
deadline × priority × cancel points) and a plain-pytest deterministic
sweep over seeded random mixes, so the invariants stay exercised even
where hypothesis is not installed (the conftest shim skips the
``@given`` tests gracefully).

Invariants checked after — and during — every scenario:

* every ticket completes, cancels, expires, or is rejected **exactly
  once** (the ``_terminal_transitions`` counter and the stats partition);
* incompatible requests never share a batch (batch key == compatibility
  class, checked slot-by-slot at every step);
* no admitted request starves: ``drain`` resolves everything.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.matrices import laplace3d
from repro_torch.runtime import MatrixRegistry
from torch_service_harness import ServiceHarness, assert_consistent

N_SIDE = 5          # laplace3d(5): n = 125, small enough for many mixes


@pytest.fixture(scope="module")
def registry():
    r, c, v, n = laplace3d(N_SIDE)
    reg = MatrixRegistry()
    kw = dict(rows=r, cols=c, vals=v, shape=(n, n), C=8, sigma=16,
              w_align=4, dtype=np.float32, device="cpu")
    reg.register("m_f32", **kw)
    reg.register("m_bf16", store_dtype=torch.bfloat16, **kw)
    return reg


N = N_SIDE ** 3


def _spec_is_valid(spec) -> bool:
    solver, precond, block = spec["solver"], spec["precond"], spec["block"]
    if block and (solver == "pipelined_cg" or precond is not None):
        return False
    if precond is not None and solver == "pipelined_cg":
        return False
    return True


def run_mix(registry, specs, *, admission, max_queue=None, block_width=3,
            chunk_iters=4, check_every=2):
    """Submit a request mix, apply its cancel points, drain, verify."""
    h = ServiceHarness(registry, admission=admission, max_queue=max_queue,
                       block_width=block_width, chunk_iters=chunk_iters)
    rng = np.random.default_rng(7)
    tickets = []
    for spec in specs:
        t = h.submit(spec["matrix"],
                     rng.standard_normal(N).astype(np.float32),
                     solver=spec["solver"], tol=spec["tol"],
                     maxiter=spec["maxiter"], precond=spec["precond"],
                     block=spec["block"], deadline=spec["deadline"],
                     priority=spec["priority"])
        tickets.append((t, spec))
    step = 0
    while h.service.pending:
        for t, spec in tickets:
            if spec["cancel_at"] == step:
                h.cancel(t)
        h.step()
        if step % check_every == 0:
            assert_consistent(h.service, [t for t, _ in tickets])
        step += 1
        if step > 5_000:
            raise AssertionError(
                f"mix did not drain (starvation?): {h.service.describe()}")
    assert_consistent(h.service, [t for t, _ in tickets])
    # exactly-once resolution for every ticket, admitted or not
    for t, spec in tickets:
        assert t.resolved, f"admitted request starved: {t!r}"
        assert t._terminal_transitions == 1
        if t.status == "done":
            assert t.result is not None
        if t.rejected:
            assert max_queue is not None
    # incompatible requests never shared a batch: every pair of tickets
    # with different config got different keys (the per-step check above
    # enforced key == batch membership)
    for t, spec in tickets:
        if t.rejected:
            continue
        k = t.key
        assert k[0] == spec["matrix"]
        assert k[1] == spec["solver"]
        assert k[3] == (spec["precond"] or "")
        assert k[4] == ("bfloat16" if spec["matrix"] == "m_bf16"
                        else "float32")
        assert k[5] == ("block" if spec["block"] else "")
    return h, tickets


# ------------------------------------------------------------- hypothesis
spec_strategy = st.fixed_dictionaries({
    "matrix": st.sampled_from(["m_f32", "m_bf16"]),
    "solver": st.sampled_from(["cg", "minres", "pipelined_cg"]),
    "precond": st.sampled_from([None, "chebyshev:3"]),
    "block": st.booleans(),
    "tol": st.sampled_from([1e-3, 1e-5, 1e-8]),
    "maxiter": st.sampled_from([50, 300]),
    "deadline": st.sampled_from([None, None, 2.0, 6.0]),
    "priority": st.integers(min_value=0, max_value=3),
    "cancel_at": st.sampled_from([None, None, None, 0, 1, 3]),
}).filter(_spec_is_valid)


@given(specs=st.lists(spec_strategy, min_size=1, max_size=12),
       admission=st.sampled_from(["fifo", "bucketed"]),
       max_queue=st.sampled_from([None, 2]))
@settings(max_examples=15, deadline=None)
def test_random_mix_property(registry, specs, admission, max_queue):
    run_mix(registry, specs, admission=admission, max_queue=max_queue)


# ------------------------------------------------- deterministic fallback
def _random_spec(rng) -> dict:
    while True:
        spec = {
            "matrix": rng.choice(["m_f32", "m_bf16"]),
            "solver": rng.choice(["cg", "minres", "pipelined_cg"]),
            "precond": rng.choice([None, "chebyshev:3"]),
            "block": bool(rng.integers(2)),
            "tol": float(rng.choice([1e-3, 1e-5, 1e-8])),
            "maxiter": int(rng.choice([50, 300])),
            "deadline": (None if rng.random() < 0.5
                         else float(rng.choice([2.0, 6.0]))),
            "priority": int(rng.integers(4)),
            "cancel_at": (None if rng.random() < 0.6
                          else int(rng.integers(4))),
        }
        if _spec_is_valid(spec):
            return spec


@pytest.mark.parametrize("seed,admission,max_queue", [
    (0, "fifo", None),
    (1, "bucketed", None),
    (2, "bucketed", 2),
    (3, "fifo", 2),
])
def test_seeded_mix_deterministic(registry, seed, admission, max_queue):
    """The same invariants as the hypothesis sweep on fixed seeds — runs
    everywhere, keeps the property coverage when hypothesis is absent."""
    rng = np.random.default_rng(seed)
    specs = [_random_spec(rng) for _ in range(int(rng.integers(6, 12)))]
    h, tickets = run_mix(registry, specs, admission=admission,
                         max_queue=max_queue)
    # the scenario actually exercised interesting paths
    stats = h.service.stats
    assert stats["submitted"] == len(specs)
    assert stats["batches_opened"] >= 2          # mixed keys really split
