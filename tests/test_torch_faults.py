"""The port's fault-injection harness and the compactor's crash recovery
(CPU): mirrors of ``tests/test_faults.py``'s plan tests and compactor
tests through ``repro_torch``, and the same seeded plan firing at the
same hits in both packages."""

import numpy as np
import pytest

from repro.runtime.faults import FaultPlan as RFaultPlan
from repro.runtime.faults import FaultSpec as RFaultSpec
from repro.runtime.faults import fault_point as r_fault_point
from repro.runtime.faults import fault_scope as r_fault_scope
from repro_torch.config import HarmonyConfig
from repro_torch.core import SegmentedIndex
from repro_torch.runtime.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active_fault_plan,
    fault_point,
    fault_scope,
    install_fault_plan,
)
from repro_torch.serve import HarmonyServer
from repro_torch.serve.compactor import CompactionConfig, Compactor

CFG = HarmonyConfig(dim=8, nlist=4, nprobe=4, topk=3, kmeans_iters=2)


def _data(seed=0, nb=256):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nb, 8)).astype(np.float32)


def _served(nb=128):
    x = _data(nb=nb)
    data = SegmentedIndex.build(x, CFG, device="cpu")
    return x, data, HarmonyServer(data, n_nodes=2, device="cpu")


# --------------------------------------------------------------- the plan
def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("x", kind="explode")
    with pytest.raises(ValueError, match="1-based"):
        FaultSpec("x", at=0)


def test_fault_plan_counting_where_and_delay():
    plan = FaultPlan(
        FaultSpec("a", at=2, count=2, where={"node": 1}),
        FaultSpec("b", kind="delay", delay_s=0.25),
    )
    with fault_scope(plan):
        assert fault_point("a", node=0) == 0.0      # where mismatch
        assert fault_point("a", node=1) == 0.0      # hit 1, armed at 2
        for expect_hit in (2, 3):                   # hits 2 and 3 fire
            with pytest.raises(InjectedFault) as ei:
                fault_point("a", node=1)
            assert ei.value.hit == expect_hit
        assert fault_point("a", node=1) == 0.0      # window exhausted
        assert fault_point("b") == 0.25             # delay returns seconds
    assert plan.fired == 3
    assert [e["site"] for e in plan.log] == ["a", "a", "b"]


def test_fault_plan_probability_is_seeded():
    """Replayable for a seed, thinned, and the same draws as the
    reference's plan (both take ``numpy.random.default_rng(seed)``)."""
    def run(seed, spec, plan_cls, scope, point):
        plan = plan_cls(spec("s", at=1, count=100, kind="delay", delay_s=1.0, p=0.5),
                        seed=seed)
        with scope(plan):
            return [point("s") for _ in range(50)], list(plan.log)

    d1, l1 = run(7, FaultSpec, FaultPlan, fault_scope, fault_point)
    d2, l2 = run(7, FaultSpec, FaultPlan, fault_scope, fault_point)
    assert d1 == d2 and l1 == l2                    # replayable
    assert 0 < sum(d1) < 50                         # actually thinned
    dr, lr = run(7, RFaultSpec, RFaultPlan, r_fault_scope, r_fault_point)
    assert d1 == dr and l1 == lr


def test_fault_scope_restores_previous_plan():
    outer = FaultPlan(FaultSpec("o"))
    with fault_scope(outer):
        with fault_scope(FaultSpec("i")):
            with pytest.raises(InjectedFault):
                fault_point("i")
        with pytest.raises(InjectedFault):
            fault_point("o")                        # outer plan restored
        assert active_fault_plan() is outer
    assert fault_point("o") == 0.0                  # nothing installed
    install_fault_plan(FaultPlan(FaultSpec("p", kind="torn")))
    try:
        with pytest.raises(InjectedFault) as ei:
            fault_point("p")
        assert ei.value.kind == "torn"
    finally:
        install_fault_plan(None)
    assert active_fault_plan() is None


# ------------------------------------------------------- compactor crashes
@pytest.mark.parametrize(
    "site", ["compactor.begin", "compactor.seal", "compactor.prepare",
             "compactor.commit"]
)
def test_compactor_crash_then_recover(site):
    x, data, srv = _served()
    rng = np.random.default_rng(3)
    comp = Compactor(data, srv, CompactionConfig(delta_threshold=4), device="cpu")
    srv.upsert(np.arange(300, 306), rng.standard_normal((6, 8)).astype(np.float32))
    with fault_scope(FaultSpec(site, kind="crash")):
        with pytest.raises(InjectedFault):
            comp.run_once(reason="chaos")
    report = comp.recover()
    if site == "compactor.commit":
        # committed: roll forward, the replica adopts the generation
        assert not report["rolled_back"] and report["generation"] == 1
    else:
        # not committed: roll back, nothing lost (begin only snapshots)
        assert report["rolled_back"] and report["generation"] == 0
    assert not data.compaction_in_flight
    assert srv.generation == data.generation
    for i in range(300, 306):
        assert data.has(i)
    ev = comp.run_once(reason="after")
    assert ev["generation"] == data.generation
    res = srv.search_batch(x[:1], k=1)
    assert np.isfinite(res.scores[0, 0]) and int(res.ids[0, 0]) == 0


def test_compactor_recover_is_noop_when_clean():
    _, data, srv = _served(nb=64)
    comp = Compactor(data, srv, device="cpu")
    assert comp.recover() == {"rolled_back": False, "adopted": [], "generation": 0}


def test_background_compactor_survives_injected_crash():
    """An InjectedFault inside the background loop is recorded like any
    failed cycle; recover() then clears the wreckage and compaction goes
    on."""
    _, data, srv = _served()
    comp = Compactor(data, srv, CompactionConfig(delta_threshold=4, poll_s=0.005),
                     device="cpu")
    rng = np.random.default_rng(5)
    with fault_scope(FaultSpec("compactor.seal", kind="crash")):
        with pytest.warns(UserWarning, match="background compaction failed"):
            comp.start()
            try:
                srv.upsert(np.arange(300, 310),
                           rng.standard_normal((10, 8)).astype(np.float32))
                deadline = 200                      # this test's limit: 2 s
                while not comp.errors and deadline:
                    deadline -= 1
                    comp._stop.wait(0.01)
            finally:
                assert comp.stop(timeout=20.0), "the compactor thread outlived 20 s"
    assert comp.errors and "InjectedFault" in comp.errors[0]
    comp.recover()
    ev = comp.maybe_compact()
    assert ev is not None and data.delta_len == 0
