"""The port's serving tick against the JAX reference, on the CPU.

Twin engines — the reference's ``MultiCellEngine`` and the port's — are
built from the same pools, coupling and requests, driven by the same
closed-loop traffic (``drive_closed_loop``: arrivals, departures, handovers,
processed jobs), and must agree record for record and decision for decision
at every step, with identical session-cache counters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CouplingSpec as JCouplingSpec  # noqa: E402
from repro.core import scenarios as JS  # noqa: E402
from repro.serving import MultiCellEngine as JEngine  # noqa: E402
from repro.serving import SliceRequest as JRequest  # noqa: E402
from repro.serving import drive_closed_loop as j_drive  # noqa: E402
from repro.serving import sla_scorecard as j_scorecard  # noqa: E402

from repro_torch.core import CouplingSpec, scenarios  # noqa: E402
from repro_torch.kernels.resize import resize as PR  # noqa: E402
from repro_torch.serving import (EdgeServingEngine,  # noqa: E402
                                 MultiCellEngine, SliceRequest,
                                 drive_closed_loop, sla_scorecard)

N_CELLS = 4
# standing load per cell: seats every cell in the 16-slot bucket on the
# first tick, so the closed loop below never outgrows its device session
STANDING = 9
_MIX = [("coco_bags", 0.35, 8.0), ("coco_animals", 0.50, 6.0),
        ("cityscapes_flat", 0.35, 5.0), ("coco_person", 0.20, 5.0)]


def _engine(engine_cls, spec_cls, scen, request_cls, **kw):
    inc = np.zeros((N_CELLS, 2), bool)
    inc[:2, 0] = True
    inc[2:, 1] = True
    eng = engine_cls(scen.multi_cell_pools(N_CELLS, seed=2),
                     coupling=spec_cls(np.array([2.0, 2.0]), inc),
                     max_retries=2, **kw)
    for c in range(N_CELLS):
        for i in range(STANDING):
            app, acc, fps = _MIX[i % len(_MIX)]
            eng.submit(request_cls("object-recognition", "yolox", app,
                                   max_latency_s=0.7, min_accuracy=acc,
                                   jobs_per_sec=fps), c)
    return eng


def _capture(eng):
    """Record every re-slice's decisions as the driver runs the engine."""
    log = []
    reslice = eng.reslice

    def wrapped():
        out = reslice()
        log.append([[(d.request.app_class, d.request.min_accuracy,
                      d.admitted, d.z, tuple(sorted(d.alloc.items())),
                      d.evicted, d.cell, d.expected_latency_s,
                      d.expected_accuracy) for d in ds] for ds in out])
        return out
    eng.reslice = wrapped
    return log


def _counters(eng):
    s = eng.sesm
    return dict(fresh_stacks=s.fresh_stacks, restacks=s.restacks,
                delta_rows=s.delta_rows, session_rebuilds=s.session_rebuilds,
                link_updates=s.link_updates,
                semantic_updates=s.semantic_updates)


@pytest.fixture(scope="module")
def twins():
    ref = _engine(JEngine, JCouplingSpec, JS, JRequest)
    port = _engine(MultiCellEngine, CouplingSpec, scenarios, SliceRequest,
                   device="cpu")
    logs = _capture(ref), _capture(port)
    kw = dict(arrival_rate=2.0, handover_prob=0.1, process=True, seed=5)
    recs = j_drive(ref, 6, **kw), drive_closed_loop(port, 6, **kw)
    return ref, port, logs, recs


def test_twin_closed_loop_records_and_decisions_match(twins):
    ref, port, (jlog, plog), (jrec, prec) = twins
    assert prec == jrec
    assert len(plog) == len(jlog) == 6
    for step, (j, p) in enumerate(zip(jlog, plog)):
        assert p == j, step
    assert sum(r["admitted"] for r in prec) > 0
    assert sum(r["handovers"] for r in prec) > 0


def test_twin_counters_and_steady_tick(twins):
    ref, port, _, _ = twins
    assert _counters(port) == _counters(ref)
    assert port.sesm.fresh_stacks == 1
    assert port.sesm.session_rebuilds == 0
    # drain the retry queues, then a steady tick scatters zero rows
    for _ in range(port.cells[0].max_retries + 1):
        assert port.reslice() is not None
        ref.reslice()
    before = port.sesm.delta_rows
    port.reslice()
    ref.reslice()
    assert port.sesm.delta_rows == before
    assert _counters(port) == _counters(ref)


def test_twin_data_plane_matches(twins):
    ref, port, _, _ = twins
    for jc, pc in zip(ref.cells, port.cells):
        assert [rt.jobs_done for rt in pc.tasks.values()] == \
            [rt.jobs_done for rt in jc.tasks.values()]
        assert pc.drops == jc.drops and pc.evictions == jc.evictions
    js, ps = j_scorecard(ref)["run"], sla_scorecard(port)["run"]
    for k in ("handovers", "evictions", "drops", "retry_depth", "running",
              "session_rebuilds"):
        assert ps[k] == js[k], k


def test_fast_path_matches_rebuild_path():
    """The device-resident delta tick and the full-rebuild tick decide
    alike on the same candidate sets (the port's own contract)."""
    eng = _engine(MultiCellEngine, CouplingSpec, scenarios, SliceRequest,
                  device="cpu")
    sets = eng.gather()
    fast = eng.sesm.solve_slots([c.sync_slots()[0] for c in eng.cells],
                                [list(range(len(s))) for s in sets],
                                coupling=eng.coupling, pools=eng.pools)
    slow = eng.sesm.solve_batch(sets, coupling=eng.coupling, pools=eng.pools)
    for f, s in zip(fast, slow):
        assert [(d.admitted, d.z, d.alloc) for d in f] == \
            [(d.admitted, d.z, d.alloc) for d in s]


def test_vision_job_compresses_frames_by_z():
    eng = EdgeServingEngine(scenarios.numerical_pool(2), device="cpu")
    eng.submit(SliceRequest("object-recognition", "yolox", "coco_person",
                            max_latency_s=0.7, min_accuracy=0.2))
    (dec,) = eng.reslice()
    assert dec.admitted
    rt = eng.tasks[dec.request.request_id]
    out = eng.runtime._run_vision_job(rt, 2)
    assert out.shape[1:3] == PR.out_size_for_z(128, 128, dec.z)
    eng.process()
    assert rt.jobs_done > 0


def test_lm_models_wait_for_the_lm_stack():
    eng = MultiCellEngine(scenarios.multi_cell_pools(1), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.cells[0].register_model("lm", None, None, None)


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiCellEngine(scenarios.multi_cell_pools(2))
