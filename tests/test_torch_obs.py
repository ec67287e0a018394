"""The port's bottleneck attribution (``obs/attr.py``) against the
reference.

On both packages (``pkg`` is "repro" or "repro_torch"; the port's engines
and service run with ``device="cpu"``, the digest kernels' plain versions):
the attribution tests of ``tests/test_obs.py`` — the saturation-priority
sweep sums exactly to the makespan, verify-lag waits fold into ``cksum``,
window overrides and per-group reports — and the traced engine run and
span-chain probe they rely on. Across packages: the same span lists give
equal attributions and reports, down to the virtual testbed's whole trace
under a chaos scenario. And the port's serial service task: its movers'
device digests appear as ``cksum_inline`` spans that attribution charges
to ``cksum``.

The reference is imported inside the tests (``_ns``), so the card's machine,
which has no JAX, can collect this file.
"""
import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's observability API under one set of names. The port's
    ``ChunkedTransfer`` and ``TransferService`` are bound to
    ``device="cpu"``."""
    core = importlib.import_module(f"{name}.core")
    obs = importlib.import_module(f"{name}.obs")
    svc = importlib.import_module(f"{name}.service")
    engine, svc_cls = core.ChunkedTransfer, svc.TransferService
    if name == "repro_torch":
        engine = functools.partial(engine, device="cpu")
        svc_cls = functools.partial(svc_cls, device="cpu")
    return SimpleNamespace(
        name=name, ChunkedTransfer=engine, TransferService=svc_cls,
        BufferDest=core.BufferDest, BufferSource=core.BufferSource,
        ChunkJournal=core.ChunkJournal, plan_chunks=core.plan_chunks,
        Span=obs.Span, Tracer=obs.Tracer, Clock=obs.Clock,
        attribute=obs.attribute, by_group=obs.by_group, report=obs.report,
        sample_from_chain=importlib.import_module(f"{name}.tune.probe").sample_from_chain,
        ServiceConfig=svc.ServiceConfig, BatchConfig=svc.BatchConfig,
        run_load=svc.run_load, mixed_workload=svc.mixed_workload,
        parse_scenario=importlib.import_module(f"{name}.faults").parse_scenario,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


def _span(pkg, sid, cat, t0, t1, name="x", task="t", lane="", **args):
    return pkg.Span(sid, name, cat, t0, t1, task, lane, tuple(sorted(args.items())))


# ---------------------------------------------------------------------------
# the attribution tests of tests/test_obs.py, on both packages
# ---------------------------------------------------------------------------
def test_attribution_priority_and_exact_sum(pkg):
    spans = [
        _span(pkg, 1, "wire", 0.0, 4.0),
        _span(pkg, 2, "cksum", 2.0, 6.0),
        _span(pkg, 3, "stall", 3.0, 5.0),
        _span(pkg, 4, "queue", 0.0, 8.0),
        _span(pkg, 5, "task", 0.0, 10.0),                # defines the makespan
    ]
    a = pkg.attribute(spans)
    assert a.makespan_s == pytest.approx(10.0)
    assert sum(a.seconds.values()) == pytest.approx(10.0)
    assert sum(a.shares().values()) == pytest.approx(1.0)
    # [0,3) wire beats cksum/queue; [3,5) stall beats all; [5,6) cksum;
    # [6,8) queue; [8,10) idle
    assert a.seconds["wire"] == pytest.approx(3.0)
    assert a.seconds["stall"] == pytest.approx(2.0)
    assert a.seconds["cksum"] == pytest.approx(1.0)
    assert a.seconds["queue"] == pytest.approx(2.0)
    assert a.seconds["idle"] == pytest.approx(2.0)
    assert a.dominant() == "wire"
    assert a.to_json()["dominant"] == "wire"
    assert "wire" in a.format("x")


def test_attribution_cksum_wait_folds_into_cksum(pkg):
    spans = [_span(pkg, 1, "wire", 0.0, 2.0), _span(pkg, 2, "cksum_wait", 1.0, 2.0)]
    a = pkg.attribute(spans)
    assert a.seconds["wire"] == pytest.approx(1.0)
    assert a.seconds["cksum"] == pytest.approx(1.0)
    assert "cksum_wait" not in a.seconds


def test_attribution_window_override_and_groups(pkg):
    spans = [_span(pkg, 1, "wire", 0.0, 1.0, hop=0),
             _span(pkg, 2, "wire", 1.0, 3.0, hop=1),
             _span(pkg, 3, "stall", 2.5, 3.0, hop=1)]
    a = pkg.attribute(spans, t0=0.0, t1=4.0)
    assert a.makespan_s == pytest.approx(4.0)
    assert a.seconds["idle"] == pytest.approx(1.0)
    groups = pkg.by_group(spans, "hop")
    assert set(groups) == {"0", "1"}
    assert groups["0"].seconds["wire"] == pytest.approx(1.0)
    assert groups["1"].seconds["stall"] == pytest.approx(0.5)
    rep = pkg.report(spans, group_key="hop")
    assert rep["overall"]["dominant"] == "wire"
    assert set(rep["per_hop"]) == {"0", "1"}


def test_engine_emits_chunk_lifecycle_spans(pkg, tmp_path):
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 256 * 1024, dtype=np.uint8).tobytes()
    plan = pkg.plan_chunks(len(payload), 2, chunk_bytes=64 * 1024,
                           min_chunk=1, max_chunk=1 << 40, alignment=1)
    tr = pkg.Tracer()
    journal = pkg.ChunkJournal(str(tmp_path / "eng.journal"))
    rep = pkg.ChunkedTransfer(
        pkg.BufferSource(payload), pkg.BufferDest(len(payload)), plan,
        pipeline="pipelined", integrity_workers=1, journal=journal,
        tracer=tr, task="eng").run()
    journal.close()
    assert rep.total_bytes == len(payload) and rep.pipeline == "pipelined"
    cats = {s.cat for s in tr.spans("eng")}
    assert {"wire", "cksum", "journal", "task"} <= cats
    chain = tr.chunk_chain("eng", 0)
    assert chain and chain == sorted(chain, key=lambda s: (s.t0, s.sid))
    a = pkg.attribute(tr.spans("eng"))
    assert sum(a.shares().values()) == pytest.approx(1.0, abs=1e-6)
    assert a.makespan_s > 0


def test_probe_sample_derived_from_span_chain(pkg):
    tr = pkg.Tracer()
    tr.add("queue_wait", "queue", 0.0, 1.0, task="t", offset=0)
    tr.add("move", "wire", 1.0, 3.0, task="t", lane="mover1", offset=0, attempt=2)
    tr.add("cksum_inline", "cksum", 3.0, 3.5, task="t", offset=0)
    tr.add("refetch", "stall", 3.5, 5.5, task="t", offset=0, kind="corruption")
    tr.add("verify_wait", "cksum_wait", 5.5, 6.0, task="t", offset=0)
    s = pkg.sample_from_chain(tr.chunk_chain("t", 0), length=4096)
    assert s.attempt_seconds == pytest.approx(2.5)  # wire + cksum only
    assert s.seconds == pytest.approx(4.5)          # + stall
    assert s.cksum_seconds == pytest.approx(0.5)
    assert s.cksum_lag_s == pytest.approx(0.5)
    assert s.attempts == 2 and s.refetches == 1 and s.mover == 1
    with pytest.raises(ValueError):
        pkg.sample_from_chain([])


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _random_spans(ns, seed, n=200):
    rng = np.random.default_rng(seed)
    cats = ("wire", "cksum", "cksum_wait", "stall", "queue", "journal", "dedup")
    out = []
    for sid in range(1, n + 1):
        t0 = float(rng.uniform(0.0, 50.0))
        out.append(_span(ns, sid, cats[int(rng.integers(len(cats)))], t0,
                         t0 + float(rng.exponential(2.0)), task=f"t{sid % 3}",
                         hop=int(rng.integers(3))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribution_equal_across_packages(seed):
    ref, port = _ns("repro"), _ns("repro_torch")
    a, b = _random_spans(ref, seed), _random_spans(port, seed)
    assert port.attribute(b).to_json() == ref.attribute(a).to_json()
    assert port.report(b, group_key="hop") == ref.report(a, group_key="hop")


def _testbed_report(ns):
    tracer = ns.Tracer(clock=ns.Clock(lambda: 0.0, virtual=True))
    ns.run_load(ns.mixed_workload(n_small=20, n_large=2),
                scenario=ns.parse_scenario("corrupt_1_per_TiB+kill_2_movers+outage_at_50pct"),
                seed=5, tracer=tracer)
    return ns.report(tracer.spans())


def test_testbed_trace_attribution_equal_across_packages():
    assert _testbed_report(_ns("repro_torch")) == _testbed_report(_ns("repro"))


# ---------------------------------------------------------------------------
# the port alone: the movers' device digests are attributed to cksum
# ---------------------------------------------------------------------------
def test_serial_task_device_digests_attributed_to_cksum(tmp_path):
    port = _ns("repro_torch")
    src = tmp_path / "f.bin"
    src.write_bytes(np.random.default_rng(2).bytes(12 * 32 * 1024 + 5))
    svc = port.TransferService(tmp_path / "svc", port.ServiceConfig(
        mover_budget=2, max_concurrent_tasks=1, chunk_bytes=32 * 1024,
        tick_s=0.002, batch=port.BatchConfig(direct_bytes=1 << 30)))
    try:
        [tid] = svc.submit([(str(src), str(src) + ".out")], batch=False)
        st = svc.wait(tid, timeout=60)
        spans = svc.tracer.spans(tid)
    finally:
        svc.close()
    assert st.state == "SUCCEEDED"
    inline = [s for s in spans if s.name == "cksum_inline"]
    assert len(inline) == st.chunks_done == 13
    a = port.attribute(spans)
    assert a.seconds["cksum"] > 0.0
    assert sum(a.shares().values()) == pytest.approx(1.0, abs=1e-6)
