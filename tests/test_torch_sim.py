"""The port's retry backoff, virtual clock, calibrated simulator and
virtual-time determinism, against the reference's.

Every test of ``tests/test_backoff.py``, ``tests/test_vclock.py``,
``tests/test_simulator.py`` and ``tests/test_determinism.py`` runs here on
the port: seeded jitter, the exp and linear shapes, de-correlated lanes,
the retry loops' shared policy; the outage ``Window`` and the guarded
``VirtualClock``; the simulator against the paper's §4 and §6 claims; and
same seed, byte-identical results twice in one process for ``run_load``,
the fabric's virtual sweeps, the controller's decisions, the testbed's
trace export and the autotuner's virtual metrics (the rows
``benchmarks/autotune.py`` computes, taken here from the port's
``SimTuner``, since the port has no benchmarks).

Then the checks across packages, on the same inputs: ``Backoff`` delays per
(seed, lane, attempt), the clock's steps and errors, ``simulate_transfer``
on the ALCF/NERSC/OLCF specs of ``tests/test_simulator.py``, and the
serialised ``run_load`` report, trace export, fabric sweeps, controller
decisions and autotune metrics equal the reference's byte for byte. The
reference is imported inside the tests, so the card's machine, which has no
JAX, can collect this file.
"""
import dataclasses
import importlib
import inspect
import json
import math

import numpy as np
import pytest

from repro_torch.core.backoff import Backoff, jitter_u
from repro_torch.core.simulator import (
    ALCF, NERSC, OLCF, TransferSpec, simulate_transfer,
)
from repro_torch.core.vclock import ConvergenceError, VirtualClock, Window
from repro_torch.service import Submission, run_load

PKGS = ("repro", "repro_torch")
GB = 1e9
MB = 1024 * 1024


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# tests/test_backoff.py on the port
# ---------------------------------------------------------------------------
def test_jitter_u_deterministic_and_bounded():
    for parts in [(0, "m0", "exp", 1), (7, "hop02", "linear", 3), ("x",)]:
        u = jitter_u(*parts)
        assert 0.0 <= u < 1.0
        assert u == jitter_u(*parts)


def test_jitter_u_keyed_not_positional_blur():
    assert jitter_u("ab", "c") != jitter_u("a", "bc")
    assert jitter_u(1, 2) != jitter_u(12)


def test_exp_shape_and_cap():
    b = Backoff(0.01, mode="exp", factor=2.0, cap_exp=3, jitter=0.0)
    assert b.delay(1) == pytest.approx(0.01)
    assert b.delay(2) == pytest.approx(0.02)
    assert b.delay(4) == pytest.approx(0.08)
    assert b.delay(5) == b.delay(9) == pytest.approx(0.08)


def test_linear_shape_and_cap():
    b = Backoff(0.01, mode="linear", cap_mult=4, jitter=0.0)
    assert b.delay(1) == pytest.approx(0.01)
    assert b.delay(3) == pytest.approx(0.03)
    assert b.delay(4) == b.delay(20) == pytest.approx(0.04)


def test_jitter_only_shortens_never_lengthens():
    b = Backoff(0.1, mode="exp", jitter=0.5, seed=3, lane="m1")
    for attempt in range(1, 12):
        base = 0.1 * 2.0 ** min(attempt - 1, 6)
        d = b.delay(attempt)
        assert base * 0.5 <= d <= base
        assert d == b.delay(attempt)


def test_lanes_decorrelate_the_herd():
    lanes = [Backoff(0.05, mode="linear", seed=9, lane=f"mover-{i}")
             for i in range(8)]
    for attempt in (1, 2, 5):
        delays = {b.delay(attempt) for b in lanes}
        assert len(delays) == len(lanes), "lanes collided — herd is back"


def test_seeds_decorrelate_across_runs():
    a = Backoff(0.05, seed=1, lane="m0")
    b = Backoff(0.05, seed=2, lane="m0")
    assert [a.delay(i) for i in range(1, 6)] != [b.delay(i) for i in range(1, 6)]


def test_sleep_returns_and_uses_the_jittered_delay():
    b = Backoff(0.25, mode="linear", seed=4, lane="hop01")
    slept = []
    got = b.sleep(3, sleep=slept.append)
    assert slept == [got] == [b.delay(3)]
    assert math.isfinite(got) and got > 0


def test_validation():
    with pytest.raises(ValueError):
        Backoff(0.01, mode="polynomial")
    with pytest.raises(ValueError):
        Backoff(0.01, jitter=1.0)
    with pytest.raises(ValueError):
        Backoff(0.01).delay(0)


def test_retry_loops_share_the_policy():
    from repro_torch.core import transfer as core_transfer
    from repro_torch.fabric import relay as fabric_relay
    from repro_torch.service import service as svc_mod

    for mod in (core_transfer, fabric_relay, svc_mod):
        assert "Backoff(" in inspect.getsource(mod), mod.__name__


# ---------------------------------------------------------------------------
# tests/test_vclock.py on the port
# ---------------------------------------------------------------------------
def test_window_contains_half_open():
    w = Window(10.0, 5.0)
    assert not w.contains(9.999999)
    assert w.contains(10.0)
    assert w.contains(14.9)
    assert not w.contains(15.0)
    assert not w.contains(20.0)


def test_window_boundaries():
    w = Window(10.0, 5.0)
    assert w.until_start(4.0) == pytest.approx(6.0)
    assert math.isinf(w.until_start(12.0))
    assert w.until_end(12.0) == pytest.approx(3.0)
    assert math.isinf(w.until_end(15.0))
    assert w.next_boundary(4.0) == pytest.approx(6.0)
    assert w.next_boundary(12.0) == pytest.approx(3.0)
    assert math.isinf(w.next_boundary(16.0))


def test_window_zero_duration_and_validation():
    w = Window(3.0, 0.0)
    assert not w.contains(3.0)
    with pytest.raises(ValueError):
        Window(0.0, -1.0)


def test_tick_advances_to_earliest_finite():
    clock = VirtualClock(guard=10)
    dt = clock.tick(5.0, math.inf, 2.0, 7.0)
    assert dt == pytest.approx(2.0)
    assert clock.now == pytest.approx(2.0)
    clock.tick(1.5)
    assert clock.now == pytest.approx(3.5)
    assert clock.steps == 2


def test_tick_floor_clamps_tiny_steps():
    clock = VirtualClock(guard=10)
    clock.tick(1e-18, floor=1e-9)
    assert clock.now == pytest.approx(1e-9)


def test_deadlock_raises():
    clock = VirtualClock(guard=10)
    with pytest.raises(ConvergenceError, match="deadlock"):
        clock.tick(math.inf, math.nan)
    with pytest.raises(ConvergenceError, match="deadlock"):
        clock.tick()


def test_guard_exhaustion_raises_and_is_runtimeerror():
    clock = VirtualClock(guard=3, label="unit")
    for _ in range(3):
        clock.tick(1.0)
    with pytest.raises(ConvergenceError, match="unit failed to converge"):
        clock.tick(1.0)
    assert issubclass(ConvergenceError, RuntimeError)


def test_guard_validation():
    with pytest.raises(ValueError):
        VirtualClock(guard=0)


def test_simulator_uses_shared_clock():
    res = simulate_transfer(
        ALCF, NERSC,
        TransferSpec(file_bytes=(10**9,), chunk_bytes=10**8, integrity=True),
    )
    assert res.seconds > 0


def test_testbed_uses_shared_clock():
    rep = run_load(
        [Submission(0.0, "t0", (10**9,))],
        policy="fair", mover_budget=8, max_concurrent=4,
    )
    assert rep.makespan_s > 0 and len(rep.tasks) == 1


# ---------------------------------------------------------------------------
# tests/test_simulator.py on the port
# ---------------------------------------------------------------------------
def run(src, dst, files, chunk, integrity, stripes=16, sim=simulate_transfer,
        spec=TransferSpec):
    return sim(src, dst, spec(tuple(files), chunk_bytes=chunk, integrity=integrity,
                              stripe_count=stripes))


def test_unchunked_single_file_rate_matches_paper():
    r = run(ALCF, NERSC, [500 * GB], None, True)
    assert r.gbps == pytest.approx(1.98, rel=0.05)


def test_chunking_speedup_single_large_file():
    base = run(ALCF, NERSC, [500 * GB], None, True)
    fast = run(ALCF, NERSC, [500 * GB], 200 * MB, True)
    assert 7.0 <= fast.gbps / base.gbps <= 12.0


def test_lustre_stripe_count_effect():
    s1 = run(NERSC, ALCF, [2500 * GB], 200 * MB, False, stripes=1)
    s16 = run(NERSC, ALCF, [2500 * GB], 200 * MB, False, stripes=16)
    s64 = run(NERSC, ALCF, [2500 * GB], 200 * MB, False, stripes=64)
    assert s1.gbps == pytest.approx(3.92, rel=0.05)
    assert s16.gbps == pytest.approx(31.76, rel=0.10)
    assert s16.gbps / s1.gbps == pytest.approx(8.1, rel=0.15)
    assert s64.gbps < s16.gbps


def test_integrity_checking_cost_unchunked_vs_chunked():
    noint = run(ALCF, NERSC, [500 * GB], None, False)
    withint = run(ALCF, NERSC, [500 * GB], None, True)
    assert withint.seconds - noint.seconds == pytest.approx(773, rel=0.1)
    cnoint = run(ALCF, NERSC, [500 * GB], 200 * MB, False)
    cint = run(ALCF, NERSC, [500 * GB], 200 * MB, True)
    visible = cint.seconds - cnoint.seconds
    assert visible < 80, "chunked checksum cost should be largely hidden"
    assert visible < 0.15 * (withint.seconds - noint.seconds)


def test_many_files_beat_one_file_but_chunking_closes_gap():
    one = run(ALCF, NERSC, [500 * GB], None, True)
    many = run(ALCF, NERSC, [1 * GB] * 500, None, True)
    assert 18 <= many.gbps / one.gbps <= 30
    cone = run(ALCF, NERSC, [500 * GB], 200 * MB, True)
    cmany = run(ALCF, NERSC, [1 * GB] * 500, 200 * MB, True)
    assert cmany.gbps / cone.gbps <= 3.5


def test_chunk_size_sweet_spot():
    rates = {s: run(ALCF, NERSC, [500 * GB], s * MB, True).gbps
             for s in (50, 200, 500, 5000, 25000)}
    peak = max(rates[50], rates[200], rates[500])
    assert peak == max(rates.values())
    assert rates[5000] < 0.85 * peak
    assert rates[25000] < rates[5000] + 0.5


def test_chunking_neutral_for_many_files():
    base = run(ALCF, NERSC, [25 * GB] * 20, None, True)
    chunked = run(ALCF, NERSC, [25 * GB] * 20, 500 * MB, True)
    assert 0.8 <= chunked.gbps / base.gbps <= 1.8


def test_all_site_pairs_complete():
    for src in (ALCF, NERSC, OLCF):
        for dst in (ALCF, NERSC, OLCF):
            if src is dst:
                continue
            r = run(src, dst, [5 * GB] * 4, 500 * MB, True)
            assert r.seconds > 0 and r.gbps > 0


# ---------------------------------------------------------------------------
# tests/test_determinism.py on the port
# ---------------------------------------------------------------------------
def _canon(obj) -> str:
    """Canonical JSON of a (nested-dataclass) result object."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    return json.dumps(obj, sort_keys=True, default=repr)


def _one_load(seed: int, pkg: str = "repro_torch"):
    svc, faults = _mod(pkg, "service"), _mod(pkg, "faults")
    work = [svc.Submission(0.0, f"t{k % 3}", (8 * 10**9,)) for k in range(6)]
    work.append(svc.Submission(5.0, "t3", tuple([2 * 10**9] * 4)))
    scenario = faults.parse_scenario(
        "corrupt_1_per_TiB+kill_2_movers+outage_at_50pct"
    ).scaled_to(int(sum(sum(s.file_bytes) for s in work)), target_events=6.0)
    return svc.run_load(
        work, policy="marginal", mover_budget=16, max_concurrent=4,
        chunk_bytes=500 * 10**6,
        batch=svc.BatchConfig(direct_bytes=10**9, batch_files=8),
        scenario=scenario, seed=seed,
    )


def test_run_load_is_bit_deterministic():
    a, b = _one_load(seed=3), _one_load(seed=3)
    assert _canon(a) == _canon(b)


def test_run_load_seed_actually_matters():
    a, b = _one_load(seed=3), _one_load(seed=4)
    assert _canon(a.faults) != _canon(b.faults)


def _one_campaign(seed: int, pkg: str = "repro_torch"):
    fabric = _mod(pkg, "fabric")
    topo = fabric.shared_trunk_topology(4)
    dests = [f"d{i}" for i in range(4)]
    nbytes = 50 * 10**9
    tree = fabric.build_distribution_tree(fabric.RoutePlanner(topo), "src", dests, nbytes)
    scenario = _mod(pkg, "faults").parse_scenario(
        "corrupt_1_per_TiB+link_outage_at_50pct+degrade_hop")
    camp = fabric.simulate_campaign(topo, tree, nbytes, scenario=scenario, seed=seed)
    naive = fabric.simulate_naive(topo, "src", dests, nbytes, scenario=scenario, seed=seed)
    return camp, naive


def test_fabric_virtual_sweep_is_bit_deterministic():
    (c1, n1), (c2, n2) = _one_campaign(7), _one_campaign(7)
    assert _canon(c1) == _canon(c2)
    assert _canon(n1) == _canon(n2)


def _metrics(rows):
    return {n: {"value": v, "unit": u} for n, v, u in rows}


def _virtual_rows(pkg: str = "repro_torch") -> list[tuple[str, float, str]]:
    """The autotuner's virtual rows (``benchmarks/autotune.py``'s
    ``virtual_rows``) from one package's ``SimTuner``: the warm start
    against the paper-default 500 MB static chunk."""
    sim, tune = _mod(pkg, "core.simulator"), _mod(pkg, "tune")
    rows: list[tuple[str, float, str]] = []
    tuner = tune.SimTuner(sim.ALCF, sim.NERSC)
    for gb in (100, 500):
        total = gb * 10**9
        static = 500 * 10**6
        t_static = tuner.predict_seconds(total, static)
        best = tuner.seed_chunk(total)
        t_best = tuner.predict_seconds(total, best)
        lo, hi = tuner.bounds(total)
        pre = f"autotune/virtual/{gb}GB"
        rows += [
            (f"{pre}/sim_seed_MB", round(best / 1e6, 3), "MB"),
            (f"{pre}/bounds_lo_MB", round(lo / 1e6, 3), "MB"),
            (f"{pre}/bounds_hi_MB", round(hi / 1e6, 3), "MB"),
            (f"{pre}/static_500MB_seconds", round(t_static, 3), "s"),
            (f"{pre}/seeded_seconds", round(t_best, 3), "s"),
            (f"{pre}/seed_speedup", round(t_static / t_best, 4), "x"),
        ]
    return rows


def test_autotune_virtual_metrics_identical_across_runs():
    m1, m2 = _metrics(_virtual_rows()), _metrics(_virtual_rows())
    assert json.dumps(m1, sort_keys=True) == json.dumps(m2, sort_keys=True)


def _testbed_rows(pkg: str = "repro_torch"):
    rep = _one_load(seed=11, pkg=pkg)
    return [
        ("agg_gbps", round(rep.aggregate_gbps, 6), "Gb/s"),
        ("makespan_s", round(rep.makespan_s, 6), "s"),
        ("p50_s", round(rep.p50_s, 6), "s"),
        ("p99_s", round(rep.p99_s, 6), "s"),
        ("amplification", round(rep.retry_amplification, 9), "x"),
        ("corruptions", rep.faults.corruptions, "events"),
    ]


def test_testbed_metrics_identical_across_runs():
    assert _metrics(_testbed_rows()) == _metrics(_testbed_rows())


def _decisions(pkg: str = "repro_torch"):
    tune = _mod(pkg, "tune")
    ctrl = tune.ChunkController(chunk_bytes=256 * 1024, min_chunk=32 * 1024,
                                max_chunk=2 * 1024 * 1024, epoch_chunks=2)
    rates = [1e8, 1.1e8, 9e7, 1e8, 3e7, 2.8e7, 5e7, 5.2e7] * 6
    for i, r in enumerate(rates):
        c = ctrl.target()
        ctrl.observe(tune.ChunkSample(offset=i, length=c, seconds=c / r,
                                      attempt_seconds=c / r))
    return [(d.epoch, d.action, d.chunk_bytes, round(d.rate_Bps, 6))
            for d in ctrl.decisions]


def test_controller_decisions_are_deterministic():
    assert _decisions() == _decisions()


def _trace_bytes(seed: int, pkg: str = "repro_torch") -> str:
    obs, svc = _mod(pkg, "obs"), _mod(pkg, "service")
    tracer = obs.Tracer(clock=obs.Clock(lambda: 0.0, virtual=True))
    svc.run_load(
        svc.mixed_workload(n_small=40, n_large=2),
        scenario=_mod(pkg, "faults").parse_scenario(
            "corrupt_1_per_TiB+kill_2_movers+outage_at_50pct"),
        policy="marginal", mover_budget=8, max_concurrent=4,
        seed=seed, tracer=tracer,
    )
    assert tracer.spans(), "testbed emitted no spans"
    return tracer.export_json()


def test_testbed_trace_export_is_byte_identical():
    a, b, c = _trace_bytes(7), _trace_bytes(7), _trace_bytes(8)
    assert a == b
    assert a != c


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 9, 2**31 - 1])
def test_backoff_delays_equal_across_packages(seed):
    """Every (seed, lane, attempt, shape) gives the reference's delay, bit
    for bit, and the same jitter."""
    ref = _mod("repro", "core.backoff")
    rng = np.random.default_rng(seed)
    for lane in ("", "m0", "mover-7", "hop02", "relay/a->b"):
        for mode in ("exp", "linear"):
            base = float(rng.uniform(1e-4, 1.0))
            kw = dict(mode=mode, factor=float(rng.uniform(1.1, 3.0)),
                      cap_exp=int(rng.integers(1, 8)), cap_mult=int(rng.integers(1, 10)),
                      jitter=float(rng.uniform(0.0, 0.99)), seed=seed, lane=lane)
            mine, theirs = Backoff(base, **kw), ref.Backoff(base, **kw)
            for attempt in range(1, 20):
                assert mine.delay(attempt) == theirs.delay(attempt)
                assert jitter_u(seed, lane, mode, attempt) == \
                    ref.jitter_u(seed, lane, mode, attempt)


def test_backoff_errors_equal_across_packages():
    ref = _mod("repro", "core.backoff")

    def outcome(fn):
        try:
            return ("ok", fn())
        except ValueError as e:
            return ("error", str(e))
    for mk in (lambda m: m.Backoff(0.01, mode="polynomial"),
               lambda m: m.Backoff(0.01, jitter=1.0),
               lambda m: m.Backoff(0.01, jitter=-0.1),
               lambda m: m.Backoff(0.01).delay(0)):
        assert outcome(lambda: mk(_mod("repro_torch", "core.backoff"))) == \
            outcome(lambda: mk(ref))


def _clock_trace(mod, seed: int) -> list:
    """A seeded run of ticks, each over 0-4 candidates with infinities and
    NaNs mixed in, to the guard: every step's delta, time and step count,
    or the error's type and message."""
    rng = np.random.default_rng(seed)
    clock = mod.VirtualClock(guard=40, label=f"trace{seed}")
    out = []
    for _ in range(45):
        cands = [float(x) for x in rng.exponential(1.0, int(rng.integers(0, 5)))]
        for i in range(len(cands)):
            pick = rng.random()
            if pick < 0.15:
                cands[i] = math.inf
            elif pick < 0.2:
                cands[i] = math.nan
        floor = float(rng.choice([0.0, 1e-9, 0.05]))
        try:
            out.append(("ok", clock.tick(*cands, floor=floor), clock.now, clock.steps))
        except mod.ConvergenceError as e:
            out.append(("error", type(e).__name__, str(e), clock.steps))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_clock_steps_and_errors_equal_across_packages(seed):
    got = _clock_trace(_mod("repro_torch", "core.vclock"), seed)
    assert got == _clock_trace(_mod("repro", "core.vclock"), seed)
    assert any(r[0] == "error" and "failed to converge" in r[2] for r in got)


def test_window_arithmetic_equal_across_packages():
    ref = _mod("repro", "core.vclock")
    rng = np.random.default_rng(5)
    for _ in range(50):
        start, dur = float(rng.uniform(0, 100)), float(rng.choice([0.0, rng.uniform(0, 50)]))
        mine, theirs = Window(start, dur), ref.Window(start, dur)
        for t in (*rng.uniform(-10, 200, 8), start, start + dur):
            t = float(t)
            assert (mine.contains(t), mine.until_start(t), mine.until_end(t),
                    mine.next_boundary(t)) == \
                (theirs.contains(t), theirs.until_start(t), theirs.until_end(t),
                 theirs.next_boundary(t))
    for m in (_mod("repro_torch", "core.vclock"), ref):
        with pytest.raises(ValueError):
            m.Window(0.0, -1.0)
        with pytest.raises(ValueError):
            m.VirtualClock(guard=0)


SIM_CASES = [
    ("ALCF", "NERSC", (500 * GB,), None, True, 16),
    ("ALCF", "NERSC", (500 * GB,), 200 * MB, True, 16),
    ("ALCF", "NERSC", (500 * GB,), None, False, 16),
    ("ALCF", "NERSC", (500 * GB,), 200 * MB, False, 16),
    ("NERSC", "ALCF", (2500 * GB,), 200 * MB, False, 1),
    ("NERSC", "ALCF", (2500 * GB,), 200 * MB, False, 16),
    ("NERSC", "ALCF", (2500 * GB,), 200 * MB, False, 64),
    ("ALCF", "NERSC", (1 * GB,) * 500, None, True, 16),
    ("ALCF", "NERSC", (1 * GB,) * 500, 200 * MB, True, 16),
    *[("ALCF", "NERSC", (500 * GB,), s * MB, True, 16) for s in (50, 500, 5000, 25000)],
    ("ALCF", "NERSC", (25 * GB,) * 20, None, True, 16),
    ("ALCF", "NERSC", (25 * GB,) * 20, 500 * MB, True, 16),
    *[(a, b, (5 * GB,) * 4, 500 * MB, True, 16)
      for a in ("ALCF", "NERSC", "OLCF") for b in ("ALCF", "NERSC", "OLCF") if a != b],
    ("ALCF", "NERSC", (10**9,), 10**8, True, 16),
]


@pytest.mark.parametrize("src, dst, files, chunk, integrity, stripes", SIM_CASES)
def test_simulate_transfer_equal_across_packages(src, dst, files, chunk, integrity, stripes):
    """The specs of ``tests/test_simulator.py``: the port's result equals the
    reference's, field for field."""
    got = {}
    for pkg in PKGS:
        sim = _mod(pkg, "core.simulator")
        res = run(sim.SITES[src], sim.SITES[dst], [int(f) for f in files], chunk, integrity,
                  stripes, sim=sim.simulate_transfer, spec=sim.TransferSpec)
        got[pkg] = dataclasses.asdict(res)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("seed", [3, 4, 11])
def test_run_load_equal_across_packages(seed):
    """The serialised load report is the reference's, byte for byte."""
    assert _canon(_one_load(seed, "repro_torch")) == _canon(_one_load(seed, "repro"))


def test_testbed_rows_equal_across_packages():
    assert _metrics(_testbed_rows("repro_torch")) == _metrics(_testbed_rows("repro"))


@pytest.mark.parametrize("seed", [7, 8])
def test_trace_export_equal_across_packages(seed):
    assert _trace_bytes(seed, "repro_torch") == _trace_bytes(seed, "repro")


def test_fabric_sweep_equal_across_packages():
    (pc, pn), (rc, rn) = _one_campaign(7, "repro_torch"), _one_campaign(7, "repro")
    assert _canon(pc) == _canon(rc)
    assert _canon(pn) == _canon(rn)


def test_controller_decisions_equal_across_packages():
    assert _decisions("repro_torch") == _decisions("repro")


def test_autotune_virtual_metrics_equal_the_reference_benchmark():
    """The rows from the port's ``SimTuner`` equal the reference benchmark's
    ``virtual_rows()`` and the same arithmetic on the reference's tuner."""
    from benchmarks.autotune import virtual_rows

    mine = json.dumps(_metrics(_virtual_rows()), sort_keys=True)
    assert mine == json.dumps(_metrics(virtual_rows()), sort_keys=True)
    assert mine == json.dumps(_metrics(_virtual_rows("repro")), sort_keys=True)
