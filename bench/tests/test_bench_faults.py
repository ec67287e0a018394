"""A run driven past the look for a card, on the CPU at a small size, with
the timed path broken underneath: ``correct`` comes out false for each
fault a training cell on one card can have (the exchange between cards
does not exist there), and true with nothing broken. Also the control: the
reference with float8 products in the program's place fails the cell's
limits."""
import time

import pytest

from bench import check, train
from bench.reference import readings as ref_readings
from bench.reference.dims import Dims
from bench.reference.precision import FP8
from bench.tests.small import CELLS, small_cell

SEED = 2**31 + 101


def broken(kind: str):
    """A ``build_train_step`` whose step has the fault ``kind``."""
    from repro_torch.launch import steps

    real = steps.build_train_step

    def build(*a, **kw):
        bundle = real(*a, **kw)
        fn = bundle.fn

        def step(params, opt, batch):
            if kind == "unchanged":          # the state comes back as it went in
                _p, _o, stats = fn(params, opt, batch)
                return params, opt, stats
            if kind == "half_batch":         # the mean over half of the rows
                rows = batch["tokens"].shape[0] // 2
                return fn(params, opt, {"tokens": batch["tokens"][:rows]})
            new, o, stats = fn(params, opt, batch)
            if kind == "answer_altered":     # one leaf's update applied twice
                old, upd = params["blocks"]["0"]["wq"], new["blocks"]["0"]["wq"]
                new["blocks"]["0"]["wq"] = (old.float() + 2 * (upd.float() - old.float())).to(old.dtype)
            return new, o, stats

        bundle.fn = step
        return bundle

    return build


def run_small(name: str) -> dict:
    """A float32 run at a small size: the program then agrees with the
    reference to rounding, so what fails is the fault alone."""
    return train.run(small_cell(name, dtype="float32"), SEED, 0.2, False, "cpu",
                     time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}     # no card: no peak


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    from repro_torch.launch import steps

    monkeypatch.setattr(steps, "build_train_step", broken(fault))
    out = run_small(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference in the program's place, its products in float8."""
    cell = small_cell(name)
    dm = Dims.of(cell.config)
    ref = ref_readings.reference(dm, cell.traffic, SEED, "cpu", train.F32)
    ctl = ref_readings.reference(dm, cell.traffic, SEED, "cpu", FP8)
    values = dict(check.numbers(ctl, ref), nonfinite_losses=0)
    ok, checks = check.judge(values, cell.limits)
    assert not ok, checks
