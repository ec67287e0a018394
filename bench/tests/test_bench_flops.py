"""The frozen FLOP count from the configuration files' shapes."""
import pytest

from bench import flops, spec
from bench.reference.dims import Dims


@pytest.mark.parametrize("name,want", [("moe-train-s2k", 2.25e13), ("dense-train-s2k", 1.80e14)])
def test_step_flops_of_the_cells(name, want):
    cell = spec.load_cell(name)
    got = flops.train_step_flops(Dims.of(cell.config), cell.traffic["seq_len"],
                                 cell.traffic["global_batch"])
    assert abs(got - want) <= 0.005 * want, got


def test_active_params():
    moe = Dims.of(spec.load_cell("moe-train-s2k").config)
    dense = Dims.of(spec.load_cell("dense-train-s2k").config)
    # 2 x 56.9 M in the layers plus the 311.2 M head; 4 x 272.6 M plus 671.1 M
    assert abs(flops.active_params(moe) - 425.0e6) < 0.5e6
    assert abs(flops.active_params(dense) - (4 * 272.6e6 + 671.1e6)) < 0.5e6


def test_peaks():
    assert flops.BF16_PEAK_FLOPS == 989.4e12 and flops.HBM_BYTES_PER_S == 3.35e12
