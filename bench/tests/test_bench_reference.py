"""The plain reference held to the port at smoke sizes on the CPU, in
float32: the same weights and batches give the same losses, gradients and
weight changes over the checked steps."""
import pytest
import torch

from bench import check, train
from bench.reference import tokens, weights
from bench.reference.dims import Dims
from bench.tests.small import CELLS, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port_in_float32(name):
    cell = small_cell(name, dtype="float32")
    dm = Dims.of(cell.config)
    prog = train.build_program(cell.config, cell.traffic, dm)
    _p, _o, got, _feed = train.program_readings(prog, dm, cell.traffic, 2**31 + 11, "cpu")
    ref = train.reference_readings(dm, cell.traffic, 2**31 + 11, "cpu")
    nums = check.numbers(got, ref)
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-5, nums
    assert nums["change_gap"] < 1e-5, nums


@pytest.mark.parametrize("name", CELLS)
def test_reference_forward_equals_port_logits_path(name):
    """One forward's loss through the port's ``model.loss`` and the
    reference's, on the same weights and tokens."""
    from bench.reference import step as ref_step
    from bench.reference.precision import F32

    cell = small_cell(name, dtype="float32")
    dm = Dims.of(cell.config)
    prog = train.build_program(cell.config, cell.traffic, dm)
    params = train.load_weights(prog, dm, 5, "cpu")
    batch = tokens.batch(5, 1, 4, 32, dm.vocab, "cpu")
    port = float(prog.model.loss(params, {"tokens": batch}))
    ref, _ = ref_step.loss_and_grads(weights.flatten(params), batch, dm, F32, rows_per_block=1)
    assert abs(port - float(ref)) <= 1e-5 * abs(float(ref))


def test_port_drops_past_capacity_as_the_reference_does():
    """At a capacity factor of 0.5 each expert is offered twice what it
    keeps; the port's steps still equal the reference's, so both drop the
    same assignments."""
    from bench.reference import step as ref_step
    from bench.reference.precision import F32

    cell = small_cell("moe-train-s2k", dtype="float32")
    cell.config = dict(cell.config, capacity_factor=0.5)
    dm = Dims.of(cell.config)
    seed = 2**31 + 23
    route = []
    ref_step.loss_and_grads(weights.draw(dm, seed, "cpu"),
                            tokens.batch(seed, 1, 4, 32, dm.vocab, "cpu"), dm, F32, route=route)
    assert len(route) == dm.layers and min(route) > 0, route
    prog = train.build_program(cell.config, cell.traffic, dm)
    assert prog.model.cf == 0.5
    _p, _o, got, _feed = train.program_readings(prog, dm, cell.traffic, seed, "cpu")
    nums = check.numbers(got, train.reference_readings(dm, cell.traffic, seed, "cpu"))
    assert max(nums.values()) < 1e-5, nums


def test_dense_row_blocks_do_not_change_the_step():
    cell = small_cell("dense-train-s2k", dtype="float32")
    dm = Dims.of(cell.config)
    from bench.reference import step as ref_step
    from bench.reference.precision import F32

    p = weights.draw(dm, 3, "cpu")
    batch = tokens.batch(3, 1, 4, 32, dm.vocab, "cpu")
    l1, g1 = ref_step.loss_and_grads(p, batch, dm, F32, rows_per_block=1)
    l4, g4 = ref_step.loss_and_grads(p, batch, dm, F32, rows_per_block=4)
    assert torch.allclose(l1, l4, rtol=1e-6)
    for k in g1:
        torch.testing.assert_close(g1[k], g4[k], rtol=1e-5, atol=1e-8)


def test_generators_repeat_from_the_seed_and_differ_between_seeds():
    dm = Dims.of(small_cell("moe-train-s2k").config)
    seed = 2**31 + 3
    a, b = weights.draw(dm, seed, "cpu"), weights.draw(dm, seed, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks/0/wq"], weights.draw(dm, seed + 1, "cpu")["blocks/0/wq"])
    assert all(a[k].dtype == torch.bfloat16 for k in a)
    t1 = tokens.batch(seed, 4, 4, 32, dm.vocab, "cpu")
    assert torch.equal(t1, tokens.batch(seed, 4, 4, 32, dm.vocab, "cpu"))
    assert not torch.equal(t1, tokens.batch(seed, 5, 4, 32, dm.vocab, "cpu"))
    assert t1.dtype == torch.int32 and t1.shape == (4, 33)
    assert int(t1.min()) >= 0 and int(t1.max()) < dm.vocab
    assert len({tuple(r.tolist()) for r in t1}) == 4          # the rows all differ


def test_moe_reference_drops_past_capacity_in_token_order():
    """Every expert keeps its first C assignments, token-major, and no more."""
    from bench.reference import model
    from bench.reference.precision import F32

    cfg = dict(small_cell("moe-train-s2k").config, capacity_factor=0.5)
    dm = Dims.of(cfg)
    T = 64
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((T, dm.d), generator=gen)
    router = torch.randn((dm.d, dm.experts), generator=gen)
    router[:, 0] += 10.0                                   # expert 0 is every token's first choice
    w = [torch.randn(s, generator=gen) * 0.1 for s in
         ((dm.experts, dm.d, dm.ff), (dm.experts, dm.d, dm.ff), (dm.experts, dm.ff, dm.d))]
    y, dropped = model.moe(h, router, *w, dm, F32)
    C = model.capacity(T, dm)
    assert C == max(4, -(-T * dm.top_k // dm.experts) // 2)
    assert dropped >= T - C                                # expert 0 took C of its T
    # the same rule, one assignment at a time
    probs = torch.softmax(h @ router, -1)
    top_p, top_e = torch.topk(probs, dm.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    seen = [0] * dm.experts
    want = torch.zeros_like(h)
    for t in range(T):
        for j in range(dm.top_k):
            e = int(top_e[t, j])
            if seen[e] < C:
                want[t] += top_p[t, j] * model.swiglu(h[t:t + 1], w[0][e], w[1][e], w[2][e], F32)[0]
            seen[e] += 1
    assert dropped == sum(max(0, n - C) for n in seen)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
