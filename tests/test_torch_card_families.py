"""The moe, ssm, hybrid, encdec and vlm families on the card against the CPU, in f32.

Card-only twins of ``tests/test_torch_{moe,ssm,hybrid,encdec,vlm}.py``
(which hold the port to the reference on the CPU): each family's smoke
model, with the same weights on both devices, gives the CPU's logits on the
card within 1e-4 of the largest logit (the card sums in another order) and
decodes within 5e-3 of the CPU forward. The file imports neither JAX nor the reference, so the
card's machine, which has no JAX, can collect it.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import registry as treg
from repro_torch.models.common import softcap

FAMILIES = [("qwen3-moe-30b-a3b", 16), ("grok-1-314b", 16), ("mamba2-370m", 21),
            ("recurrentgemma-2b", 19)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,seq", FAMILIES)
def test_the_card_matches_the_cpu_in_f32(arch, seq):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = {"cf": 16.0} if treg.get_config(arch).family == "moe" else {}   # no token dropped
    tm = treg.build_model(arch, smoke=True, **kw)
    params = tm.init_params(0, "cpu")
    card = _unflatten({k: v.cuda() for k, v in _flatten(params).items()})
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, seq))
                           .astype(np.int32))
    with torch.no_grad():
        want = softcap(tm.logits(params, tok), tm.cfg.final_softcap)
        got = softcap(tm.logits(card, tok.cuda()), tm.cfg.final_softcap).cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        cache = tm.init_cache(2, seq, device="cuda")
        for t in range(seq):
            lg, cache = tm.decode_step(card, cache, tok[:, t:t + 1].cuda(),
                                       torch.full((2,), t, dtype=torch.int32, device="cuda"))
            assert float((lg[:, 0].cpu() - want[:, t]).abs().max()) < 5e-3


def _to_card(params):
    return _unflatten({k: v.cuda() for k, v in _flatten(params).items()})


@pytest.mark.gpu
def test_whisper_on_the_card_matches_the_cpu_in_f32():
    """whisper's smoke model: ``encode`` + ``dec_logits`` on the card within
    1e-4 of the CPU's largest logit, then ``prefill_cross`` and decode on the
    card within 5e-3 of the CPU's teacher-forced logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tm = treg.build_model("whisper-large-v3", smoke=True)
    params = tm.init_params(0, "cpu")
    card = _to_card(params)
    r = np.random.default_rng(1)
    B, S = 2, 12
    tok = torch.from_numpy(r.integers(0, tm.cfg.vocab, (B, S)).astype(np.int32))
    audio = torch.from_numpy(r.standard_normal((B, tm.cfg.enc_positions, tm.cfg.d_model))
                             .astype(np.float32))
    with torch.no_grad():
        want = tm.dec_logits(params, tok, tm.encode(params, audio))
        got = tm.dec_logits(card, tok.cuda(), tm.encode(card, audio.cuda())).cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        cache = tm.prefill_cross(card, tm.init_cache(B, S, device="cuda"), audio.cuda())
        for t in range(S):
            lg, cache = tm.decode_step(card, cache, tok[:, t:t + 1].cuda(),
                                       torch.full((B,), t, dtype=torch.int32, device="cuda"))
            assert float((lg[:, 0].cpu() - want[:, t]).abs().max()) < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("n_vis", [8, 0])
def test_internvl2_on_the_card_matches_the_cpu_in_f32(n_vis):
    """internvl2's smoke model: ``logits_mm`` with and without a visual
    prefix on the card within 1e-4 of the CPU's largest logit, and the
    text-only decode within 5e-3 of the CPU forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tm = treg.build_model("internvl2-2b", smoke=True)
    params = tm.init_params(0, "cpu")
    card = _to_card(params)
    r = np.random.default_rng(2)
    B, S = 2, 11
    tok = torch.from_numpy(r.integers(0, tm.cfg.vocab, (B, S)).astype(np.int32))
    vis = torch.from_numpy(r.standard_normal((B, n_vis, tm.cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = tm.logits_mm(params, tok, vis)
        got = tm.logits_mm(card, tok.cuda(), vis.cuda()).cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        text = tm.logits(params, tok)
        cache = tm.init_cache(B, S, device="cuda")
        for t in range(S):
            lg, cache = tm.decode_step(card, cache, tok[:, t:t + 1].cuda(),
                                       torch.full((B,), t, dtype=torch.int32, device="cuda"))
            assert float((lg[:, 0].cpu() - text[:, t]).abs().max()) < 5e-3
