"""The port's training and serving launchers against the reference's, on the CPU.

AdamW and the token pipeline are held to ``repro.optim.adamw`` and
``repro.data.pipeline`` (one optimizer step within f32 rounding; batches
byte for byte). ``repro_torch.launch.train`` is the twin of
``tests/test_system.py``'s run (the loss falls, a run resumes from its own
checkpoint), and a checkpoint root written by either package's
``train.main`` resumes in the other with the losses of the writer's own
resume, within f32 tolerance. Everything runs with ``--device cpu``,
apart from the test marked ``gpu``, which runs the launchers on the card. The
reference (and JAX) is imported inside the tests that use it, so the card's
machine, which has no JAX, can collect this file.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw

SMOKE_ARGS = ["--arch", "gemma-2b", "--smoke", "--mesh", "1x1", "--seq-len", "32",
              "--global-batch", "4", "--log-every", "0", "--lr", "3e-3"]
LOSS_RTOL = 1e-4        # f32 losses after up to 4 resumed steps of both packages


def _ref():
    import jax
    import jax.numpy as jnp

    from repro.data import pipeline as jpipe
    from repro.optim import adamw as jadamw
    return jax, jnp, jpipe, jadamw


def _tree(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"embed": r.standard_normal((50, 8)).astype(dtype),
            "blocks": {"0": {"wq": r.standard_normal((2, 8, 4)).astype(dtype),
                             "ln1": r.standard_normal((2, 8)).astype(dtype)}}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_steps_equal_the_reference(clip):
    """Three AdamW steps from the same params, grads and state: params, m,
    v, grad norm and lr within f32 rounding (rtol 1e-6), the step exact.
    ``clip=1.0`` clips these grads, 100 does not; step 1 of 3 is in warmup."""
    jax, jnp, _, jadamw = _ref()
    params = _tree(0)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, grad_clip=clip)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, grad_clip=clip)
    jp, js = jax.tree.map(jnp.asarray, params), jadamw.init(jax.tree.map(jnp.asarray, params),
                                                              cfg_j)
    tp, ts = _torch_tree(params), tadamw.init(_torch_tree(params), cfg_t)
    for i in range(3):
        grads = _tree(10 + i)
        jp, js, jst = jadamw.apply(jp, jax.tree.map(jnp.asarray, grads), js, cfg_j)
        tp, ts, tst = tadamw.apply(tp, _torch_tree(grads), ts, cfg_t)
        assert int(ts.step) == int(js.step) == i + 1 and ts.step.dtype == torch.int32
        np.testing.assert_allclose(float(tst["grad_norm"]), float(jst["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tst["lr"]), float(jst["lr"]), rtol=1e-6)
        for name, t, j in (("params", tp, jp), ("m", ts.m, js.m), ("v", ts.v, js.v)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(j)[0]:
                got = t
                for p in path:
                    got = got[p.key]
                np.testing.assert_allclose(got.numpy(), np.asarray(leaf), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{name} {path}")


def test_adamw_keeps_bf16_state_and_params():
    """bf16 storage (the reference's grok-1 setting): the update runs in f32
    and each leaf is cast back to its own dtype; within bf16 rounding of
    the reference (one ulp, rtol 2^-7)."""
    import ml_dtypes

    jax, jnp, _, jadamw = _ref()

    params = _tree(1, ml_dtypes.bfloat16)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=1, state_dtype=jnp.bfloat16)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, state_dtype=torch.bfloat16)
    grads = _tree(2, ml_dtypes.bfloat16)
    jp, js, _ = jadamw.apply(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
                             jadamw.init(jax.tree.map(jnp.asarray, params), cfg_j), cfg_j)
    tparams = {"embed": torch.from_numpy(params["embed"].view(np.int16).copy()).view(torch.bfloat16),
               "blocks": {"0": {k: torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
                                for k, v in params["blocks"]["0"].items()}}}
    tgrads = tadamw.tree_map(lambda p, g: torch.from_numpy(
        np.asarray(g).view(np.int16).copy()).view(torch.bfloat16), tparams, grads)
    tp, ts, _ = tadamw.apply(tparams, tgrads, tadamw.init(tparams, cfg_t), cfg_t)
    assert tp["embed"].dtype == ts.m["embed"].dtype == ts.v["embed"].dtype == torch.bfloat16
    for got, want in ((tp["embed"], jp["embed"]), (ts.m["embed"], js.m["embed"]),
                      (ts.v["embed"], js.v["embed"])):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# the token pipeline (tests/test_data_and_sched.py, on the port)
# ---------------------------------------------------------------------------
def test_batches_equal_the_reference_byte_for_byte():
    _, _, jpipe, _ = _ref()
    for structured in (True, False):
        cfg = dict(vocab=101, seq_len=16, global_batch=4, seed=7, structured=structured)
        for step in (0, 5, 123):
            got = tpipe._batch_at(tpipe.DataConfig(**cfg), step)
            want = jpipe._batch_at(jpipe.DataConfig(**cfg), step)
            assert got.dtype == want.dtype == np.int32
            assert got.tobytes() == want.tobytes()
    p = tpipe.TokenPipeline(tpipe.DataConfig(vocab=101, seq_len=16, global_batch=4, seed=7),
                            device="cpu")
    try:
        for step in range(4):
            tok = next(p)["tokens"]
            assert tok.dtype == torch.int32 and tok.device.type == "cpu"
            assert tok.numpy().tobytes() == jpipe._batch_at(
                jpipe.DataConfig(vocab=101, seq_len=16, global_batch=4, seed=7), step).tobytes()
    finally:
        p.close()


def test_pipeline_resume_and_seek_match():
    cfg = tpipe.DataConfig(vocab=101, seq_len=8, global_batch=2, seed=1)
    p1 = tpipe.TokenPipeline(cfg, device="cpu")
    seq1 = [next(p1)["tokens"].numpy() for _ in range(6)]
    p1.close()
    p2 = tpipe.TokenPipeline(cfg, start_step=3, device="cpu")     # restart mid-stream
    seq2 = [next(p2)["tokens"].numpy() for _ in range(3)]
    p2.close()
    for x, y in zip(seq1[3:], seq2):
        np.testing.assert_array_equal(x, y)
    cfg = tpipe.DataConfig(vocab=53, seq_len=8, global_batch=2, seed=2)
    p = tpipe.TokenPipeline(cfg, device="cpu")
    next(p), next(p)
    p.seek(0)
    np.testing.assert_array_equal(next(p)["tokens"].numpy(), tpipe._batch_at(cfg, 0))
    p.close()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch import serve, train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.TokenPipeline(tpipe.DataConfig(vocab=11, seq_len=4, global_batch=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(SMOKE_ARGS[:-6] + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma-2b", "--smoke"])
    with pytest.raises(RuntimeError, match="needs 4 devices, have 1"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    assert make_mesh((1, 1), ("data", "model"), device="cpu").size == 1
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def test_train_loss_decreases_and_resumes(tmp_path):
    """The twin of tests/test_system.py::test_train_loss_decreases_and_resumes."""
    from repro_torch.launch.train import main
    out1 = main(SMOKE_ARGS + ["--device", "cpu", "--steps", "14", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "7"])
    assert np.isfinite(out1["final_loss"])
    assert out1["losses"][-1] < out1["losses"][0]          # learning happens
    out2 = main(SMOKE_ARGS + ["--device", "cpu", "--steps", "18", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "0"])
    assert len(out2["losses"]) == 4                         # only steps 14..18
    assert out2["final_loss"] < out1["losses"][0]


def test_microbatches_and_chunked_sync_on_one_pod(tmp_path):
    """Two microbatches give the one-batch step's losses (f32 accumulation),
    and ``--sync-mode chunked`` on one pod is the same path as "auto"."""
    from repro_torch.launch.train import main
    base = SMOKE_ARGS + ["--device", "cpu", "--steps", "4"]
    auto = main(base)["losses"]
    np.testing.assert_allclose(main(base + ["--microbatches", "2"])["losses"], auto, rtol=1e-5)
    assert main(base + ["--sync-mode", "chunked"])["losses"] == auto


def test_serve_generates():
    """The twin of tests/test_system.py::test_serve_generates, plus the
    prefill and serve steps of ``launch.steps``."""
    from repro_torch.configs import build_model
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step, build_serve_step

    seqs = serve.main(["--arch", "gemma2-2b", "--smoke", "--batch", "2",
                       "--prompt-len", "6", "--gen", "8", "--device", "cpu"])
    assert seqs.shape == (2, 14)
    assert (seqs >= 0).all() and (seqs < 128).all()
    m = build_model("gemma2-2b", smoke=True)
    params = m.init_params(0, "cpu")
    prompts = serve.prompts_for(0, 2, 6, m.cfg.vocab, "cpu")
    assert np.array_equal(serve.generate(m, params, prompts, 8, 14).numpy(), seqs)
    last = build_prefill_step(m).fn(params, {"tokens": prompts})
    torch.testing.assert_close(last, m.logits(params, prompts)[:, -1:].detach())
    step = build_serve_step(m).fn
    cache, tok = m.init_cache(2, 14, device="cpu"), prompts[:, :1]
    pos = torch.zeros(2, dtype=torch.int32)
    for t in range(5):
        nxt, cache, pos = step(params, cache, tok, pos)
        tok = prompts[:, t + 1:t + 2]
    nxt, cache, pos = step(params, cache, tok, pos)
    assert nxt[:, 0].tolist() == seqs[:, 6].tolist() and pos.tolist() == [6, 6]


def _manifest(root, step):
    with open(root / f"step_{step:08d}" / "MANIFEST.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """A root written by one package's ``train.main`` (14 steps, checkpoint
    at step 14) is resumed to step 18 by both; the four losses agree within
    f32 tolerance. The two packages' MANIFESTs name the same leaves, with
    the same shapes, dtypes and chunk plans."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    run = {"ref": lambda a: jtrain.main(SMOKE_ARGS + a),
           "port": lambda a: ttrain.main(SMOKE_ARGS + ["--device", "cpu"] + a)}
    root = tmp_path / "root"
    run[writer](["--steps", "14", "--ckpt-dir", str(root), "--ckpt-every", "14"])
    resumed = {}
    for pkg in ("ref", "port"):
        shutil.copytree(root, tmp_path / pkg)
        resumed[pkg] = run[pkg](["--steps", "18", "--ckpt-dir", str(tmp_path / pkg),
                                 "--ckpt-every", "18"])["losses"]
    assert len(resumed["port"]) == len(resumed["ref"]) == 4
    np.testing.assert_allclose(resumed["port"], resumed["ref"], rtol=LOSS_RTOL)
    a, b = _manifest(tmp_path / "ref", 18), _manifest(tmp_path / "port", 18)
    assert sorted(a["leaves"]) == sorted(b["leaves"])
    assert {"params/embed", "opt/step", "opt/m/blocks/0/wq", "opt/v/final_norm"} <= set(a["leaves"])
    for key, ea in a["leaves"].items():
        eb = b["leaves"][key]
        for field in ("shape", "dtype", "nbytes", "file", "chunk_bytes"):
            assert ea[field] == eb[field], (key, field)
        assert [(c["offset"], c["length"]) for c in ea["chunks"]] == \
            [(c["offset"], c["length"]) for c in eb["chunks"]], key


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_train_and_serve_on_the_card(tmp_path):
    """The launchers on the card at the smoke size, in f32: a checkpoint the
    CPU run saved at step 4 resumes on the card with the CPU run's losses
    of steps 5-6 (rtol 1e-3: the card sums its matmuls in another order),
    the restore launches the digest kernels, and greedy decoding of the
    same weights gives the CPU's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import build_model
    from repro_torch.kernels import checksum as ck
    from repro_torch.launch import serve, train

    first = train.main(SMOKE_ARGS + ["--device", "cpu", "--steps", "6",
                                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    ck.reset_launch_counts()
    again = train.main(SMOKE_ARGS + ["--device", "cuda", "--steps", "6",
                                     "--ckpt-dir", str(tmp_path)])
    np.testing.assert_allclose(again["losses"], first["losses"][4:], rtol=1e-3)
    counts = ck.launch_counts()
    assert counts["checksum_words"] + counts["checksum_many_words"] > 0
    argv = ["--arch", "gemma2-2b", "--smoke", "--batch", "2", "--prompt-len", "6", "--gen", "8"]
    assert serve.main(argv + ["--device", "cuda"]).shape == (2, 14)
    m = build_model("gemma2-2b", smoke=True)
    params = m.init_params(0, "cpu")
    prompts = serve.prompts_for(0, 2, 6, m.cfg.vocab, "cpu")
    on_card = serve.generate(m, tadamw.tree_map(lambda t: t.cuda(), params), prompts.cuda(), 8, 14)
    assert torch.equal(on_card.cpu(), serve.generate(m, params, prompts, 8, 14))
