"""The port's training path (``repro_torch.train``, ``launch/train.py``,
``examples/torch_train_lm.py``) against the JAX package: AdamW and the
cosine schedule against ``repro.train.optimizer``; three ``train_step``s
of stablelm-1.6b, olmoe-1b-7b and zamba2-2.7b reduced against the JAX
``make_train_step`` (every metric each step, and every parameter's update
over the three); checkpoints written by one package and loaded by the
other, both ways, bitwise; ``synthetic_lm_batch`` equal to the JAX one;
the port's own 40-step overfit of ``tests/test_serving_train.py``; the
launcher and the example at ``--device cpu``.

Tolerances, both sides f32 on the CPU:
- ``LOSS_TOL`` = 1e-5 relative on ``loss`` and ``ce``, 1e-6 absolute on
  ``aux``, ``NORM_TOL`` = 1e-4 relative on ``grad_norm`` (a norm of
  gradients that agree within ``tests/test_torch_loss.py``'s 1e-4); the
  schedule's ``lr`` exactly (the same f32 expression).
- ``UPDATE_TOL`` = 1e-3 relative Frobenius on each parameter's change over
  the three steps (taken at peak_lr 0.3, so steps 1 and 2 move it by ~3e-3
  and 6e-3 an element).  AdamW's first steps divide each gradient by its
  own magnitude, so an element whose gradient is near 0 moves by ~lr
  times the ratio of the two packages' rounding to it; measured at most
  ~2e-4 here.  ``PARAM_TOL`` = 1e-5 absolute on each parameter after
  the steps: an element moves by at most ~lr_1 + lr_2 = 9e-3 (AdamW's
  step is ~lr an element), and the two packages' moves agree to ~1e-3 of
  that (measured 1.1e-6 at worst, two elements of olmoe's experts).
"""
import contextlib
import io
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.train import (  # noqa: E402
    synthetic_lm_batch as jax_synthetic_lm_batch)
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.train import load_checkpoint as jax_load  # noqa: E402
from repro.train import save_checkpoint as jax_save  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa
from repro.train.optimizer import adamw_update as jax_adamw_update  # noqa
from repro.train.optimizer import (  # noqa: E402
    cosine_schedule as jax_cosine_schedule)
from repro.train.train_step import (  # noqa: E402
    make_train_step as jax_make_train_step,
    train_state_init as jax_train_state_init)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.train import synthetic_lm_batch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import (adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule, global_norm,
                               load_checkpoint, make_train_step,
                               save_checkpoint, train_state_init)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, AUX_TOL, NORM_TOL = 1e-5, 1e-6, 1e-4
UPDATE_TOL, PARAM_TOL = 1e-3, 1e-5
STEP_ARCHS = {"stablelm-1.6b": dict(num_layers=2, d_model=128),
              "olmoe-1b-7b": dict(num_layers=2, d_model=128),
              "zamba2-2.7b": dict(d_model=128)}


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's torch ops on one thread, restored after: the models
    here are tiny, and under a parallel test run every worker's
    intra-op threads contend for the same cores (the 40-step overfit
    took 129 s that way, 0.6 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name, **kw):
    return (jax_get_config(name).reduced(**kw),
            get_config(name).reduced(**kw))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------
def test_adamw_matches_the_reference_over_steps():
    """Three updates of the same parameters and gradients (one clipped:
    its norm is 25), moments and parameters, against the reference's."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    tp = [torch.from_numpy(p.copy()) for p in params]
    jst, tst = jax_adamw_init(jp), adamw_init(tp)
    for step, (scale, lr) in enumerate(((10.0, 0.01), (0.1, 0.02),
                                        (1.0, 0.05))):
        grads = [(rng.standard_normal(s) * scale).astype(np.float32)
                 for s in shapes]
        jp, jst, jn = jax_adamw_update(
            {str(i): jnp.asarray(g) for i, g in enumerate(grads)}, jst, jp,
            lr=lr)
        tp, tst, tn = adamw_update([torch.from_numpy(g) for g in grads],
                                   tst, tp, lr=lr)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert tst.count == int(jst.count) == step + 1
        for i in range(len(shapes)):
            for got, want in ((tp[i], jp[str(i)]), (tst.mu[i],
                                                     jst.mu[str(i)]),
                              (tst.nu[i], jst.nu[str(i)])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


def test_adamw_moves_toward_gradient():
    params = [torch.ones((4,))]
    new, st2, gnorm = adamw_update([torch.ones((4,))], adamw_init(params),
                                   params, lr=0.1, weight_decay=0.0)
    assert float(gnorm) == pytest.approx(2.0)
    assert bool((new[0] < 1.0).all()) and new[0] is params[0]
    assert st2.count == 1
    assert float(global_norm([torch.full((2,), 3.0),
                              torch.full((1,), 4.0)])) == pytest.approx(
        float(np.sqrt(34.0)))


def test_cosine_schedule_shape():
    assert cosine_schedule(0, peak_lr=1.0, warmup=10, total=100) == 0.0
    assert cosine_schedule(10, peak_lr=1.0, warmup=10,
                           total=100) == pytest.approx(1.0, abs=1e-2)
    end = cosine_schedule(100, peak_lr=1.0, warmup=10, total=100)
    assert end == pytest.approx(0.1, abs=1e-2)     # floor


@pytest.mark.parametrize("kw", [dict(peak_lr=3e-3, total=60),
                                dict(peak_lr=1.0, warmup=10, total=100),
                                dict(peak_lr=3e-4, warmup=0, total=7)])
def test_cosine_schedule_matches_the_reference(kw):
    for step in (0, 1, 2, 9, 10, 11, 50, 99, 100, 150):
        assert cosine_schedule(step, **kw) == float(
            jax_cosine_schedule(step, **kw)), step


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(STEP_ARCHS))
def test_three_train_steps_match_jax(name):
    jc, tc = _pair(name, **STEP_ARCHS[name])
    params = jax_init_params(jc, jax.random.PRNGKey(0))
    start = _leaves(params)
    jstep = jax.jit(jax_make_train_step(jc, peak_lr=0.3, total_steps=60))
    jstate = jax_train_state_init(params)
    tstate = train_state_init(params_from_jax(
        jax.tree.map(np.asarray, params), tc, device="cpu"))
    tstep = make_train_step(tc, peak_lr=0.3, total_steps=60)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    for step in range(3):
        jstate, jm = jstep(jstate, jax_synthetic_lm_batch(jrng, jc, 2, 25))
        tstate, tm = tstep(tstate, synthetic_lm_batch(trng, tc, 2, 25,
                                                      device="cpu"))
        jm = {k: float(v) for k, v in jm.items()}
        assert tstate.step == step + 1 and tstate.opt.count == step + 1
        assert set(tm) == set(jm) == {"loss", "ce", "aux", "grad_norm",
                                      "lr"}
        assert tm["lr"] == jm["lr"]
        for k in ("loss", "ce"):
            assert abs(tm[k] - jm[k]) <= LOSS_TOL * abs(jm[k]), (step, k)
        assert abs(tm["aux"] - jm["aux"]) <= AUX_TOL
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= \
            NORM_TOL * jm["grad_norm"]
    assert (jm["aux"] > 0) == (name == "olmoe-1b-7b")
    got, want = _leaves(params_to_jax(tstate.model)), _leaves(
        jstate.params)
    for g, w, s in zip(got, want, start):
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL)
        moved = np.linalg.norm(w - s)
        assert moved > 0
        assert np.linalg.norm((g - s) - (w - s)) <= UPDATE_TOL * moved


def test_train_overfits_tiny_batch():
    """``tests/test_serving_train.py``'s case on the port: stablelm-1.6b at
    2 layers and d_model 128, 40 steps of a fixed (2, 33) batch."""
    cfg = get_config("stablelm-1.6b").reduced(num_layers=2, d_model=128)
    state = train_state_init(init_params(cfg, seed=0, device="cpu"))
    step = make_train_step(cfg, peak_lr=3e-3, total_steps=60)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
             "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
    losses = []
    for _ in range(40):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    assert losses[-1] < losses[0] * 0.7, losses[::8]


# ---------------------------------------------------------------------------
# checkpoints across the packages, synthetic batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("olmoe-1b-7b", dict(num_layers=1, d_model=64)),
    ("zamba2-2.7b", dict(num_layers=12, d_model=64)),
    ("stablelm-1.6b", dict(num_layers=2, d_model=64))])
def test_checkpoints_load_across_packages_bitwise(name, kw):
    jc, tc = _pair(name, **kw)
    jparams = jax_init_params(jc, jax.random.PRNGKey(1))
    model = init_params(tc, seed=2, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        jpath, tpath = os.path.join(d, "jax.npz"), os.path.join(d, "pt.npz")
        jax_save(jpath, jparams)
        save_checkpoint(tpath, model)
        with np.load(jpath) as a, np.load(tpath) as b:
            assert a.files == b.files
            assert all(a[f].shape == b[f].shape and a[f].dtype == b[f].dtype
                       for f in a.files)
        if name == "zamba2-2.7b":
            with np.load(tpath) as b:
                assert any(f.startswith("shared/") for f in b.files)
        from_jax = load_checkpoint(jpath, like=model)
        from_port = jax_load(tpath, jparams)
    for got, want in zip(_leaves(params_to_jax(from_jax)),
                         _leaves(jparams)):
        assert np.array_equal(got, want)
    for got, want in zip(_leaves(from_port),
                         _leaves(params_to_jax(model))):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen2-vl-2b",
                                  "musicgen-large"])
def test_synthetic_lm_batch_equals_the_jax_one(name):
    jc, tc = _pair(name)
    want = jax_synthetic_lm_batch(np.random.default_rng(5), jc, 3, 17)
    got = synthetic_lm_batch(np.random.default_rng(5), tc, 3, 17,
                             device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"embeds": torch.float32}.get(
            k, torch.int32 if k != "positions" else torch.int64), k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def test_launch_train_on_the_cpu_writes_a_jax_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            final = train_launch.main(["--device", "cpu", "--steps", "3",
                                       "--batch", "2", "--seq", "32",
                                       "--log-every", "1",
                                       "--checkpoint", path])
        text = out.getvalue()
        assert text.count("step ") == 3 and f"saved params -> {path}" in text
        assert np.isfinite(final)
        jc = jax_get_config("stablelm-1.6b").reduced()
        like = jax_init_params(jc, jax.random.PRNGKey(0))
        loaded = jax_load(path, like)
    assert all(np.isfinite(a).all() for a in _leaves(loaded))
    assert [a.shape for a in _leaves(loaded)] == [
        a.shape for a in _leaves(like)]


def test_example_trains_on_the_cpu():
    import runpy
    mod = runpy.run_path(os.path.join(ROOT, "examples",
                                      "torch_train_lm.py"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        first, last = mod["main"](["--device", "cpu", "--steps", "12",
                                   "--batch", "2", "--seq", "32"])
    assert "training stablelm-1.6b-smoke" in out.getvalue()
    assert np.isfinite(first) and last < first
