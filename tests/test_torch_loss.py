"""The port's training loss and its gradients against the JAX package:
``repro_torch.models.model.loss_fn`` (next-token cross-entropy under
``loss_mask``, plus ``router_aux_loss_coef`` times the MoE load-balance
loss summed over the layers) and ``torch.autograd.grad`` of it over every
parameter, against ``jax.value_and_grad(repro.models.model.loss_fn)``,
with the JAX params carried over by ``params_from_jax`` and the JAX
gradient tree carried the same way.  One reduced config per block kind:
``"attn"`` (stablelm-1.6b, with a loss mask), ``"swa"`` (gemma3-12b's 5:1
pattern, 100 positions past its 64-key window), ``"moe"`` (olmoe-1b-7b),
``"swa_moe"`` (a ``("swa_moe", "moe")`` pattern over a 16-key window),
``"rwkv6"``, ``"mamba2"`` with ``"shared_attn"`` (zamba2-2.7b at 12 layers:
the shared block's gradient is the sum over its two positions), M-RoPE
with streams that differ (qwen2-vl-2b) and embedding inputs
(musicgen-large).  Both packages checkpoint each group in train mode, so
the gradients are those of the recomputed forward.

Inputs are numpy draws from a seed, handed to both.  Tolerances, both
sides f32 on the CPU: the loss and ``ce`` within ``LOSS_TOL`` = 1e-5
relative (the logits drift by ~2e-6 across the stack, as
``tests/test_torch_archs.py`` measures), ``aux`` within 1e-6 absolute
(``tests/test_torch_moe.py``'s), each parameter's gradient within
``GRAD_TOL`` = 1e-4 in relative Frobenius norm (XLA and ATen order the
backward's sums differently; measured at most 2.5e-5, zamba2's SSD).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.model import loss_fn as jax_loss_fn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import forward, loss_fn  # noqa: E402

LOSS_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
B = 2

# name: (config id, reduced(...) kwargs, sequence length, replace(...))
CASES = {
    "attn": ("stablelm-1.6b", dict(num_layers=2, d_model=128), 32, {}),
    "swa": ("gemma3-12b", dict(num_layers=6, d_model=128), 100, {}),
    "moe": ("olmoe-1b-7b", dict(num_layers=2, d_model=128), 32, {}),
    "swa_moe": ("olmoe-1b-7b", dict(num_layers=2, d_model=128), 40,
                dict(block_pattern=("swa_moe", "moe"), sliding_window=16)),
    "rwkv6": ("rwkv6-1.6b", dict(num_layers=2, d_model=128), 32, {}),
    "mamba2_shared": ("zamba2-2.7b", dict(num_layers=12, d_model=128), 32,
                      {}),
    "mrope": ("qwen2-vl-2b", dict(num_layers=2, d_model=128), 32, {}),
    "embeds": ("musicgen-large", dict(num_layers=2, d_model=128), 32, {}),
}

_JGRAD = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True),
                 static_argnums=(1,))


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


def _configs(case):
    name, kw, _, rep = CASES[case]
    return (dataclasses.replace(jax_get_config(name).reduced(**kw), **rep),
            dataclasses.replace(get_config(name).reduced(**kw), **rep))


def _batch(cfg, s, seed, *, mask=False):
    """Numpy inputs: tokens (or embeds), labels, M-RoPE positions whose
    three streams differ, and a 0 / 1 loss mask."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, s + 1))
    b = {"labels": toks[:, 1:].astype(np.int32)}
    if cfg.embedding_inputs:
        b["embeds"] = (rng.standard_normal((B, s, cfg.d_model))
                       * 0.02).astype(np.float32)
    else:
        b["tokens"] = toks[:, :-1].astype(np.int32)
    if cfg.use_mrope:
        b["positions"] = np.stack([np.arange(s)[None].repeat(B, 0) // d
                                   for d in (1, 2, 3)]).astype(np.int32)
    if mask:
        b["loss_mask"] = (rng.random((B, s)) < 0.7).astype(np.float32)
    return b


def _loss_and_grads(case, seed=0):
    jc, tc = _configs(case)
    s = CASES[case][2]
    assert not (jc.sliding_window and "swa" in case) or \
        s > jc.sliding_window
    params = jax_init_params(jc, jax.random.PRNGKey(seed))
    nb = _batch(jc, s, seed, mask=case == "attn")
    (jl, jparts), jg = _JGRAD(params, jc, {k: jnp.asarray(v)
                                           for k, v in nb.items()})
    model = params_from_jax(jax.tree.map(np.asarray, params), tc,
                            device="cpu")
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    loss, parts = loss_fn(model, tb)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    want = params_from_jax(jax.tree.map(np.asarray, jg), tc, device="cpu")
    return (float(jl), {k: float(v) for k, v in jparts.items()}, want), \
        (loss, parts, grads, model)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_jax(case):
    (jl, jparts, want), (loss, parts, grads, model) = \
        _loss_and_grads(case)
    assert loss.shape == () and loss.dtype == torch.float32
    assert abs(float(loss.detach()) - jl) <= LOSS_TOL * abs(jl)
    assert abs(float(parts["ce"].detach()) - jparts["ce"]) <= \
        LOSS_TOL * jparts["ce"]
    assert abs(float(parts["aux"].detach()) - jparts["aux"]) <= AUX_TOL
    assert (float(parts["aux"].detach()) > 0) == ("moe" in case)
    names = [n for n, _ in model.named_parameters()]
    ref = dict(want.named_parameters())
    assert len(names) == len(grads) == len(ref)
    for name, g in zip(names, grads):
        r = ref[name]
        assert g.shape == r.shape, name
        err = float(torch.linalg.norm(g - r)) / max(
            float(torch.linalg.norm(r)), 1e-30)
        assert err <= GRAD_TOL, (name, err)


def test_shared_block_gradient_sums_its_positions():
    """zamba2's one ``"shared_attn"`` block stands at layers 5 and 11: one
    parameter set, and its gradient is nonzero and the JAX tree's
    ``shared`` entry (compared in the parity case above)."""
    _, (_, _, grads, model) = _loss_and_grads("mamba2_shared")
    assert model.blocks[5] is model.blocks[11]
    shared = {id(p) for p in model.blocks[5].parameters()}
    got = [g for p, g in zip(model.parameters(), grads) if id(p) in shared]
    assert len(got) == len(list(model.blocks[5].parameters()))
    assert all(float(g.abs().max()) > 0 for g in got)


def test_forward_refuses_what_the_port_lacks():
    _, tc = _configs("attn")
    model = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(_configs("attn")[0],
                                    jax.random.PRNGKey(0))), tc,
        device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="item 5"):
        forward(model, batch, dist=object())
    with pytest.raises(NotImplementedError, match="item 3"):
        forward(model, batch, compute_dtype=torch.bfloat16)
    logits, aux = forward(model, batch)
    assert logits.shape == (1, 4, tc.vocab_size) and float(aux) == 0.0
