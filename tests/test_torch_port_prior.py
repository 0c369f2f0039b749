"""The port's token prior (``bridgerl_tpu_torch/models/token_prior.py``)
against the JAX package's on the CPU, at tiny sizes, with the JAX weights
copied by ``prior_state_dict_from_jax``:

- ``logits``, ``context`` and ``position_logits`` within 1e-5 in float32,
  for every combination of slot-AR and class conditioning; the staged
  logits equal to the full forward's column within 1e-5;
- ``prior_loss`` and ``prior_loss_sums`` within 1e-6;
- ``nucleus_filter``, ``grid_to_codes`` and ``codes_to_grid`` exactly;
- greedy sampling (``top_k=1``): plain, prompted, slot-AR, class-conditioned
  and guided grids equal to JAX's (the Philox-Gumbel draws differ from
  ``jax.random.categorical``'s, but not once one token is left);
- the Philox-Gumbel sampler's slot frequencies on fixed logits within a
  chi-square bound of the softmax; the noise is a function of its counter;
- the bf16 prior (K1's float32 softmax) against JAX's bf16 default
  attention (bf16 softmax): a bound on the gap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgerl_tpu.models import token_prior as jtp
from bridgerl_tpu_torch.convert import prior_state_dict_from_jax
from bridgerl_tpu_torch.models import token_prior as ttp

from test_torch_port_zoo import filled

TINY = jtp.PriorConfig(
    streams=("quantizer/a", "quantizer/b"), vocab_sizes=(7, 5), tokens_per_stream=1,
    window=10, stride=5, d_model=16, n_heads=2, n_layers=2, ff_dim=32, dropout=0.0,
    max_len=8)
VARIANTS = {"plain": {}, "slot_ar": dict(slot_ar=True, depth_layers=1),
            "class": dict(class_names=("walk", "run")),
            "slot_ar_class": dict(slot_ar=True, depth_layers=1, class_names=("walk", "run")),
            # the JAX TokenPrior's own max_len, at a small width: also one training step
            "max_len_256": dict(d_model=32, n_heads=2, ff_dim=64, max_len=256)}
ATOL = 1e-5
# one step of the max_len 256 case: the loss and every gradient against jax.grad of the
# JAX prior's loss (float32; sums over 256 positions in another order)
STEP_LOSS_RTOL, STEP_GRAD_ATOL = 1e-5, 1e-6


def jax_prior(pcfg, seed=0, dtype=jnp.float32):
    """The JAX prior and a variable tree of its shapes filled from a numpy
    seed (an eager ``init`` costs seconds)."""
    model = jtp.MotionTokenPrior(pcfg, dtype=dtype)
    cls = jnp.zeros((2,), jnp.int32) if pcfg.class_names else None
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((2, pcfg.max_len, len(pcfg.vocab_sizes)), jnp.int32),
        class_ids=cls), jax.random.key(seed))
    return model, filled(shapes, seed)


def port_prior(pcfg, variables, dtype="float32"):
    tcfg = ttp.PriorConfig.from_json(pcfg.to_json())
    model = ttp.MotionTokenPrior(tcfg, dtype)
    model.load_state_dict(prior_state_dict_from_jax(variables, tcfg), strict=True)
    return model.eval()


def pair(name, **over):
    pcfg = dataclasses.replace(TINY, **VARIANTS[name], **over)
    jm, jv = jax_prior(pcfg)
    return pcfg, jm, jv, port_prior(pcfg, jv)


def grid_and_classes(pcfg, b=3, seed=0):
    rng = np.random.default_rng(seed)
    g = np.stack([rng.integers(0, v, size=(b, pcfg.max_len)) for v in pcfg.vocab_sizes],
                 axis=-1).astype(np.int32)
    cls = rng.integers(0, len(pcfg.class_names), size=b).astype(np.int32) \
        if pcfg.class_names else None
    return g, cls


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_config_json_is_the_jax_packages():
    pcfg = dataclasses.replace(TINY, **VARIANTS["slot_ar_class"])
    tcfg = ttp.PriorConfig.from_json(pcfg.to_json())
    assert tcfg.to_json() == pcfg.to_json()
    assert jtp.PriorConfig.from_json(tcfg.to_json()) == pcfg
    assert ttp.flatten_vocab_sizes([("a", 7), ("b", 5)], 2) == \
        jtp.flatten_vocab_sizes([("a", 7), ("b", 5)], 2)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_three_modes_match_jax(name):
    pcfg, jm, jv, tm = pair(name)
    g, cls = grid_and_classes(pcfg)
    with torch.no_grad():
        got = tm(_t(g), class_ids=_t(cls))
        ctx = tm(_t(g), class_ids=_t(cls), mode="context")
        t = 4
        staged = tm(mode="position_logits", ctx=ctx[:, t], slots=_t(g[:, t]))
    apply = jax.jit(jm.apply, static_argnames="mode")
    want = apply(jv, _j(g), class_ids=_j(cls))
    want_ctx = apply(jv, _j(g), class_ids=_j(cls), mode="context")
    want_staged = apply(jv, mode="position_logits", ctx=want_ctx[:, t],
                        slots=jnp.asarray(g[:, t]))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=ATOL)
    for s in range(len(pcfg.vocab_sizes)):
        assert got[s].dtype == torch.float32
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]), atol=ATOL)
        np.testing.assert_allclose(staged[s].numpy(), np.asarray(want_staged[s]), atol=ATOL)
        # the staged step is the full forward's column t
        np.testing.assert_allclose(staged[s].numpy(), got[s][:, t].numpy(), atol=ATOL)
    if pcfg.max_len == 256:
        _step_matches_jax(pcfg, jm, jv, tm, g)


def _step_matches_jax(pcfg, jm, jv, tm, g):
    """One training step's loss and gradients (dropout 0) against jax.grad of
    the JAX prior's loss on the same grids and mask, the gradients mapped to
    the port's layout by the same converter as the weights."""
    mask = np.ones(g.shape[:2], np.float32)
    mask[0, 200:] = 0.0
    loss_fn = lambda v: jtp.prior_loss(jm.apply(v, _j(g)), _j(g), _j(mask))  # noqa: E731
    jloss, jgrads = jax.value_and_grad(loss_fn)(jv)
    tcfg = ttp.PriorConfig.from_json(pcfg.to_json())
    want = prior_state_dict_from_jax(jgrads, tcfg)
    tm.train()
    loss = ttp.prior_loss(tm(_t(g), train=True), _t(g), _t(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=STEP_LOSS_RTOL)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(grads) == sorted(want)
    for n, gr in grads.items():
        np.testing.assert_allclose(gr.numpy(), np.asarray(want[n]), atol=STEP_GRAD_ATOL,
                                   err_msg=n)


def test_causality_and_class_required():
    pcfg, _, _, tm = pair("plain")
    g, _ = grid_and_classes(pcfg, b=2)
    g2 = g.copy()
    g2[:, 4:] = (g2[:, 4:] + 1) % 5
    with torch.no_grad():
        a, b = tm(_t(g)), tm(_t(g2))
    for x, y in zip(a, b):
        torch.testing.assert_close(x[:, :5], y[:, :5], atol=1e-6, rtol=1e-5)
        assert not torch.allclose(x[:, 5:], y[:, 5:])
    _, _, _, tc = pair("class")
    with pytest.raises(ValueError, match="class_ids"):
        tc(_t(g))


def test_prior_stacks_pass_causal_and_the_towers_do_not(monkeypatch):
    """Both of the prior's stacks (the backbone and the slot-AR depth stack)
    call K1 with causal=True over whole rows under the causal bias; a
    tower's stack calls it with causal=False."""
    from bridgerl_tpu_torch.models import layers

    calls = []
    real = layers.packed_attention_qkv

    def spy(qkv, heads, bias, scale, dropout_rate=0.0, generator=None, window=None,
            causal=False):
        calls.append((qkv.shape[1], window, causal,
                      torch.equal(bias, layers.causal_bias(qkv.shape[1]))))
        return real(qkv, heads, bias, scale, dropout_rate, generator, window=window,
                    causal=causal)

    monkeypatch.setattr(layers, "packed_attention_qkv", spy)
    pcfg, _, _, tm = pair("slot_ar")
    g, _ = grid_and_classes(pcfg, b=2)
    with torch.no_grad():
        tm(_t(g))
    N, S = pcfg.max_len, len(pcfg.vocab_sizes)
    assert calls == [(N, N, True, True)] * pcfg.n_layers + [(S, S, True, True)]
    calls.clear()
    tower = layers.TransformerStack(1, 16, 2, 32, seq_len=5, packing=2, dropout=0.0)
    tower(torch.zeros(4, 5, 16))
    assert calls == [(10, 5, False, False)]


def test_losses_match_jax():
    pcfg, jm, jv, tm = pair("slot_ar")
    g, _ = grid_and_classes(pcfg, b=4, seed=3)
    mask = np.ones((4, pcfg.max_len), np.float32)
    mask[1, 5:] = 0.0
    mask[3, 2:] = 0.0
    jl = jax.jit(jm.apply)(jv, _j(g))
    with torch.no_grad():
        tl = tm(_t(g))
    js, jw = jtp.prior_loss_sums(jl, _j(g), _j(mask))
    ts, tw = ttp.prior_loss_sums(tl, _t(g), _t(mask))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    assert float(tw) == float(jw)
    np.testing.assert_allclose(float(ttp.prior_loss(tl, _t(g), _t(mask))),
                               float(jtp.prior_loss(jl, _j(g), _j(mask))), rtol=1e-6)


@pytest.mark.parametrize("top_p", [0.3, 0.9, 1.0])
def test_nucleus_filter_equal(top_p):
    lg = np.random.default_rng(5).normal(size=(6, 50)).astype(np.float32) * 2.0
    got = ttp.nucleus_filter(torch.from_numpy(lg), top_p).numpy()
    want = np.asarray(jtp.nucleus_filter(jnp.asarray(lg), top_p))
    np.testing.assert_array_equal(got, want)


def test_grid_codes_round_trip_equal():
    pcfg = dataclasses.replace(TINY, streams=("quantizer/a", "quantizer/b"), tokens_per_stream=2,
                               vocab_sizes=(7, 7, 5, 5))
    grid = np.random.default_rng(3).integers(0, 5, size=(4, 6, 4)).astype(np.int32)
    got = ttp.grid_to_codes(pcfg, torch.from_numpy(grid))
    want = jtp.grid_to_codes(pcfg, jnp.asarray(grid))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = ttp.codes_to_grid(pcfg, got, n_positions=6)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jtp.codes_to_grid(pcfg, want, 6)))


@pytest.mark.parametrize("name", ["plain", "slot_ar", "class"])
def test_greedy_sampling_equals_jax(name):
    pcfg, jm, jv, tm = pair(name)
    cls = np.asarray([0, 1, 1], np.int32) if pcfg.class_names else None
    want = np.asarray(jtp.sample_grids(jm, jv, jax.random.key(7), 3, 6, top_k=1,
                                       class_ids=_j(cls)))
    with torch.no_grad():
        got = ttp.sample_grids(tm, 123, 3, 6, top_k=1, class_ids=_t(cls))
    assert got.dtype == torch.int32 and got.shape == (3, 6, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_prompted_sampling_equals_jax():
    pcfg, jm, jv, tm = pair("plain")
    prompt, _ = grid_and_classes(pcfg, b=1, seed=9)
    prompt = prompt[0, :3]
    want = np.asarray(jtp.sample_grids(jm, jv, jax.random.key(0), 2, 7, top_k=1,
                                       prompt=prompt))
    with torch.no_grad():
        got = ttp.sample_grids(tm, 5, 2, 7, top_k=1, prompt=prompt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :3], np.broadcast_to(prompt, (2, 3, 2)))
    with pytest.raises(ValueError, match="nothing to generate"):
        ttp.sample_grids(tm, 5, 2, 3, prompt=prompt)
    with pytest.raises(ValueError, match="max_len"):
        ttp.sample_grids(tm, 0, 1, 99)


def _decode_pair(W=10):
    """A fixed linear 'decoder' of one position's codes, in both packages."""
    rng = np.random.default_rng(11)
    table = rng.normal(size=(2, 7, W, 3)).astype(np.float32)

    def jax_fn(codes):
        return jnp.asarray(table[0])[codes[:, 0]] + jnp.asarray(table[1])[codes[:, 1]]

    def torch_fn(codes):
        t = torch.from_numpy(table)
        return t[0][codes[:, 0].long()] + t[1][codes[:, 1].long()]

    return jax_fn, torch_fn


@pytest.mark.parametrize("prompted", [False, True])
def test_greedy_guided_sampling_equals_jax(prompted):
    pcfg, jm, jv, tm = pair("slot_ar")
    jfn, tfn = _decode_pair()
    prompt = grid_and_classes(pcfg, b=1, seed=2)[0][0, :2] if prompted else None
    want = np.asarray(jtp.sample_grids_guided(jm, jv, jax.random.key(1), 2, 6, jfn,
                                              candidates=3, top_k=1, prompt=prompt,
                                              dyn_weight=0.2))
    with torch.no_grad():
        got, choices = ttp.sample_grids_guided(tm, 4, 2, 6, tfn, candidates=3, top_k=1,
                                               prompt=prompt, dyn_weight=0.2,
                                               return_choices=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (choices[:, 2 if prompted else 0:] >= 0).all()


def test_guided_selection_keeps_the_most_consistent_candidate():
    """Sampled (not greedy) guided draws: the kept candidate at each position
    is the argmin of the overlap score over the candidates the same noise
    gives, recomputed here from the returned choices."""
    pcfg, _, _, tm = pair("plain")
    _, tfn = _decode_pair()
    C, B, N, seed = 4, 2, 5, 17
    with torch.no_grad():
        grid, choices = ttp.sample_grids_guided(tm, seed, B, N, tfn, candidates=C,
                                                return_choices=True)
        noise = ttp.position_noise(tm, ttp.seed_tensor(seed, "cpu"), N, B * C)
        prev = None
        for t in range(N):
            ctx = tm(grid.long(), mode="context")[:, t].repeat_interleave(C, dim=0)
            cand = ttp.sample_position_slots(tm, ctx, noise[t]).reshape(B, C, 2)
            c = choices[:, t]
            np.testing.assert_array_equal(cand[torch.arange(B), c].numpy(), grid[:, t].numpy())
            wins = tfn(cand.reshape(B * C, 2)).reshape(B, C, 10, -1)
            if prev is None:
                assert (c == 0).all()
            else:
                score = ((wins[:, :, :5] - prev[:, None, 5:]) ** 2).mean(dim=(2, 3))
                np.testing.assert_array_equal(c.numpy(), score.argmin(dim=1).numpy())
            prev = wins[torch.arange(B), c]


def test_gumbel_draws_follow_the_softmax():
    """Slot frequencies of 4,000 draws per row on fixed logits against the
    softmax: chi-square under its 0.999 quantile for each row; the noise of
    one (position, slot, row, token) is the same in any block."""
    from scipy.stats import chi2

    lg = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5], [0.0, 0.0, 0.0, 0.0, 3.0]])
    p = torch.softmax(lg, dim=-1).numpy()
    rows, n = lg.shape[0], 4000
    noise = ttp.gumbel_noise(torch.tensor(42), n, 1, rows, 5)      # n positions
    draws = ttp.draw_tokens(lg.repeat(n, 1), noise[:, 0].reshape(n * rows, 5)).reshape(n, rows)
    for r in range(rows):
        counts = np.bincount(draws[:, r].numpy(), minlength=5)
        stat = float(((counts - n * p[r]) ** 2 / (n * p[r])).sum())
        assert stat < chi2.ppf(0.999, df=4), (r, counts, stat)
    block = ttp.gumbel_noise(torch.tensor(42), 3, 1, 1, 5, start=(7, 0))
    torch.testing.assert_close(block[:, 0, 0], noise[7:10, 0, 0], rtol=0, atol=0)
    other = ttp.gumbel_noise(torch.tensor(43), 3, 1, 1, 5, start=(7, 0))
    assert not torch.equal(block, other)


def test_sampling_is_deterministic_and_in_vocab():
    pcfg, _, _, tm = pair("slot_ar")
    with torch.no_grad():
        a = ttp.sample_grids(tm, 7, 3, 6, temperature=0.9, top_k=3, top_p=0.9)
        b = ttp.sample_grids(tm, 7, 3, 6, temperature=0.9, top_k=3, top_p=0.9)
        c = ttp.sample_grids(tm, 8, 3, 6, temperature=0.9, top_k=3, top_p=0.9)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a[..., 0].max() < 7 and a[..., 1].max() < 5 and a.min() >= 0


def test_bf16_gap_to_jax_default_attention():
    """bf16: the port keeps float32 logits and softmax inside K1 and float32
    heads; JAX's prior runs flax's default attention with a bf16 softmax.
    The float32 logits differ by at most 4% of their scale, and the argmax
    token of at least 90% of (position, slot) pairs is the same."""
    pcfg = dataclasses.replace(TINY, d_model=32, n_heads=2, max_len=8)
    jm, jv = jax_prior(pcfg, dtype=jnp.bfloat16)
    jm16 = jtp.MotionTokenPrior(pcfg, dtype=jnp.bfloat16)
    tm = port_prior(pcfg, jv, dtype="bfloat16")
    g, _ = grid_and_classes(pcfg, b=8, seed=4)
    want = jm16.apply(jv, _j(g))
    with torch.no_grad():
        got = tm(_t(g))
    agree = []
    for s in range(2):
        w = np.asarray(want[s], np.float32)
        assert got[s].dtype == torch.float32 and want[s].dtype == jnp.float32
        scale = np.abs(w).max()
        assert np.abs(got[s].numpy() - w).max() <= 0.04 * scale
        agree.append(got[s].numpy().argmax(-1) == w.argmax(-1))
    assert np.mean(agree) >= 0.9
