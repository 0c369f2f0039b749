"""The port's training pieces against the JAX package, on the CPU: K1's plain
backward and its counter-based dropout, the towers in train mode, the EMA
fold, the losses, AdamW and the data split.

Inputs are numpy arrays from a seed; weights come from the JAX init through
``convert.state_dict_from_jax``. The JAX side runs at matmul precision
"highest" (tests/conftest.py) and its Pallas attention in interpret mode.
Tolerances are stated beside each check; f32 sums taken in another order
differ by a few ulps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bridgerl_tpu.config import make_experiment as jax_make_experiment
from bridgerl_tpu.data.dataset import split_indices as jax_split_indices
from bridgerl_tpu.models import init_model as jax_init_model
from bridgerl_tpu.models import layers as jax_layers
from bridgerl_tpu.ops.pallas.attention import fused_attention_fn
from bridgerl_tpu.train import checkpoint as jax_ckpt
from bridgerl_tpu.train import losses as jax_losses
from bridgerl_tpu_torch.config import ExperimentConfig
from bridgerl_tpu_torch.convert import state_dict_from_jax
from bridgerl_tpu_torch.data.dataset import split_indices
from bridgerl_tpu_torch.models import init_model, layers
from bridgerl_tpu_torch.ops import attention
from bridgerl_tpu_torch.train import losses
from bridgerl_tpu_torch.train.trainer import make_optimizer

from test_torch_port_model import perturbed

TRAIN_SMALL = dict(window=10, hidden_dim=16, d_model=32, n_tf_layers=2, n_heads=2,
                   ff_dim=64, attn_packing=2)


def fresh_pair(seed=0, perturb_qstats=True, **over):
    """(JAX experiment, JAX model, variables, port model holding the same
    weights), built anew for callers that train the port model."""
    exp = jax_make_experiment("transformer", "hybrid", **{**TRAIN_SMALL, **over})
    jmodel, variables = jax_init_model(exp.model, jax.random.key(seed))
    moved = perturbed(variables, seed)
    if not perturb_qstats:
        moved = {"params": moved["params"], "qstats": variables["qstats"]}
    variables = jax.tree_util.tree_map(np.asarray, moved)
    texp = ExperimentConfig.from_json(exp.to_json())
    model = init_model(texp.model, seed, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, texp.model), strict=True)
    return exp, jmodel, variables, texp, model


# ---------------------------------------------------------------- K1 backward

def _fold(a):
    B, S, H, Dh = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 2, 1, 3).reshape(B * H, S, Dh)


def _unfold(t, B, H):
    BH, S, Dh = t.shape
    return t.reshape(B, H, S, Dh).permute(0, 2, 1, 3).numpy()


def _grads(B, S, H, Dh, packing, rate, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, H, Dh)).astype(np.float32) for _ in range(4))
    bias = layers.attention_bias(packing, S // packing)
    tq, tk, tv = (_fold(a).requires_grad_() for a in (q, k, v))
    s = torch.tensor([1234], dtype=torch.int32)
    out = attention.attention_fwd(tq, tk, tv, bias, Dh ** -0.5, s, rate)
    got = torch.autograd.grad(out, (tq, tk, tv), _fold(do))
    return (q, k, v, do, bias, s), out, got


SHAPES = [(3, 80, 2, 16, 8), (4, 10, 2, 16, 1), (2, 80, 4, 64, 8)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,S,H,Dh,P", SHAPES)
def test_plain_backward_matches_autograd_of_plain_forward(B, S, H, Dh, P, rate):
    """The written-out backward equals autograd through the plain forward
    with the same seed (so the mask is regenerated, not resampled). 1e-5."""
    (q, k, v, do, bias, s), out, got = _grads(B, S, H, Dh, P, rate)
    tq, tk, tv = (_fold(a).requires_grad_() for a in (q, k, v))
    ref_out = attention.packed_attention_reference(tq, tk, tv, bias, Dh ** -0.5, s, rate)
    want = torch.autograd.grad(ref_out, (tq, tk, tv), _fold(do))
    assert torch.equal(out, ref_out.detach())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


@pytest.mark.parametrize("B,S,H,Dh,P", SHAPES)
def test_backward_matches_jax_vjp_of_pallas_kernel(B, S, H, Dh, P):
    """Against jax.vjp of fused_attention_fn in interpret mode, dropout 0:
    1e-5 absolute on N(0, 1) inputs (scale ~1)."""
    (q, k, v, do, bias, _), out, got = _grads(B, S, H, Dh, P, 0.0)
    mask = jax_layers.block_diagonal_mask(P, S // P) if P > 1 else None
    ref, vjp = jax.vjp(lambda a, b, c: fused_attention_fn(a, b, c, mask=mask,
                                                          deterministic=True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_unfold(out.detach(), B, H), np.asarray(ref), atol=2e-6)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_unfold(g, B, H), np.asarray(w), atol=1e-5)


# ---------------------------------------------------------------- Philox dropout

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    assert tuple(int(w) for w in attention.philox4x32(counter, key)) == want


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_keeps_its_share_and_depends_on_seed_and_row(rate):
    BH, S = 64, 80
    m = attention.attention_dropout_mask(7, BH, S, rate)
    n = m.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(m.float().mean().item() - (1 - rate)) < 4 * sigma
    assert torch.equal(m, attention.attention_dropout_mask(7, BH, S, rate))
    assert not torch.equal(m, attention.attention_dropout_mask(8, BH, S, rate))
    assert not torch.equal(m[0], m[1])
    assert attention.keep_threshold(0.1) == int(0.9 * 2 ** 32)


def test_forward_and_backward_use_the_same_mask():
    """With v = I the forward returns p_drop itself, and with do = I the
    backward's dv is p_drop^T: both show the mask of attention_dropout_mask."""
    BH, S, rate = 6, 16, 0.3
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.normal(size=(BH, S, S)).astype(np.float32))
            for _ in range(2))
    eye = torch.eye(S).expand(BH, S, S).contiguous()
    bias = torch.zeros(S, S)
    s = torch.tensor([99], dtype=torch.int32)
    p_drop = attention.attention_fwd(q, k, eye, bias, 0.25, s, rate)
    _, _, dv = attention.attention_bwd(q, k, eye, bias, eye, 0.25, s, rate)
    keep = attention.attention_dropout_mask(99, BH, S, rate)
    assert torch.equal(p_drop > 0, keep)
    assert torch.equal(dv.transpose(1, 2) > 0, keep)
    p = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * 0.25, dim=-1)
    np.testing.assert_allclose(p_drop[keep].numpy(), (p[keep] / (1 - rate)).numpy(),
                               rtol=1e-6)


def test_seed_comes_from_the_generator():
    t = torch.randn(4, 10, 16, generator=torch.Generator().manual_seed(0))
    bias = torch.zeros(10, 10)
    run = lambda s: attention.packed_attention(t, t, t, bias, 0.25, 0.1,
                                               torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="Generator"):
        attention.packed_attention(t, t, t, bias, 0.25, 0.1)
    with pytest.raises(ValueError, match="rate"):
        attention.keep_threshold(1.0)


# ---------------------------------------------------------------- towers

def test_activation_dropout_keeps_and_scales():
    x = torch.ones(200, 500)
    y = layers.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == torch.tensor(1 / 0.9, dtype=torch.float32))
    sigma = (0.09 / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - 0.9) < 4 * sigma
    assert layers.dropout(x, 0.0, None) is x


@pytest.mark.parametrize("packing", [1, 2])
def test_towers_in_train_mode_at_dropout_0_match_jax(packing):
    """train=True with dropout 0 is the JAX train-mode forward (1e-5)."""
    exp, jmodel, variables, _, model = fresh_pair(dropout=0.0, attn_packing=packing)
    x = np.random.default_rng(4).normal(size=(8, 10, 29)).astype(np.float32)
    ref = jmodel.apply(variables, x, method=lambda m, x: m.robot_encoder(x, train=True))
    got = model.robot_encoder(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_towers_in_train_mode_drop_out_reproducibly():
    _, _, _, _, model = fresh_pair(dropout=0.1)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 10, 29)).astype(np.float32))
    run = lambda s: model.robot_encoder(x, train=True,
                                        generator=torch.Generator().manual_seed(s))
    with torch.no_grad():
        a, b, c, ev = run(1), run(1), run(2), model.robot_encoder(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ev)
    with pytest.raises(ValueError, match="Generator"):
        model.robot_encoder(x, train=True)


# ---------------------------------------------------------------- EMA fold

def _rvq_state(variables_or_model, i):
    if isinstance(variables_or_model, dict):
        q = variables_or_model["qstats"]["quantizer"]["rvq"][f"vq_{i}"]
        return tuple(np.asarray(q[k]) for k in ("embedding", "ema_w", "ema_cluster_size"))
    layer = variables_or_model.quantizer.vq.layers[i]
    return tuple(t.numpy() for t in (layer.embedding.weight, layer.ema_w,
                                     layer.ema_cluster_size))


@pytest.mark.parametrize("warm_start", [True, False], ids=["warm", "cold"])
def test_quantizer_train_mode_matches_jax_over_two_calls(warm_start):
    """Two successive train-mode calls: loss, output, and each RVQ layer's
    embedding, ema_w and cluster sizes after each. 1e-5 relative, and 1e-5
    absolute on arrays up to 1 or 1e-5 of the array's largest value beyond:
    a cold start's first fold divides unused codes by ~1e-5, making values
    of ~1e5 whose f32 ulp is ~0.008."""
    _, jmodel, variables, _, model = fresh_pair(ema_warm_start=warm_start,
                                                perturb_qstats=False)
    rng = np.random.default_rng(11)
    for call in range(2):
        z = rng.normal(size=(48, 1, 16)).astype(np.float32)
        (loss, out, metrics), new = jmodel.apply(
            variables, jnp.asarray(z), method=lambda m, z: m.quantizer(z, train=True),
            mutable=["qstats"])
        variables = {"params": variables["params"], "qstats": new["qstats"]}
        t_loss, t_out, t_metrics, _ = model.quantizer(torch.from_numpy(z), train=True)
        np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), rtol=1e-5,
                                   atol=1e-5)
        for k, v in metrics.items():
            np.testing.assert_allclose(t_metrics[k].numpy(), np.asarray(v), rtol=1e-5)
        for i in range(4):
            for got, want, name in zip(_rvq_state(model, i), _rvq_state(variables, i),
                                       ("embedding", "ema_w", "ema_cluster_size")):
                atol = 1e-5 * max(1.0, float(np.abs(want).max()))
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                           err_msg=f"call {call} vq_{i} {name}")


def test_fold_replaces_buffers_and_keeps_the_graph_usable():
    """The fold replaces the buffers (no in-place write), so a loss built
    before a second fold still back-propagates."""
    _, _, _, _, model = fresh_pair()
    vq = model.quantizer.vq.layers[0]
    before = vq.embedding.weight
    z = torch.randn(32, 1, 16, requires_grad=True)
    loss1, _, _, _ = vq(z, train=True)
    loss2, _, _, _ = vq(z * 2, train=True)
    (loss1 + loss2).backward()
    assert vq.embedding.weight is not before and torch.isfinite(z.grad).all()
    assert sorted(vq.state_dict()) == ["ema_cluster_size", "ema_w", "embedding.weight"]


def test_hybrid_rvq_decay_ignores_ema_decay():
    """The hybrid's RVQ folds at 0.99 whatever ema_decay says, as in JAX."""
    z = torch.randn(32, 1, 16, generator=torch.Generator().manual_seed(0))
    folded = []
    for decay in (0.5, 0.99):
        model = fresh_pair(ema_decay=decay)[4]
        model.quantizer(z, train=True)
        folded.append(model.quantizer.vq.layers[0].ema_w)
    assert torch.equal(*folded)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("ref_exact", [True, False])
def test_losses_match_jax(ref_exact):
    """Teacher and student losses and the validation schema: 1e-6 relative."""
    rng = np.random.default_rng(8)
    recon, x = (rng.normal(size=(6, 10, 29)).astype(np.float32) for _ in range(2))
    zh, zr = (rng.normal(size=(6, 1, 16)).astype(np.float32) for _ in range(2))
    lvq = np.float32(0.37)
    T = lambda a: torch.from_numpy(np.asarray(a))
    want = jax_losses.teacher_loss(recon, x, lvq, 1.0, 1.0, 0.5, ref_exact_vel=ref_exact)
    got = losses.teacher_loss(T(recon), T(x), T(lvq), 1.0, 1.0, 0.5, ref_exact_vel=ref_exact)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    want = jax_losses.student_loss(zh, zr, 100.0)
    got = losses.student_loss(T(zh), T(zr), 100.0)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    qm = {"perplexity": np.float32(3.0), "dcr": np.float32(0.5), "rvq_ppl": np.float32(9.0)}
    outs = {"robot": {"recon": recon, "metrics": qm, "z_e": zr},
            "human": {"retargeted": x[::-1].copy(), "z_e": zh}}
    t_outs = {b: {k: (T(v) if not isinstance(v, dict) else {m: T(w) for m, w in v.items()})
                  for k, v in o.items()} for b, o in outs.items()}
    want = jax_losses.eval_metrics(outs, x)
    got = losses.eval_metrics(t_outs, T(x))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_jerk_loss_is_zero_for_short_windows():
    x = torch.ones(2, 3, 4)
    assert losses.jerk_loss(x, x * 2).item() == 0.0


# ---------------------------------------------------------------- AdamW

@pytest.mark.parametrize("mode", ["teacher", "student"])
def test_adamw_matches_optax(mode):
    """Two AdamW steps on seeded gradients against optax.adamw (masked by
    multi_transform + set_to_zero in student mode): trained parameters
    within 1e-6, frozen ones bit-identical."""
    exp, _, variables, texp, model = fresh_pair(mode=mode)
    texp = dataclasses.replace(texp, train=dataclasses.replace(texp.train, mode=mode))
    params = variables["params"]
    tx = optax.adamw(exp.train.learning_rate, weight_decay=exp.train.weight_decay)
    if mode == "student":
        labels = jax.tree_util.tree_map(lambda t: "train" if t else "freeze",
                                        jax_ckpt.trainable_mask(params, "student"))
        tx = optax.multi_transform({"train": tx, "freeze": optax.set_to_zero()}, labels)
    opt_state = tx.init(params)
    opt = make_optimizer(model, texp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(2)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        t_grads = state_dict_from_jax({"params": grads, "qstats": variables["qstats"]},
                                      texp.model)
        for name, p in model.named_parameters():
            p.grad = t_grads[name].clone() if p.requires_grad else None
        opt.step()
    want = state_dict_from_jax({"params": params, "qstats": variables["qstats"]}, texp.model)
    for name, p in model.named_parameters():
        if mode == "student" and not name.startswith("human_encoder."):
            assert not p.requires_grad and torch.equal(p.detach(), before[name]), name
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                       err_msg=name)
    assert len(opt.param_groups[0]["params"]) == sum(
        1 for n, _ in model.named_parameters()
        if mode == "teacher" or n.startswith("human_encoder."))


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("n,frac,seed", [(100, 0.1, 42), (37, 0.25, 0), (1000, 0.1, 7)])
def test_split_indices_equal_jax(n, frac, seed):
    for got, want in zip(split_indices(n, frac, seed), jax_split_indices(n, frac, seed)):
        np.testing.assert_array_equal(got, want)
