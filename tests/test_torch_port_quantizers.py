"""The port's nearest-code search (K2's plain version) and quantizers against
the JAX package, on the CPU.

``nearest_codes_plain`` is held against ``nearest_codes_xla`` and against the
Pallas kernel ``nearest_codes_pallas`` in interpret mode (the fixture pattern
of tests/test_pallas_kernel.py): indices exact, counts and dw within 1e-5
(summation order; dw and perplexities also 1e-5 relative, as they reach
~100). ``HybridVQ`` eval outputs, bounded and unbounded FSQ: out, loss and
metrics within 1e-5, code streams exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.experimental import pallas as pl

from bridgerl_tpu.ops import codebook as jax_codebook
from bridgerl_tpu.ops import quantizers as jax_q
from bridgerl_tpu_torch.config import make_experiment
from bridgerl_tpu_torch.ops import codebook, quantizers, vq_kernel

from test_torch_port_model import jax_and_port

ATOL = 1e-5
RTOL = 1e-5   # sums and perplexities near 100 carry f32 ulps of ~1e-5


@pytest.fixture()
def interpreted(monkeypatch):
    """Force pallas_call into interpreter mode and reload the kernel module."""
    import importlib

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)
    from bridgerl_tpu.ops.pallas import vq_kernel as jax_vq_kernel

    importlib.reload(jax_vq_kernel)
    yield jax_vq_kernel
    monkeypatch.setattr(pl, "pallas_call", orig)
    importlib.reload(jax_vq_kernel)


def _data(N, D, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(K, D)).astype(np.float32))


def _assert_codes_equal(got, want):
    i1, c1, d1 = (t.numpy() for t in got)
    i0, c0, d0 = (np.asarray(t) for t in want)
    assert i1.dtype == np.int32
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(c1, c0, atol=ATOL)
    np.testing.assert_allclose(d1, d0, rtol=RTOL, atol=ATOL)


SHAPES = [(1000, 64, 512), (512, 64, 512), (37, 16, 512), (2048, 32, 256), (64, 64, 128)]


@pytest.mark.parametrize("N,D,K", SHAPES)
def test_nearest_codes_plain_matches_xla(N, D, K):
    x, cb = _data(N, D, K)
    _assert_codes_equal(codebook.nearest_codes_plain(torch.from_numpy(x), torch.from_numpy(cb)),
                        jax_codebook.nearest_codes_xla(jnp.asarray(x), jnp.asarray(cb)))


@pytest.mark.parametrize("N,D,K", [(1000, 64, 512), (37, 64, 128)])
def test_nearest_codes_plain_matches_pallas(interpreted, N, D, K):
    x, cb = _data(N, D, K, seed=1)
    _assert_codes_equal(codebook.nearest_codes_plain(torch.from_numpy(x), torch.from_numpy(cb)),
                        interpreted.nearest_codes_pallas(jnp.asarray(x), jnp.asarray(cb)))


def test_nearest_codes_ties_take_the_first_index():
    x = torch.ones(5, 4)
    cb = torch.stack([torch.full((4,), 3.0), torch.ones(4), torch.ones(4), torch.zeros(4)])
    idx, counts, dw = codebook.nearest_codes(x, cb)
    assert idx.tolist() == [1] * 5
    assert counts.tolist() == [0.0, 5.0, 0.0, 0.0]
    assert torch.equal(dw[1], torch.full((4,), 5.0))


def test_nearest_codes_cpu_dispatch_counts_no_launch():
    x, cb = (torch.from_numpy(a) for a in _data(50, 8, 16))
    vq_kernel.launch_counter.reset()
    got = codebook.nearest_codes(x, cb)
    want = codebook.nearest_codes_plain(x, cb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert vq_kernel.launch_counter.count == 0


def test_kernel_wrapper_rejects_cpu_tensors():
    x, cb = (torch.from_numpy(a) for a in _data(8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        vq_kernel.nearest_codes_cuda(x, cb)


def test_quantize_lookup_gathers_rows():
    cb = torch.arange(12.0).reshape(4, 3)
    got = codebook.quantize_lookup(torch.tensor([3, 0, 3], dtype=torch.int32), cb)
    assert torch.equal(got, cb[[3, 0, 3]])


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 40, size=(16, 5)).astype(np.int32)
    counts = np.bincount(idx.reshape(-1), minlength=64).astype(np.float32)
    z, zq = (rng.normal(size=(4, 3, 8)).astype(np.float32) for _ in range(2))
    pairs = [
        (quantizers.unique_count(torch.from_numpy(idx)), jax_q.unique_count(jnp.asarray(idx))),
        (quantizers.perplexity_from_counts(torch.from_numpy(counts)),
         jax_q.perplexity_from_counts(jnp.asarray(counts))),
        (quantizers.dcr_from_counts(torch.from_numpy(counts)),
         jax_q.dcr_from_counts(jnp.asarray(counts))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(
        quantizers.ste(torch.from_numpy(z), torch.from_numpy(zq)).numpy(),
        np.asarray(jax_q.ste(jnp.asarray(z), jnp.asarray(zq))))


def _jax_quantizer(jmodel, variables, z):
    (loss, out, metrics), mods = jmodel.apply(
        variables, jnp.asarray(z), method=lambda m, z: m.quantizer(z, train=False),
        mutable=["intermediates"])
    flat = traverse_util.flatten_dict(mods["intermediates"])
    codes = {"/".join(k[:-1]): np.asarray(v[0]) for k, v in flat.items() if k[-1] == "codes"}
    return loss, out, metrics, codes


@pytest.mark.parametrize("bounded", [True, False], ids=["bounded", "unbounded"])
@pytest.mark.parametrize("tokens", [1, 3])
def test_hybrid_vq_matches_jax(bounded, tokens):
    _, jmodel, variables, _, model = jax_and_port(fsq_bounded=bounded)
    z = np.random.default_rng(21).normal(size=(64, tokens, 16)).astype(np.float32)
    loss, out, metrics, codes = _jax_quantizer(jmodel, variables, z)
    with torch.no_grad():
        t_loss, t_out, t_metrics, t_codes = model.quantizer(torch.from_numpy(z))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(loss), atol=ATOL)
    assert sorted(t_metrics) == sorted(metrics) == ["dcr", "perplexity", "rvq_ppl"]
    for k, v in metrics.items():
        np.testing.assert_allclose(t_metrics[k].numpy(), np.asarray(v), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    got = {f"quantizer/{k}": v.numpy() for k, v in t_codes.items()}
    assert sorted(got) == sorted(codes)
    for k, v in codes.items():
        assert got[k].shape == (64, tokens)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_rvq_residual_chain_is_exact():
    """Each layer quantizes what the previous layers left, and the sum of
    the layers' outputs is the output."""
    _, _, _, _, model = jax_and_port()
    rvq = model.quantizer.vq
    z = torch.from_numpy(np.random.default_rng(2).normal(size=(32, 1, 16)).astype(np.float32))
    with torch.no_grad():
        _, out, metrics, codes = rvq(z)
        residual, total = z, torch.zeros_like(z)
        for layer in rvq.layers:
            _, q, _, _ = layer(residual)
            residual, total = residual - q, total + q
    assert torch.equal(out, total)
    assert sorted(codes) == [f"vq_{i}" for i in range(4)]
    assert 1.0 <= metrics["perplexity"].item() <= 512


def test_vector_quantizer_cold_start_buffers():
    g = torch.Generator().manual_seed(0)
    vq = quantizers.VectorQuantizer(16, 4, warm_start=False, generator=g)
    assert torch.equal(vq.ema_cluster_size, torch.zeros(16))
    assert not torch.equal(vq.ema_w, vq.embedding.weight)
    assert sorted(vq.state_dict()) == ["ema_cluster_size", "ema_w", "embedding.weight"]
    assert list(vq.parameters()) == []


@pytest.mark.parametrize("method", ["ema", "rvq", "fsq", "lfq", "standard", "ae"])
def test_make_quantizer_ports_hybrid_only(method):
    """Every method is ported now: each builds its JAX counterpart's module
    with the config's codebook size, decay, depth and commitment (rvq keeps
    0.25, as the JAX package does)."""
    cfg = make_experiment("transformer", method, window=10, codebook_size=64, n_layers=3,
                          ema_decay=0.9, commitment_cost=0.5, lfq_dim=6).model
    q = quantizers.make_quantizer(cfg, torch.Generator().manual_seed(0))
    if method in ("ema", "standard"):
        assert isinstance(q, quantizers.VectorQuantizer) and q.commitment_cost == 0.5
        assert q.use_ema == (method == "ema") and q.embedding.weight.shape == (64, 64)
        assert (len(list(q.parameters())) == 1) == (method == "standard")
        assert method == "standard" or q.decay == 0.9
    elif method == "rvq":
        assert len(q.layers) == 3 and all(l.decay == 0.9 and l.commitment_cost == 0.25
                                          for l in q.layers)
    elif method == "fsq":
        assert isinstance(q, quantizers.FSQ) and q.bounded
    elif method == "lfq":
        assert isinstance(q, quantizers.LFQ) and q.codebook_dim == 6 and q.norm
    else:
        assert isinstance(q, quantizers.IdentityVQ)


def test_make_quantizer_hybrid_has_512_codes():
    cfg = make_experiment("transformer", "hybrid", window=10, codebook_size=1024).model
    q = quantizers.make_quantizer(cfg, torch.Generator().manual_seed(0))
    assert [l.embedding.weight.shape for l in q.vq.layers] == [(512, 64)] * 4
    assert q.fsq.levels == (8, 5, 5, 5) and q.fsq.bounded
