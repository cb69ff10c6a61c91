"""The port's RNG (raft_tpu_torch.random) against the reference's, on the
CPU.

The PCG32 stream is held bit for bit to the reference's native library
(``raft_tpu.native.pcg32_uniform``) and to its ``uniform`` on a PCG state.
A ``torch.Generator`` cannot reproduce threefry, so every other
distribution is held to its law: at 200,000 draws its mean and variance
lie within six standard errors (√(σ²/N) for the mean, √((m₄ − s⁴)/N) for
the variance, m₄ the sample's fourth moment) of the law's, and the
reference's own draws pass the same test. The exact invariants are exact:
shapes, dtypes, [low, high), permutations, samples without repeats or
zero weights, and the PCG refusal.
"""

import math

import numpy as np
import pytest
import torch

from raft_tpu import native
from raft_tpu import random as jr
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu_torch import random as tr
from raft_tpu_torch.core import DeviceResources

from _torch_threads import one_torch_thread  # noqa: F401

RES = DeviceResources(device="cpu", seed=5)
JRES = JaxResources(seed=0)
N = 200_000


def _moments_ok(x, mean, var):
    x = np.asarray(x, np.float64).ravel()
    m, v = x.mean(), x.var(ddof=1)
    m4 = ((x - m) ** 4).mean()
    assert abs(m - mean) <= 6 * math.sqrt(var / x.size), (m, mean)
    assert abs(v - var) <= 6 * math.sqrt((m4 - v * v) / x.size), (v, var)


# name: (port call, reference call, law mean, law variance)
_LAWS = {
    "uniform": (lambda s: tr.uniform(RES, s, (N,), -2.0, 3.0),
                lambda k: jr.uniform(JRES, k, (N,), -2.0, 3.0), 0.5, 25 / 12),
    "uniform_int": (lambda s: tr.uniform_int(RES, s, (N,), 0, 10),
                    lambda k: jr.uniform_int(JRES, k, (N,), 0, 10), 4.5,
                    99 / 12),
    "normal": (lambda s: tr.normal(RES, s, (N,), 1.0, 2.0),
               lambda k: jr.normal(JRES, k, (N,), 1.0, 2.0), 1.0, 4.0),
    "normal_int": (lambda s: tr.normal_int(RES, s, (N,), 10.0, 3.0),
                   lambda k: jr.normal_int(JRES, k, (N,), 10.0, 3.0), 10.0,
                   9.0 + 1 / 12),
    "lognormal": (lambda s: tr.lognormal(RES, s, (N,), 0.0, 0.5),
                  lambda k: jr.lognormal(JRES, k, (N,), 0.0, 0.5),
                  math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25)),
    "gumbel": (lambda s: tr.gumbel(RES, s, (N,), 0.5, 2.0),
               lambda k: jr.gumbel(JRES, k, (N,), 0.5, 2.0),
               0.5 + 2.0 * 0.5772156649, math.pi ** 2 * 4 / 6),
    "logistic": (lambda s: tr.logistic(RES, s, (N,), 1.0, 0.5),
                 lambda k: jr.logistic(JRES, k, (N,), 1.0, 0.5), 1.0,
                 math.pi ** 2 * 0.25 / 3),
    "exponential": (lambda s: tr.exponential(RES, s, (N,), 2.0),
                    lambda k: jr.exponential(JRES, k, (N,), 2.0), 0.5, 0.25),
    "rayleigh": (lambda s: tr.rayleigh(RES, s, (N,), 1.5),
                 lambda k: jr.rayleigh(JRES, k, (N,), 1.5),
                 1.5 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 2.25),
    "laplace": (lambda s: tr.laplace(RES, s, (N,), -1.0, 0.5),
                lambda k: jr.laplace(JRES, k, (N,), -1.0, 0.5), -1.0, 0.5),
    "bernoulli": (lambda s: tr.bernoulli(RES, s, (N,), 0.3),
                  lambda k: jr.bernoulli(JRES, k, (N,), 0.3), 0.3, 0.21),
    "scaled_bernoulli": (
        lambda s: tr.scaled_bernoulli(RES, s, (N,), 0.3, 2.0),
        lambda k: jr.scaled_bernoulli(JRES, k, (N,), 0.3, 2.0), 0.8, 3.36),
    "discrete": (lambda s: tr.discrete(RES, s, (N,), [1.0, 0, 2, 3, 0, 4]),
                 lambda k: jr.discrete(JRES, k, (N,), [1.0, 0, 2, 3, 0, 4]),
                 3.3, 13.5 - 3.3 ** 2),
}


@pytest.mark.parametrize("name", sorted(_LAWS))
def test_distribution_matches_its_law_as_the_reference_does(name):
    port, ref, mean, var = _LAWS[name]
    x = port(tr.RngState(11))
    assert tuple(x.shape) == (N,) and x.device.type == "cpu"
    _moments_ok(x.numpy(), mean, var)
    _moments_ok(np.asarray(ref(jr.RngState(11))), mean, var)


def test_dtypes_and_ranges():
    assert tr.uniform(RES, 1, (4, 5)).dtype == torch.float32
    assert tr.uniform(RES, 1, (4,), dtype=torch.float64).dtype == \
        torch.float64
    u = tr.uniform(RES, 2, (N,), 3.0, 3.0 + 2 ** -20)
    assert bool((u >= 3.0).all() and (u < 3.0 + 2 ** -20).all())
    k = tr.uniform_int(RES, 3, (N,), -4, 3)
    assert k.dtype == torch.int32 and int(k.min()) == -4 and int(k.max()) == 2
    assert tr.normal_int(RES, 4, (3,), 0.0, 1.0).dtype == torch.int32
    assert tr.bernoulli(RES, 5, (3,)).dtype == torch.bool
    d = tr.discrete(RES, 6, (400, 50), [0.0, 1.0, 0.0, 1.0])
    assert d.shape == (400, 50) and d.dtype == torch.int32
    assert set(d.unique().tolist()) == {1, 3}       # a zero weight: never
    f = tr.fill(RES, 0, (2, 3), 4.5)
    assert torch.equal(f, torch.full((2, 3), 4.5))
    np.testing.assert_array_equal(f.numpy(), np.asarray(
        jr.fill(JRES, 0, (2, 3), 4.5)))


def test_cauchy_quartiles():
    """Cauchy has no moments: its median and quartiles within six
    standard errors (π·scale/(2√N) at the median)."""
    for x in (tr.cauchy(RES, 7, (N,), 1.0, 2.0).numpy(),
              np.asarray(jr.cauchy(JRES, jr.RngState(7), (N,), 1.0, 2.0))):
        q = np.quantile(x, [0.25, 0.5, 0.75])
        se = math.pi * 2.0 / (2 * math.sqrt(N))
        assert np.all(np.abs(q - [-1.0, 1.0, 3.0]) <= 6 * 2 * se), q


def test_normal_table_columns():
    mu = np.linspace(-1, 1, 8).astype(np.float32)
    sg = np.linspace(0.5, 2.0, 8).astype(np.float32)
    t = tr.normal_table(RES, 8, 50_000, mu, sg)
    assert t.shape == (50_000, 8)
    for j in range(8):
        _moments_ok(t[:, j].numpy(), mu[j], sg[j] ** 2)
    t1 = tr.normal_table(RES, 8, 50_000, mu, sigma=2.0)
    _moments_ok(t1[:, 3].numpy(), mu[3], 4.0)


def test_permute():
    X = torch.randn(1000, 5, generator=torch.Generator().manual_seed(0))
    perm, Xp = tr.permute(RES, 9, X)
    assert perm.dtype == torch.int32
    assert torch.equal(torch.sort(perm.long()).values, torch.arange(1000))
    assert torch.equal(Xp, X[perm.long()])
    p2, none = tr.permute(RES, 9, n=77)
    assert none is None
    assert sorted(p2.tolist()) == list(range(77))
    jperm, _ = jr.permute(JRES, 9, n=77)
    assert sorted(np.asarray(jperm).tolist()) == list(range(77))


def test_sample_without_replacement():
    s = tr.sample_without_replacement(RES, 10, 1000, 300)
    assert s.unique().numel() == 300 and int(s.max()) < 1000
    w = np.random.default_rng(1).uniform(size=1000).astype(np.float32)
    w[::3] = 0.0                            # 333 zero weights, 667 positive
    for seed in range(5):
        s = tr.sample_without_replacement(RES, seed, 1000, 600, weights=w)
        assert s.unique().numel() == 600 and bool((_w(w, s) > 0).all())
        j = np.asarray(jr.sample_without_replacement(JRES, seed, 1000, 600,
                                                     weights=w))
        assert np.unique(j).size == 600 and bool((w[j] > 0).all())
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError):
        tr.sample_without_replacement(RES, 0, 10, 11)


def _w(w, s):
    return torch.from_numpy(w)[s.long()]


def test_weighted_sample_favours_heavy_weights():
    """Gumbel top-k draws by weight: of two halves weighted 1 and 9, a
    1-of-1000 sample falls in the heavy half 90% of the time."""
    w = np.r_[np.ones(500), 9 * np.ones(500)].astype(np.float32)
    heavy = [int(tr.sample_without_replacement(RES, s, 1000, 1,
                                               weights=w)[0]) >= 500
             for s in range(2000)]
    p = np.mean(heavy)
    assert abs(p - 0.9) <= 6 * math.sqrt(0.09 / 2000)


# ---------------------------------------------------------------- PCG
@pytest.mark.parametrize("seed,stream,n", [(7, 0, 1000), (123, 5, 70_001),
                                           (2 ** 40 + 3, 2 ** 33, 131_073),
                                           (0, 0, 1)])
def test_pcg_stream_bit_for_bit(seed, stream, n):
    np.testing.assert_array_equal(tr.pcg32_uint32(seed, n, stream),
                                  native.pcg32_uint32(seed, n, stream=stream))
    np.testing.assert_array_equal(tr.pcg32_uniform(seed, n, stream),
                                  native.pcg32_uniform(seed, n,
                                                       stream=stream))


@pytest.mark.parametrize("low,high", [(0.0, 1.0), (-2.0, 3.0)])
def test_pcg_uniform_matches_the_reference(low, high):
    st = tr.RngState(7, 3, type=tr.GeneratorType.PCG)
    js = jr.RngState(7, 3, type=jr.GeneratorType.PCG)
    got = tr.uniform(RES, st, (300, 7), low, high)
    want = np.asarray(jr.uniform(JRES, js, (300, 7), low, high))
    assert got.shape == (300, 7) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("call", ["normal", "gumbel", "discrete", "permute",
                                  "make_blobs", "make_regression"])
def test_pcg_state_refused_outside_uniform(call):
    st = tr.RngState(1, type=tr.GeneratorType.PCG)
    calls = {
        "normal": lambda: tr.normal(RES, st, (3,)),
        "gumbel": lambda: tr.gumbel(RES, st, (3,)),
        "discrete": lambda: tr.discrete(RES, st, (3,), [1.0, 2.0]),
        "permute": lambda: tr.permute(RES, st, n=4),
        "make_blobs": lambda: tr.make_blobs(RES, st, 10, 2),
        "make_regression": lambda: tr.make_regression(RES, st, 10, 2),
    }
    with pytest.raises(NotImplementedError, match="only supported by"):
        calls[call]()
    with pytest.raises(NotImplementedError, match="only supported by"):
        jr.normal(JRES, jr.RngState(1, type=jr.GeneratorType.PCG), (3,))


# ---------------------------------------------------------------- RngState
def test_rng_state_streams():
    a = tr.uniform(RES, tr.RngState(3), (100,))
    assert torch.equal(a, tr.uniform(RES, tr.RngState(3), (100,)))
    # subsequence 0 draws what the int seed draws
    assert torch.equal(a, tr.uniform(RES, 3, (100,)))
    s = tr.RngState(3)
    child = s.split()
    assert s.base_subsequence == child.base_subsequence == 1
    b = tr.uniform(RES, child, (100,))
    assert not torch.equal(a, b)
    assert s.advance(2).base_subsequence == 3
    assert repr(s) == "RngState(seed=3, base_subsequence=3, type=PHILOX)"
    assert tr.GeneratorType.THREEFRY is tr.GeneratorType.PHILOX
    g = torch.Generator().manual_seed(4)
    assert torch.equal(tr.normal(RES, g, (5,)),
                       tr.normal(RES, torch.Generator().manual_seed(4),
                                 (5,)))
    X, _ = tr.make_blobs(RES, tr.RngState(2), 50, 3)
    assert torch.equal(X, tr.make_blobs(RES, 2, 50, 3)[0])


# ---------------------------------------------------------------- generators
def test_make_regression():
    X, y, w = tr.make_regression(RES, 12, 20_000, 10, n_informative=6,
                                 bias=3.0, noise=0.5)
    assert X.shape == (20_000, 10) and y.shape == (20_000,) and w.shape == (10,)
    assert bool((w[6:] == 0).all() and (w[:6] > 0).all() and (w < 100).all())
    resid = (y.double() - X.double() @ w.double() - 3.0).numpy()
    _moments_ok(resid, 0.0, 0.25)
    _moments_ok(X.numpy(), 0.0, 1.0)
    jX, jy, jw = jr.make_regression(JRES, 12, 20_000, 10, n_informative=6,
                                    bias=3.0, noise=0.5)
    _moments_ok(np.asarray(jy) - np.asarray(jX) @ np.asarray(jw) - 3.0, 0.0,
                0.25)
    X2, y2, w2 = tr.make_regression(RES, 12, 100, 5, n_targets=3)
    assert y2.shape == (100, 3) and w2.shape == (5, 3)
    assert torch.allclose(y2, X2 @ w2, rtol=1e-5, atol=1e-3)


def test_make_regression_low_rank():
    X, _, _ = tr.make_regression(RES, 13, 4000, 30, effective_rank=3,
                                 tail_strength=0.1)
    jX, _, _ = jr.make_regression(JRES, 13, 4000, 30, effective_rank=3,
                                  tail_strength=0.1)
    for M in (X.double().numpy(), np.asarray(jX, np.float64)):
        s = np.linalg.svd(M, compute_uv=False)
        # the spectrum decays like the profile: its tail holds a few % of
        # the energy in both packages
        assert (s[10:] ** 2).sum() / (s ** 2).sum() < 0.05


@pytest.mark.parametrize("method", ["CHOLESKY", "JACOBI"])
def test_multi_variable_gaussian(method):
    g = np.random.default_rng(19)
    d, n = 12, 100_000
    A = g.normal(size=(d, d)) / math.sqrt(d)
    cov = (A @ A.T + np.eye(d)).astype(np.float32)
    mu = g.normal(size=d).astype(np.float32)
    Z = tr.multi_variable_gaussian(
        RES, 20, n, mu, cov, method=getattr(tr.DecompositionMethod,
                                            method)).double().numpy()
    J = np.asarray(jr.multi_variable_gaussian(
        JRES, 20, n, mu, cov, method=getattr(jr.DecompositionMethod,
                                             method)), np.float64)
    S = cov.astype(np.float64)
    sd = np.sqrt((np.outer(np.diag(S), np.diag(S)) + S ** 2) / n)
    for x in (Z, J):
        assert x.shape == (n, d)
        assert np.abs((x.mean(0) - mu) / np.sqrt(np.diag(S) / n)).max() <= 6
        assert np.abs((np.cov(x.T) - S) / sd).max() <= 6
