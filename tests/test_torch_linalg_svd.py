"""Parity of the port's dense linalg (raft_tpu_torch.linalg: QR, the
eigensolvers, the SVD family, randomized SVD, least squares, the Cholesky
rank-1 update, PCA, truncated SVD), its matrix math
(raft_tpu_torch.matrix.math_ops) and its PCA / TruncatedSVD estimators with
the reference's, on the CPU.

Each test draws its inputs from a seed with numpy and passes the same
arrays through both packages. Singular and eigen pairs are defined up to
one sign each, which LAPACK and XLA choose their own way: where the
reference fixes no sign (``svd_qr``, ``eig_dc``) the comparison is up to
that sign, and where it does (PCA, TSVD, ``sign_flip``) the signs must
agree. Test matrices have spectra with relative gaps of at least 1e-3
between the compared values, so the compared vectors are unique.
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu import linalg as jl
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.linalg import rsvd as jrsvd
from raft_tpu.matrix import math_ops as jmo
from raft_tpu.models import PCA as JPCA
from raft_tpu.models import TruncatedSVD as JTSVD
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.linalg import rsvd as trsvd
from raft_tpu_torch.matrix import math_ops as tmo
from raft_tpu_torch.models import PCA, TruncatedSVD

RES = DeviceResources(device="cpu")
JRES = JaxResources(seed=0)


def _spectrum_matrix(m, n, s, seed):
    """A [m, n] f32 matrix with singular values ``s`` (descending, distinct)
    and random singular vectors."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(m, len(s))))
    V, _ = np.linalg.qr(rng.normal(size=(n, len(s))))
    return ((U * s) @ V.T).astype(np.float32)


def _sym(n, seed, gap=True):
    """A symmetric [n, n] f32 matrix; with ``gap`` its eigenvalues are
    1..n apart by at least 1 (relative gap ≥ 1e-3 at n ≤ 64)."""
    rng = np.random.default_rng(seed)
    if not gap:
        a = rng.normal(size=(n, n))
        return ((a + a.T) / 2).astype(np.float32)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.arange(1, n + 1) * rng.choice([-1.0, 1.0], n)
    return ((Q * w) @ Q.T).astype(np.float32)


def _up_to_sign(a, b, atol):
    """Columns of ``a`` equal ``b``'s up to one sign each."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.sign((a * b).sum(0))
    np.testing.assert_allclose(a * s[None, :], b, atol=atol)


def _signed(a):
    return tmo.sign_flip(RES, torch.as_tensor(np.asarray(a))).numpy()


# ---- matrix/math_ops ----

@pytest.mark.parametrize("fn,kw", [
    ("weighted_power", dict(weight=0.5)), ("power", {}),
    ("sqrt", dict(weight=2.0)), ("ratio", {}),
    ("reciprocal", dict(scalar=3.0)), ("reciprocal", dict(set_zero=False)),
    ("zero_small_values", dict(thres=0.3)), ("argmax", {}), ("argmin", {}),
    ("sign_flip", {})])
def test_math_ops_match_reference(fn, kw):
    """To 1e-6 relative (ratio's sum runs in another order; the rest agree
    to the bit); the sign_flip case has a column of zeros, which the
    reference's sign(0) zeroes."""
    rng = np.random.default_rng(3)
    M = rng.normal(size=(9, 6)).astype(np.float32)
    if fn == "sqrt":
        M = np.abs(M)
    M[2, 1] = 0.0
    M[:, 4] = 0.0
    ref = np.asarray(getattr(jmo, fn)(None, M, **kw))
    out = getattr(tmo, fn)(RES, torch.from_numpy(M), **kw).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_cols_per_row_matches_reference(ascending):
    """Stable both ways on tied integer keys: the same permutation."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 4, size=(5, 12)).astype(np.float32)
    vals = rng.normal(size=(5, 12)).astype(np.float32)
    jk, jv = jmo.sort_cols_per_row(None, keys, vals, ascending=ascending)
    tk, tv = tmo.sort_cols_per_row(RES, torch.from_numpy(keys),
                                   torch.from_numpy(vals),
                                   ascending=ascending)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    only = tmo.sort_cols_per_row(RES, torch.from_numpy(keys),
                                 ascending=ascending)
    np.testing.assert_array_equal(only.numpy(), np.asarray(jk))


def test_sample_rows_draws_distinct_rows_from_generator():
    """A subset without replacement, drawn from the generator: the same
    seed draws the same rows (the reference's threefry draw cannot be
    matched; its contract is distinct rows of the input)."""
    M = np.arange(40, dtype=np.float32).reshape(20, 2)
    ref = np.asarray(jmo.sample_rows(JRES, M, 7))
    outs = [tmo.sample_rows(RES, torch.from_numpy(M), 7,
                            generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    for rows in (outs[0].numpy(), ref):
        assert rows.shape == (7, 2)
        assert len(set(rows[:, 0].tolist())) == 7
        assert set(rows[:, 0].tolist()) <= set(M[:, 0].tolist())


# ---- QR, Cholesky ----

def test_qr_matches_reference():
    """R's diagonal up to sign, Q·R = A and QᵀQ = I, to 1e-5."""
    A = np.random.default_rng(5).normal(size=(40, 7)).astype(np.float32)
    jq, jr = jl.qr_get_qr(None, A)
    q, r = tl.qr_get_qr(RES, torch.from_numpy(A))
    np.testing.assert_allclose(np.abs(np.diag(r.numpy())),
                               np.abs(np.diag(np.asarray(jr))), rtol=1e-5)
    np.testing.assert_allclose((q @ r).numpy(), A, atol=1e-5)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(7), atol=1e-5)
    _up_to_sign(tl.qr_get_q(RES, torch.from_numpy(A)).numpy(),
                np.asarray(jq), atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_cholesky_r1_update_matches_reference(k):
    """The expanded factor to 1e-5, and L Lᵀ = A."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(k, k))
    A = (a @ a.T + k * np.eye(k)).astype(np.float32)
    L_prev = np.linalg.cholesky(A[:k - 1, :k - 1]).astype(np.float32) \
        if k > 1 else np.zeros((0, 0), np.float32)
    ref = np.asarray(jl.cholesky_r1_update(None, L_prev, A[:, k - 1]))
    out = tl.cholesky_r1_update(RES, torch.from_numpy(L_prev),
                                torch.from_numpy(A[:, k - 1])).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out @ out.T, A, rtol=1e-4, atol=1e-4)


# ---- eigensolvers ----

def test_eig_dc_and_selective_match_reference():
    """Values to 1e-5 of max |w|, vectors up to sign (eigh fixes none)."""
    A = _sym(24, 7)
    jw, jv = jl.eig_dc(None, A)
    w, v = tl.eig_dc(RES, torch.from_numpy(A))
    scale = np.abs(np.asarray(jw)).max()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5 * scale)
    _up_to_sign(v.numpy(), np.asarray(jv), atol=1e-4)
    for which in ("largest", "smallest"):
        jw, jv = jl.eig_dc_selective(None, A, 5, which=which)
        w, v = tl.eig_dc_selective(RES, torch.from_numpy(A), 5, which=which)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw),
                                   atol=1e-5 * scale)
        _up_to_sign(v.numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 7, 32, 64])
def test_eig_jacobi_matches_reference(n):
    """The same tournament, angles and paired updates: values to 1e-4 of
    max |w| against the reference's own Jacobi and against eigh (odd n
    runs the bye slot); vectors up to sign against the reference's, and
    V Λ Vᵀ = A."""
    A = _sym(n, 8 + n, gap=n > 2)
    jw, jv = jl.eig_jacobi(None, A)
    w, v = tl.eig_jacobi(RES, torch.from_numpy(A))
    scale = max(np.abs(np.asarray(jw)).max(), 1e-30)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-4 * scale)
    np.testing.assert_allclose(w.numpy(),
                               np.linalg.eigvalsh(A.astype(np.float64)),
                               atol=1e-4 * scale)
    if n > 2:
        _up_to_sign(v.numpy(), np.asarray(jv), atol=1e-3)
    v64 = v.numpy().astype(np.float64)
    np.testing.assert_allclose((v64 * w.numpy()) @ v64.T, A,
                               atol=1e-4 * scale)


def test_jacobi_schedule_covers_every_pair_once():
    from raft_tpu.linalg.eig import _round_robin_schedule as jsched
    from raft_tpu_torch.linalg.eig import _round_robin_schedule as tsched

    for n in (2, 7, 10):
        rounds = tsched(n)
        assert rounds == [list(r) for r in jsched(n)]
        pairs = [p for r in rounds for p in r]
        assert sorted(pairs) == [(p, q) for p in range(n)
                                 for q in range(p + 1, n)]


# ---- SVD family ----

S_REF = np.array([9.0, 6.0, 4.0, 2.5, 1.5, 1.0, 0.5, 0.25])


def test_svd_qr_matches_reference():
    """S to 1e-5 relative, U and V up to one sign a pair; the transposed
    variant returns Vᵀ; an unasked factor is None."""
    A = _spectrum_matrix(50, 8, S_REF, 9)
    ju, js, jv = jl.svd_qr(None, A)
    u, s, v = tl.svd_qr(RES, torch.from_numpy(A))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    _up_to_sign(u.numpy(), np.asarray(ju), atol=1e-4)
    _up_to_sign(v.numpy(), np.asarray(jv), atol=1e-4)
    u2, s2, vt = tl.svd_qr_transpose_right_vec(RES, torch.from_numpy(A))
    assert torch.equal(vt.T, v) and torch.equal(s2, s)
    none_u, _, none_v = tl.svd_qr(RES, torch.from_numpy(A),
                                  gen_left_vec=False, gen_right_vec=False)
    assert none_u is None and none_v is None


@pytest.mark.parametrize("fn", ["svd_eig", "svd_jacobi"])
def test_gram_svds_match_reference(fn):
    """Through AᵀA: S to 1e-4 relative; V and U up to one sign a pair.
    A rank-deficient column block checks svd_eig's zeroed U columns."""
    A = _spectrum_matrix(60, 8, S_REF, 10)
    ju, js, jv = getattr(jl, fn)(None, A)
    u, s, v = getattr(tl, fn)(RES, torch.from_numpy(A))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    _up_to_sign(v.numpy(), np.asarray(jv), atol=1e-3)
    _up_to_sign(u.numpy(), np.asarray(ju), atol=1e-3)
    if fn == "svd_eig":
        Z = np.zeros((10, 3), np.float32)
        Z[:, 0] = 1.0
        ju, js, _ = jl.svd_eig(None, Z)
        u, s, _ = tl.svd_eig(RES, torch.from_numpy(Z))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_array_equal(u.numpy()[:, 1:] == 0,
                                      np.asarray(ju)[:, 1:] == 0)


def test_svd_reconstruction_and_evaluation_match_reference():
    A = _spectrum_matrix(30, 8, S_REF, 11)
    u, s, v = tl.svd_qr(RES, torch.from_numpy(A))
    rec = tl.svd_reconstruction(RES, u, s, v).numpy()
    ref = np.asarray(jl.svd_reconstruction(None, u.numpy(), s.numpy(),
                                           v.numpy()))
    np.testing.assert_allclose(rec, ref, atol=1e-5)
    np.testing.assert_allclose(rec, A, atol=1e-4)
    s_cut = s.clone()
    s_cut[-3:] = 0
    for S, pct in ((s, 1e-2), (s_cut, 1e-2), (s_cut, 0.2)):
        assert tl.evaluate_svd_by_percentage(
            RES, torch.from_numpy(A), u, S, v, percent=pct) == \
            jl.evaluate_svd_by_percentage(None, A, u.numpy(), S.numpy(),
                                          v.numpy(), percent=pct)


# ---- randomized SVD ----

RSVD_CASES = [  # (m, n, k, p, n_iters)
    (200, 40, 6, 10, 2), (120, 60, 5, 4, 0), (90, 30, 8, 30, 3)]


def _reference_rsvd(A, k, p, n_iters, seed):
    """The reference's answer and the Gaussian sketch it drew."""
    key = jax.random.key(seed)
    ell = min(k + p, A.shape[1])
    omega = np.asarray(jax.random.normal(key, (A.shape[1], ell), A.dtype))
    return jrsvd.randomized_svd(JRES, A, k, p, n_iters, key=key), omega


@pytest.mark.parametrize("case", range(len(RSVD_CASES)))
def test_rsvd_from_the_reference_sketch(case):
    """Fed the reference's sketch: S to 1e-4 relative, U and V to 1e-3
    after sign_flip."""
    m, n, k, p, n_iters = RSVD_CASES[case]
    s = np.geomspace(20.0, 0.05, min(m, n))
    A = _spectrum_matrix(m, n, s, 12 + case)
    (ju, js, jv), omega = _reference_rsvd(A, k, p, n_iters, case)
    u, s_out, v = trsvd._rsvd_from_sketch(
        torch.from_numpy(A), torch.from_numpy(omega), k, n_iters)
    np.testing.assert_allclose(s_out.numpy(), np.asarray(js), rtol=1e-4)
    np.testing.assert_allclose(_signed(u), _signed(ju), atol=1e-3)
    np.testing.assert_allclose(_signed(v), _signed(jv), atol=1e-3)
    nu, _, nv = trsvd._rsvd_from_sketch(
        torch.from_numpy(A), torch.from_numpy(omega), k, n_iters,
        gen_U=False, gen_V=False)
    assert nu is None and nv is None


def test_randomized_svd_low_rank_as_reference_test():
    """The reference test's case (tests/test_linalg_factorizations.py):
    an exactly rank-5 matrix, the spectrum to 1e-3 and the
    reconstruction to 1e-2 of max |A|, from the handle's generator."""
    rng = np.random.default_rng(0)
    A = (rng.normal(size=(100, 5)) @ rng.normal(size=(5, 40))).astype(
        np.float32)
    s_ref = np.linalg.svd(A, compute_uv=False)
    U, S, V = tl.randomized_svd(RES, torch.from_numpy(A), k=5, p=5,
                                n_iters=3)
    np.testing.assert_allclose(S.numpy(), s_ref[:5], rtol=1e-3)
    recon = (U.numpy() * S.numpy()) @ V.numpy().T
    np.testing.assert_allclose(recon, A, atol=1e-2 * np.abs(A).max())
    # the same generator state draws the same sketch
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a = tl.randomized_svd(RES, torch.from_numpy(A), 5, generator=g1)
    b = tl.randomized_svd(RES, torch.from_numpy(A), 5, generator=g2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("variant", ["fixed_rank", "symmetric", "perc"])
def test_rsvd_variants_match_reference(variant):
    """Each variant with the reference's own arguments: the same rank,
    and S against numpy's SVD at the reference test's 5%."""
    rng = np.random.default_rng(1)
    if variant == "symmetric":
        a = rng.normal(size=(20, 20))
        A = (a @ a.T + 20 * np.eye(20)).astype(np.float32)
        args = dict(k=4)
    elif variant == "fixed_rank":
        A = rng.normal(size=(60, 30)).astype(np.float32)
        args = dict(k=8, p=10, n_iters=4)
    else:
        A = rng.normal(size=(60, 30)).astype(np.float32)
        args = dict(sv_perc=0.2, p_perc=0.3, n_iters=4)
    fn = {"fixed_rank": "rsvd_fixed_rank",
          "symmetric": "rsvd_fixed_rank_symmetric", "perc": "rsvd_perc"}[
        variant]
    _, js, _ = getattr(jl, fn)(JRES, A, **args)
    _, s, _ = getattr(tl, fn)(RES, torch.from_numpy(A), **args)
    s_ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert s.shape == np.asarray(js).shape
    np.testing.assert_allclose(s.numpy(), s_ref[:s.shape[0]], rtol=0.05)


# ---- least squares ----

@pytest.mark.parametrize("solver", ["lstsq_svd_qr", "lstsq_svd_jacobi",
                                    "lstsq_eig", "lstsq_qr"])
def test_lstsq_matches_reference(solver):
    """w to 1e-4 relative of the reference's, on a well-conditioned
    system with a noisy right-hand side."""
    rng = np.random.default_rng(14)
    A = _spectrum_matrix(80, 6, np.array([5.0, 4.0, 3.0, 2.0, 1.5, 1.0]),
                         14)
    b = (A @ rng.normal(size=6) + 0.01 * rng.normal(size=80)).astype(
        np.float32)
    ref = np.asarray(getattr(jl, solver)(None, A, b))
    out = getattr(tl, solver)(RES, torch.from_numpy(A),
                              torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


# ---- PCA, TSVD ----

def _pca_data(seed, n=400, p=12):
    """Rows with distinct per-direction variances (gaps well above 1e-3
    relative) and a non-zero mean."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(p, p)))
    scales = np.linspace(4.0, 0.5, p)
    X = (rng.normal(size=(n, p)) * scales) @ Q.T + rng.normal(size=p) * 3
    return X.astype(np.float32)


@pytest.mark.parametrize("solver", ["COV_EIG_DC", "COV_EIG_JACOBI"])
@pytest.mark.parametrize("whiten", [False, True])
def test_pca_matches_reference(solver, whiten):
    """Components to 1e-4 (both packages sign-flip them), explained
    variance, its ratio and the singular values to 1e-5 relative, the
    mean and noise_vars, transform and inverse_transform."""
    X = _pca_data(15)
    jp = jl.ParamsPCA(n_components=5, whiten=whiten,
                      algorithm=getattr(jl.Solver, solver))
    tp = tl.ParamsPCA(n_components=5, whiten=whiten,
                      algorithm=getattr(tl.Solver, solver))
    jm = jl.pca_fit(None, X, jp)
    tm = tl.pca_fit(RES, torch.from_numpy(X), tp)
    rtol = 1e-5 if solver == "COV_EIG_DC" else 1e-4
    np.testing.assert_allclose(tm.components.numpy(),
                               np.asarray(jm.components), atol=1e-4)
    for f in ("explained_var", "explained_var_ratio", "singular_vals",
              "noise_vars"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=rtol)
    np.testing.assert_allclose(tm.mu.numpy(), np.asarray(jm.mu), rtol=1e-6)
    jt = np.asarray(jl.pca_transform(None, X, jm, jp))
    t = tl.pca_transform(RES, torch.from_numpy(X), tm, tp)
    np.testing.assert_allclose(t.numpy(), jt, atol=1e-3)
    jback = np.asarray(jl.pca_inverse_transform(None, jt, jm, jp))
    back = tl.pca_inverse_transform(RES, t, tm, tp).numpy()
    np.testing.assert_allclose(back, jback, atol=1e-3)


def test_pca_all_components_has_no_noise_variance():
    X = _pca_data(16, p=6)
    jm = jl.pca_fit(None, X, jl.ParamsPCA(n_components=6))
    tm = tl.pca_fit(RES, torch.from_numpy(X), tl.ParamsPCA(n_components=6))
    assert float(tm.noise_vars) == float(np.asarray(jm.noise_vars)) == 0.0


@pytest.mark.parametrize("solver", ["COV_EIG_DC", "COV_EIG_JACOBI"])
def test_tsvd_matches_reference(solver):
    """Components to 1e-4, singular values, explained variance and its
    ratio to 1e-5 relative (1e-4 for Jacobi), transform and inverse."""
    X = _pca_data(17)
    jp = jl.ParamsTSVD(n_components=4, algorithm=getattr(jl.Solver, solver))
    tp = tl.ParamsTSVD(n_components=4, algorithm=getattr(tl.Solver, solver))
    jm = jl.tsvd_fit(None, X, jp)
    tm = tl.tsvd_fit(RES, torch.from_numpy(X), tp)
    rtol = 1e-5 if solver == "COV_EIG_DC" else 1e-4
    np.testing.assert_allclose(tm.components.numpy(),
                               np.asarray(jm.components), atol=1e-4)
    for f in ("explained_var", "explained_var_ratio", "singular_vals"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=rtol)
    jt = np.asarray(jl.tsvd_transform(None, X, jm))
    t = tl.tsvd_transform(RES, torch.from_numpy(X), tm)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        tl.tsvd_inverse_transform(RES, t, tm).numpy(),
        np.asarray(jl.tsvd_inverse_transform(None, jt, jm)), atol=1e-3)


@pytest.mark.parametrize("model", ["PCA", "TruncatedSVD"])
def test_models_match_reference(model):
    """The estimators over the fits above: fitted attributes, fit_transform
    and inverse_transform against the reference's estimator."""
    X = _pca_data(18)
    if model == "PCA":
        j, t = JPCA(3, whiten=True, res=JRES), PCA(3, whiten=True, res=RES)
        attrs = ("components_", "explained_variance_",
                 "explained_variance_ratio_", "singular_values_", "mean_",
                 "noise_variance_")
    else:
        j, t = JTSVD(3, res=JRES), TruncatedSVD(3, res=RES)
        attrs = ("components_", "explained_variance_",
                 "explained_variance_ratio_", "singular_values_")
    jt = np.asarray(j.fit_transform(X))
    tt = t.fit_transform(X)
    assert tt.device.type == "cpu"
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-3)
    for a in attrs:
        np.testing.assert_allclose(getattr(t, a).numpy(),
                                   np.asarray(getattr(j, a)), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(t.inverse_transform(tt).numpy(),
                               np.asarray(j.inverse_transform(jt)),
                               atol=1e-3)
