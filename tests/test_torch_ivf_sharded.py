"""Parity of the port's list-sharded IVF-Flat (raft_tpu_torch.ann.
ShardedIvfIndex, shard_ivf_lists, search_ivf_flat on it) with the
reference's (raft_tpu/ann/ivf_flat.py:1168-1424), on the CPU.

The reference's index is built once and carried across with
``IvfFlatIndex.from_numpy`` (the two k-means draw from different
generators); each package then shards that one index over p ranks (the
reference over ``jax.devices()[:p]``) and searches it. Tolerances are
tests/test_torch_ivf_flat.py's: ids position for position (f32) or as
sets (int8, the reference's int8 contract), values within 1e-5 relative
plus the expanded form's cancellation floor. Against the port's own
unsharded scan the ids are identical and the values bit for bit: a
shard's candidates are rescored by the same row-wise dot.
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu.ann import build_ivf_flat as j_build
from raft_tpu.ann import search_ivf_flat as j_search
from raft_tpu.ann import shard_ivf_lists as j_shard
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu_torch.ann import (IvfFlatIndex, ShardedIvfIndex,
                                search_ivf_flat, shard_ivf_lists)
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.parallel import make_mesh

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_ivf_flat import _assert_same, _blobs, _export

M, D, NQ, K, L, P = 6000, 32, 40, 10, 12, 3


@pytest.fixture(scope="module")
def world():
    X, Q = _blobs(M, D, NQ)
    jres = JaxResources(seed=7)
    jidx = {dt: j_build(jres, X, n_lists=L, max_iter=8, seed=3, db_dtype=dt)
            for dt in ("f32", "int8")}
    tidx = {dt: IvfFlatIndex.from_numpy(_export(j), device="cpu")
            for dt, j in jidx.items()}
    return X, Q, jres, jidx, tidx, DeviceResources(device="cpu")


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("merge", ["allgather", "tournament"])
@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_sharded_ivf_matches_reference(world, p, merge, dt):
    X, Q, jres, jidx, tidx, res = world
    jsh = j_shard(jidx[dt], jmake_mesh({"x": p}, devices=jax.devices()[:p]))
    jv, ji = j_search(jres, jsh, Q, K, n_probes=P, merge=merge)
    sh = shard_ivf_lists(tidx[dt], make_mesh(
        {"x": p}, devices=[torch.device("cpu")] * p))
    assert isinstance(sh, ShardedIvfIndex)
    assert (sh.lists_per, sh.rows_per) == (jsh.lists_per, jsh.rows_per)
    v, i = search_ivf_flat(res, sh, torch.from_numpy(Q), K, n_probes=P,
                           merge=merge)
    _assert_same(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji),
                 dt == "int8", Q, X)
    uv, ui = search_ivf_flat(res, tidx[dt], torch.from_numpy(Q), K,
                             n_probes=P, fine_scan="query")
    assert torch.equal(i, ui) and torch.equal(v, uv)


def test_sharded_layout_matches_reference(world):
    """Every rank's slab, ids and norms, and the list routing, equal the
    reference's sharded arrays."""
    X, Q, jres, jidx, tidx, res = world
    p = 4
    jsh = j_shard(jidx["int8"], jmake_mesh({"x": p},
                                           devices=jax.devices()[:p]))
    sh = shard_ivf_lists(tidx["int8"], make_mesh(
        {"x": p}, devices=[torch.device("cpu")] * p))
    np.testing.assert_array_equal(sh.starts_g.numpy(),
                                  np.asarray(jsh.starts_g))
    np.testing.assert_array_equal(sh.psizes_g.numpy(),
                                  np.asarray(jsh.psizes_g))
    for ours, theirs in (("slab", "slab_s"), ("ids", "ids_s"),
                         ("yy_slab", "yy_s"), ("slab_q", "slab_qs"),
                         ("row_scale", "scale_s"), ("yy_q", "yyq_s"),
                         ("eq_rows", "eq_s")):
        got = torch.cat([s[ours] for s in sh.shards]).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jsh, theirs)),
                                      err_msg=ours)


def test_sharded_exact_plane_and_errors(world):
    """n_probes ≥ n_lists takes the base index's exact plane, sharded or
    not; an unknown merge is refused."""
    X, Q, jres, jidx, tidx, res = world
    sh = shard_ivf_lists(tidx["f32"], make_mesh(
        {"x": 2}, devices=[torch.device("cpu")] * 2))
    v, i = search_ivf_flat(res, sh, torch.from_numpy(Q), K, n_probes=L)
    uv, ui = search_ivf_flat(res, tidx["f32"], torch.from_numpy(Q), K,
                             n_probes=L)
    assert torch.equal(i, ui) and torch.equal(v, uv)
    with pytest.raises(Exception, match="merge"):
        search_ivf_flat(res, sh, torch.from_numpy(Q), K, n_probes=P,
                        merge="host")
