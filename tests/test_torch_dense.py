"""The port's dense research path (dgn_tpu_torch/dense) == dgn_tpu.dense on
the same seeded numpy inputs, forward and backward.

  * laplacian (both forms) and component_labels (==);
  * k_lowest_eigvecs on connected and disconnected graphs whose non-null
    spectra are distinct (an eigenvector's sign is the solver's choice:
    columns are compared up to sign);
  * grad_adjacency under every normalisation, with and without add_diag,
    signed and absolute; eig_adjacency; aggregate_eigs of the three types;
  * every registry aggregator, forward and its vector-Jacobian product;
  * the five scalers;
  * DenseDGNTower and DenseDGNLayer with dgn_tpu's flax weights carried
    over by convert.load_jax_params: output and every gradient (towers 1
    and 2, pretrans and posttrans of 2 layers, one eigvec=None case whose
    eigenvectors the port computes itself, against dgn_tpu given its own
    eigenvectors sign-aligned to the port's).

float32 on both sides.  Tolerances: outputs rtol 1e-5 / atol 1e-5 (1e-4 /
1e-5 where a derivative aggregator divides by |v|.max() and a row sum);
gradients rtol 1e-4 / atol 1e-5; eigenvectors atol 1e-4 after sign
alignment.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from grad_checks import assert_live

from dgn_tpu import dense as jdense
from dgn_tpu.dense import aggregators as jagg

from dgn_tpu_torch import dense as tdense
from dgn_tpu_torch.convert import flatten, flax_paths, load_jax_params
from dgn_tpu_torch.dense import aggregators as tagg

torch.set_num_threads(1)

OUT = dict(rtol=1e-5, atol=1e-5)
DIR = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
EIG_ATOL = 1e-4
AVG_D = {"log": 1.3, "lin": 2.0}


def dense_adj(rng, n, p=0.35):
    """Random symmetric 0/1 adjacency, connected by a random spanning
    tree."""
    a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
    for v in range(1, n):
        a[rng.integers(0, v), v] = 1.0
    return a + a.T


def _nonnull_spectrum(a):
    return scipy.linalg.eigh(np.diag(a.sum(1)) - a, eigvals_only=True)[1:]


def two_components(rng, n1=6, n2=5):
    """A block-diagonal graph of two connected parts whose non-null
    eigenvalues are pairwise at least 1e-3 apart (under a degenerate
    spectrum any solver returns a mixed basis)."""
    while True:
        a1, a2 = dense_adj(rng, n1), dense_adj(rng, n2)
        union = np.sort(np.concatenate([_nonnull_spectrum(a1),
                                        _nonnull_spectrum(a2)]))
        if np.diff(union).min() > 1e-3 and union.min() > 1e-3:
            return scipy.linalg.block_diag(a1, a2).astype(np.float32)


def distinct_graph(rng, n):
    """A connected graph whose Laplacian eigenvalues are at least 1e-3
    apart."""
    while True:
        a = dense_adj(rng, n)
        if np.diff(np.sort(_nonnull_spectrum(a))).min() > 1e-3:
            return a


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _align(got, want):
    """got's columns with want's signs."""
    s = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    return got * np.where(s == 0, 1.0, s)


# ------------------------------------------------------------ spectral

@pytest.mark.parametrize("normalize", [False, True])
def test_laplacian(rng, normalize):
    a = np.stack([dense_adj(rng, 9) for _ in range(2)])
    got = tdense.laplacian(torch.from_numpy(a), normalize_L=normalize)
    want = jdense.laplacian(jnp.asarray(a), normalize_L=normalize)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OUT)


def test_component_labels(rng):
    a = scipy.linalg.block_diag(dense_adj(rng, 5), dense_adj(rng, 7),
                                dense_adj(rng, 4)).astype(np.float32)
    perm = rng.permutation(a.shape[0])
    batch = np.stack([a[np.ix_(perm, perm)], dense_adj(rng, 16)])
    got = _np(tdense.component_labels(torch.from_numpy(batch)))
    want = np.asarray(jdense.component_labels(jnp.asarray(batch)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[0])) == 3 and len(np.unique(got[1])) == 1


def test_k_lowest_eigvecs_connected_and_disconnected(rng):
    a = np.stack([two_components(rng), distinct_graph(rng, 11)])
    k = 4
    got = _np(tdense.k_lowest_eigvecs(torch.from_numpy(a), k))
    want = np.asarray(jdense.k_lowest_eigvecs(jnp.asarray(a), k))
    assert got.shape == want.shape == (2, 11, k)
    # disconnected: column 0 zero, each component its own vectors
    np.testing.assert_allclose(got[0, :, 0], 0.0, atol=1e-6)
    for part in (slice(0, 6), slice(6, 11)):
        np.testing.assert_allclose(_align(got[0, part], want[0, part]),
                                   want[0, part], atol=EIG_ATOL)
    np.testing.assert_allclose(_align(got[1], want[1]), want[1],
                               atol=EIG_ATOL)
    assert list(_np(tdense.spectral.null_counts(torch.from_numpy(a)))) \
        == [2, 1]


def test_k_lowest_eigvecs_pads_columns_beyond_n(rng):
    a = distinct_graph(rng, 4)[None]
    got = _np(tdense.k_lowest_eigvecs(torch.from_numpy(a), 6))
    want = np.asarray(jdense.k_lowest_eigvecs(jnp.asarray(a), 6))
    assert got.shape == (1, 4, 6)
    np.testing.assert_allclose(got[..., 4:], 0.0)
    np.testing.assert_allclose(_align(got, want), want, atol=EIG_ATOL)


@pytest.mark.parametrize("add_diag", [True, False])
@pytest.mark.parametrize("norm", ["none", "row-abs", "in-out-field"])
def test_grad_adjacency(rng, norm, add_diag):
    a = np.stack([dense_adj(rng, 10) for _ in range(2)])
    f = rng.normal(size=(2, 10)).astype(np.float32)
    for absolute in (False, True):
        got = tdense.grad_adjacency(torch.from_numpy(a), torch.from_numpy(f),
                                    normalization=norm, add_diag=add_diag,
                                    absolute_adj=absolute)
        want = jdense.grad_adjacency(jnp.asarray(a), jnp.asarray(f),
                                     normalization=norm, add_diag=add_diag,
                                     absolute_adj=absolute)
        np.testing.assert_allclose(_np(got), np.asarray(want), **OUT)


def test_eig_adjacency(rng):
    a = np.stack([dense_adj(rng, 8) for _ in range(3)])
    eigvec = (rng.normal(size=(3, 8, 3)) * 0.3).astype(np.float32)
    for acos in (True, False):
        got = tdense.eig_adjacency(torch.from_numpy(a), [0, 1, 2],
                                   torch.from_numpy(eigvec),
                                   normalization="row-abs", eig_acos=acos)
        want = jdense.eig_adjacency(jnp.asarray(a), [0, 1, 2],
                                    jnp.asarray(eigvec),
                                    normalization="row-abs", eig_acos=acos)
        assert sorted(got) == sorted(want) == [0, 1, 2]
        for k in want:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       **DIR)


@pytest.mark.parametrize("agg_type", ["derivative", "smoothing", "both"])
def test_aggregate_eigs(rng, agg_type):
    a = np.stack([dense_adj(rng, 8) for _ in range(2)])
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    eigvec = (rng.normal(size=(2, 8, 3)) * 0.4).astype(np.float32)
    for self_loop in (False, True):
        got = tdense.aggregate_eigs(torch.from_numpy(x), torch.from_numpy(a),
                                    [0, 1, 2], torch.from_numpy(eigvec),
                                    normalization="row-abs",
                                    agg_type=agg_type, self_loop=self_loop)
        want = jdense.aggregate_eigs(jnp.asarray(x), jnp.asarray(a),
                                     [0, 1, 2], jnp.asarray(eigvec),
                                     normalization="row-abs",
                                     agg_type=agg_type, self_loop=self_loop)
        np.testing.assert_allclose(_np(got), np.asarray(want), **DIR)


# ---------------------------------------------------------- aggregators

def _vjp_pair(tfn, jfn, x, ct):
    """(port output, port dX, dgn_tpu output, dgn_tpu dX) for cotangent
    ct."""
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tfn(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    return _np(out), _np(dx), np.asarray(jout), np.asarray(jdx)


@pytest.mark.parametrize("name", sorted(jagg.AGGREGATORS))
def test_registry_aggregator(rng, name):
    assert set(tagg.AGGREGATORS) == set(jagg.AGGREGATORS)
    a = np.stack([dense_adj(rng, 9), dense_adj(rng, 9)])
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    eigvec = (rng.normal(size=(2, 9, 6)) * 0.4).astype(np.float32)
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    et, ej = torch.from_numpy(eigvec), jnp.asarray(eigvec)
    ct = rng.normal(size=(2, 9, 4 * tagg.total_channels([name]))
                    ).astype(np.float32)
    got, dx, want, jdx = _vjp_pair(
        lambda x_: tagg.AGGREGATORS[name](x_, at, eigvec=et, avg_d=AVG_D),
        lambda x_: jagg.AGGREGATORS[name](x_, aj, eigvec=ej, avg_d=AVG_D),
        x, ct)
    assert got.shape == want.shape == ct.shape
    tol = DIR if name.startswith("dir") else OUT
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(dx, jdx, **GRAD)


@pytest.mark.parametrize("name", ["max", "min", "sum", "softmax",
                                  "softmin", "identity"])
def test_aggregator_on_a_node_without_edges(rng, name):
    """A row and column without edges: max and min give 0 there (not
    +-inf), the others their empty sums."""
    a = dense_adj(rng, 8)
    a[3, :] = a[:, 3] = 0.0
    x = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    ct = rng.normal(size=(1, 8, 3)).astype(np.float32)
    got, dx, want, jdx = _vjp_pair(
        lambda x_: tagg.AGGREGATORS[name](x_, torch.from_numpy(a[None])),
        lambda x_: jagg.AGGREGATORS[name](x_, jnp.asarray(a[None])), x, ct)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **OUT)
    np.testing.assert_allclose(dx, jdx, **GRAD)


def test_aggregate_concatenates_and_counts_channels(rng):
    names = ["mean", "dir2-dx", "dir1-both", "max"]
    assert tagg.total_channels(names) == jagg.total_channels(names) == 6
    assert tagg.eigvecs_needed(names) == 3
    assert tagg.eigvecs_needed(["mean", "dir0"]) == 0
    a = dense_adj(rng, 7)[None]
    x = rng.normal(size=(1, 7, 7, 3)).astype(np.float32)
    eigvec = (rng.normal(size=(1, 7, 3)) * 0.5).astype(np.float32)
    got = tagg.aggregate(names, torch.from_numpy(x), torch.from_numpy(a),
                         eigvec=torch.from_numpy(eigvec), avg_d=AVG_D)
    want = jagg.aggregate(names, jnp.asarray(x), jnp.asarray(a),
                          eigvec=jnp.asarray(eigvec), avg_d=AVG_D)
    np.testing.assert_allclose(_np(got), np.asarray(want), **DIR)


# -------------------------------------------------------------- scalers

@pytest.mark.parametrize("name", sorted(jdense.SCALERS))
def test_scaler(rng, name):
    a = np.stack([dense_adj(rng, 8) for _ in range(2)])
    x = rng.normal(size=(2, 8, 6)).astype(np.float32)
    got = tdense.apply_scaler(name, torch.from_numpy(x), torch.from_numpy(a),
                              AVG_D)
    want = jdense.apply_scaler(name, jnp.asarray(x), jnp.asarray(a), AVG_D)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OUT)


# --------------------------------------------------------------- modules

LAYERS = {
    "tower": dict(cls="tower", aggregators=("mean", "dir1-dx", "max"),
                  scalers=("identity", "amplification")),
    "tower-pre2-post2": dict(cls="tower", aggregators=("sum", "dir1-smooth"),
                             scalers=("identity", "attenuation"),
                             pretrans_layers=2, posttrans_layers=2),
    "layer-towers1": dict(cls="layer", aggregators=("mean", "std",
                                                    "dir1-dx"),
                          scalers=("identity",), towers=1),
    "layer-towers2": dict(cls="layer", aggregators=("mean", "min",
                                                    "dir2-both"),
                          scalers=("identity", "amplification",
                                   "attenuation"), towers=2,
                          pretrans_layers=2, posttrans_layers=2),
    "layer-eigvec-none": dict(cls="layer", aggregators=("mean", "dir1-dx",
                                                        "dir1-smooth"),
                              scalers=("identity", "amplification"),
                              towers=2, eigvec=None),
}


def _modules(case, f_in, f_out):
    kw = dict(LAYERS[case])
    cls = kw.pop("cls")
    kw.pop("eigvec", 0)
    if cls == "tower":
        jm = jdense.DenseDGNTower(out_features=f_out, avg_d=AVG_D, **kw)
        tm = tdense.DenseDGNTower(f_in, f_out, avg_d=AVG_D,
                                  generator=torch.Generator().manual_seed(0),
                                  **kw)
    else:
        jm = jdense.DenseDGNLayer(out_features=f_out, avg_d=AVG_D, **kw)
        tm = tdense.DenseDGNLayer(f_in, f_out, avg_d=AVG_D,
                                  generator=torch.Generator().manual_seed(0),
                                  **kw)
    return jm, tm


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_dense_module_forward_and_gradients(rng, case):
    b, n, f_in, f_out = 2, 9, 6, 8
    a = np.stack([distinct_graph(rng, n) for _ in range(b)])
    x = rng.normal(size=(b, n, f_in)).astype(np.float32)
    ct = rng.normal(size=(b, n, f_out)).astype(np.float32)
    explicit = LAYERS[case].get("eigvec", 0) is not None
    jm, tm = _modules(case, f_in, f_out)
    at = torch.from_numpy(a)
    if explicit:
        eigvec = (rng.normal(size=(b, n, 3)) * 0.4).astype(np.float32)
        e_port = torch.from_numpy(eigvec)
    else:
        # the port solves its own; dgn_tpu gets its own solve, signs
        # aligned to the port's
        e_port = None
        mine = _np(tdense.k_lowest_eigvecs(at, 3))
        theirs = np.asarray(jdense.k_lowest_eigvecs(jnp.asarray(a), 3))
        np.testing.assert_allclose(_align(mine, theirs), theirs,
                                   atol=EIG_ATOL)
        eigvec = _align(theirs, mine).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                        jnp.asarray(a), jnp.asarray(eigvec))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    load_jax_params(tm, params, {})

    def jloss(p, x_):
        out = jm.apply({"params": p}, x_, jnp.asarray(a),
                       jnp.asarray(eigvec))
        return jnp.sum(out * jnp.asarray(ct)), out

    (_, want), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, at, e_port)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(want), **DIR)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), **GRAD)
    want_g = flatten(jax.tree_util.tree_map(np.asarray, jgp))
    paths = flax_paths(dict(tm.named_parameters()))
    assert set(paths.values()) == set(want_g)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want_g[paths[name]],
                                   err_msg=name, **GRAD)
    assert_live([(k, p.grad) for k, p in tm.named_parameters()], want_g)
