"""The encode backwards' contracts on the inputs K6's and K8's designs turn
on: cotangents with exactly-zero rows (the kernels skip those lanes) and
points clipped onto the bbox's faces or lying at its upper corner (hot
rows; b = res at xc = hi, the far side of the voxel grid). On CPU tensors
each wrapper takes its plain version, which the card holds the kernels
to; here the plain versions are held to the JAX package's VJPs
(hash_encode_fast, packed_encode).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.ops import packed_grid as jpg
from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JCfg
from hashnerf_torch.kernels import hash_encode as he
from hashnerf_torch.kernels import packed_encode as pe
from hashnerf_torch.kernels.segment_accum import segment_accumulate_k5_plain

from test_torch_cuda import encode_inputs, packed_config, packed_points, packed_tables

U = 2.0**-24
CASES = ["zero_rows", "faces", "hi"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def zero_rows(g, L, seed):
    """g (N, L*F) with exactly-zero (point, level) rows: every level of the
    first 64 points (two warps) and of the last 33, a third of the others
    at random, half of them -0.0."""
    rng = np.random.default_rng(seed)
    N = g.shape[0]
    rows = g.reshape(N, L, -1).copy()
    zero = rng.random((N, L)) < 1 / 3
    zero[:64] = zero[-33:] = True
    rows[zero] = 0.0
    rows[zero & (rng.random((N, L)) < 0.5)] = -0.0
    return rows.reshape(N, -1)


def clipped(x, lo, hi, case, seed):
    """x with half its points outside the bbox on one to three axes
    ("faces": clipped onto faces, edges and corners) or exactly at hi on one
    to three axes ("hi")."""
    rng = np.random.default_rng(seed)
    x = x.copy()
    n = x.shape[0]
    pick = rng.random(n) < 0.5
    axes = rng.random((n, 3)) < 0.5
    axes[np.arange(n), rng.integers(0, 3, n)] = True
    axes &= pick[:, None]
    far = rng.choice([lo - 1.0, hi + 1.0], (n, 3)) if case == "faces" else np.full((n, 3), hi)
    x[axes] = far[axes].astype(np.float32)
    return x


def _inputs(case, L, F, n, seed, lo, hi, x=None):
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    g = rng.normal(size=(x.shape[0], L * F)).astype(np.float32)
    if case == "zero_rows":
        g = zero_rows(g, L, seed + 1)
    else:
        x = clipped(x, lo, hi, case, seed + 1)
    return x, g


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("F", [2, 8])
def test_k6_plain_matches_jax_vjp(case, F):
    """hash_encode_bwd on CPU tensors (K6's plain version) against the
    table cotangent of jax.vjp(hash_encode_fast), chair's levels (L16 from
    res 16 to 512) at a small table."""
    from hashnerf_tpu.kernels.hash_encode_vjp import hash_encode_fast

    L, log2_T = 16, 12
    table, x, _, bmin, bmax, tcfg = encode_inputs(40, L, log2_T, 16, 512, 600, -1.6, 1.6, F=F)
    x, g = _inputs(case, L, F, 600, 41, -1.6, 1.6, x=x)
    jcfg = JCfg(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_T,
                base_resolution=16, finest_resolution=512)
    jargs = (jnp.asarray(x), jnp.asarray(bmin), jnp.asarray(bmax))
    _, vjp = jax.vjp(lambda t: hash_encode_fast(t, *jargs, jcfg)[0], jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    got = he.hash_encode_bwd(_t(x), _t(bmin), _t(bmax), tcfg.resolutions_tensor("cpu"), _t(g),
                             1 << log2_T)
    # the same corner values summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("F", [2, 8])
def test_k6_zero_rows_add_nothing(F):
    """Skipping the lanes whose cotangent row is zero is exact: the plain
    version's sums without those (level, point) lanes equal, bit for bit,
    its sums with them (a table starts at +0, and adding +-0 leaves a
    float32 sum that started at +0 as it was)."""
    L, log2_T = 16, 12
    _, x, _, bmin, bmax, tcfg = encode_inputs(42, L, log2_T, 16, 512, 600, -1.6, 1.6, F=F)
    _, g = _inputs("zero_rows", L, F, 600, 43, -1.6, 1.6, x=x)
    args = (_t(x), _t(bmin), _t(bmax), tcfg.resolutions_tensor("cpu"), _t(g), 1 << log2_T)
    full = he.hash_encode_bwd(*args)
    ids, vals = he.hash_encode_bwd_expand_plain(*args)
    lanes = torch.from_numpy((g.reshape(600, L, F) != 0).any(axis=-1).T.copy())  # (L, N)
    keep = lanes.reshape(-1).repeat_interleave(8)
    skipped = segment_accumulate_k5_plain(ids[keep], vals[keep], L << log2_T)
    assert bool(~keep.all()) and torch.equal(full.reshape(-1, F), skipped)


def _gamma(n):
    return n * U / (1 - n * U)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["L4_F8", "L8_F4", "no_dense"])
def test_k8_plain_matches_jax_vjp(name, case):
    """packed_encode_bwd on CPU tensors (K8's plain version) against
    jax.vjp(packed_encode) for both tables: the same products summed in
    other orders, within 2 gamma(n + 1) of each entry's absolute sum (n the
    most terms an entry takes)."""
    jc, tc = packed_config(name, jpg), packed_config(name)
    tabs = packed_tables(tc, 44)
    x, g = _inputs(case, tc.n_levels, tc.n_features_per_level, 0, 45, -1.5, 1.5,
                   x=packed_points(tc, "vertices", 700, 46))
    bmin, bmax = np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32)
    (_, kj), vjp = jax.vjp(lambda t: jpg.packed_encode(t, jnp.asarray(x), jnp.asarray(bmin),
                                                        jnp.asarray(bmax), jc),
                           {k: jnp.asarray(v) for k, v in tabs.items()})
    gj = vjp((jnp.asarray(g), np.zeros(kj.shape, jax.dtypes.float0)))[0]
    args = (_t(x), _t(bmin), _t(bmax))
    got = dict(zip(("dense", "fine"), pe.packed_encode_bwd(*args, _t(g), tc)))
    abs_sum = dict(zip(("dense", "fine"), pe.packed_encode_bwd_plain(*args, _t(np.abs(g)), tc)))
    _, levels = pe.corner_rows(*args, tc)
    for kind in ("dense", "fine"):
        if kind not in tabs:
            assert got[kind] is None
            continue
        n = int(torch.bincount(torch.cat([r.reshape(-1) for k, r, _ in levels if k == kind])).max())
        err = np.abs(got[kind].numpy() - np.asarray(gj[kind]))
        assert (err <= 2 * _gamma(n + 1) * abs_sum[kind].numpy() + 1e-30).all(), (kind, float(err.max()))
