"""K7 and K8's plain versions (hashnerf_torch/kernels/packed_encode.py)
against the JAX package's packed_encode and its VJP on the CPU, and the
wrappers' routing and checks. The kernels themselves are held to these
plain versions on the card in test_torch_cuda.py.

Configs: L4 (one dense level, three block-hashed) at F = 1, 2, 4, 8; L8 /
F4 (three dense, five hashed); one with no dense level and one with no
fine level. Point families: snapped onto grid vertices, on the bbox faces,
outside the bbox, and on macro-block boundaries and one float either side.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.ops import packed_grid as jpg
from hashnerf_torch.kernels import launch_counts, reset_launch_counts
from hashnerf_torch.kernels import packed_encode as pe
from hashnerf_torch.ops import packed_grid as tpg

from test_torch_cuda import (
    LEVEL_KINDS, PACKED_CONFIGS as CONFIGS, PACKED_FAMILIES as FAMILIES, packed_config,
    packed_points as points, packed_tables as tables,
)

LO, HI = -1.5, 1.5
U = 2.0**-24


def gamma(n: int) -> float:
    """Bound on the relative error of a float32 sum of n + 1 terms (or a
    dot product of n terms) in any order: n u / (1 - n u)."""
    return n * U / (1 - n * U)


def configs(name):
    return packed_config(name, jpg), packed_config(name)


def _t(a):
    return torch.from_numpy(np.array(a))


BMIN = np.full(3, LO, np.float32)
BMAX = np.full(3, HI, np.float32)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_kernels_match_jax(name, family):
    """K7's plain version against JAX's packed_encode and K8's against its
    VJP, for both tables. Features: each is a float32 dot product of 8
    terms in both (JAX's einsum over 27 slots adds 19 exact zeros), so each
    lies within gamma(8) of the exact and the two within 2 gamma(8) of the
    terms' absolute sum. Gradients: the same products summed in other
    orders (JAX: a segment sum, then 8 shifted adds), within 2 gamma(n + 1)
    of the entry's absolute sum, n the most terms any entry takes."""
    jc, tc = configs(name)
    assert (tc.dense_level_count, len(tc.fine_resolutions)) == LEVEL_KINDS[name]
    tabs = tables(tc, 1)
    x = points(tc, family, 700, 2)
    probe = np.random.default_rng(3).normal(size=(x.shape[0], tc.out_dim)).astype(np.float32)

    (fj, kj), vjp = jax.vjp(lambda t: jpg.packed_encode(t, jnp.asarray(x), jnp.asarray(BMIN),
                                                         jnp.asarray(BMAX), jc),
                            {k: jnp.asarray(v) for k, v in tabs.items()})
    gj = vjp((jnp.asarray(probe), np.zeros(kj.shape, jax.dtypes.float0)))[0]

    args = (_t(x), _t(BMIN), _t(BMAX))
    ft, kt = pe.packed_encode_fwd_plain(_t(tabs["dense"]) if "dense" in tabs else None,
                                        _t(tabs["fine"]) if "fine" in tabs else None, *args, tc)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    if family == "outside":
        assert not kt.numpy().all() and kt.numpy().any()
    elif family == "faces":
        assert kt.numpy().all()
    abs_sum, _ = pe.packed_encode_fwd_plain(_t(np.abs(tabs["dense"])) if "dense" in tabs else None,
                                            _t(np.abs(tabs["fine"])) if "fine" in tabs else None,
                                            *args, tc)
    err = np.abs(ft.numpy() - np.asarray(fj))
    assert (err <= 2 * gamma(8) * abs_sum.numpy()).all(), float((err / abs_sum.numpy()).max())

    d = dict(zip(("dense", "fine"), pe.packed_encode_bwd_plain(*args, _t(probe), tc)))
    a = dict(zip(("dense", "fine"), pe.packed_encode_bwd_plain(*args, _t(np.abs(probe)), tc)))
    _, levels = pe.corner_rows(*args, tc)
    for kind in ("dense", "fine"):
        if kind not in tabs:
            assert d[kind] is None
            continue
        rows = torch.cat([r.reshape(-1) for k, r, _ in levels if k == kind])
        n = int(torch.bincount(rows).max())
        got, want = d[kind].numpy(), np.asarray(gj[kind])
        assert got.shape == want.shape and np.abs(got).max() > 0
        err = np.abs(got - want)
        assert (err <= 2 * gamma(n + 1) * a[kind].numpy() + 1e-30).all(), (kind, float(err.max()))


@pytest.mark.parametrize("name", ["L4_F8", "no_dense", "no_fine"])
def test_packed_encode_on_cpu_takes_plain_routes(name):
    """On CPU tensors: packed_encode is the torch-ops route, and PackedEncode
    (K7 / K8's autograd Function) their plain versions; neither launches a
    kernel, and the two agree."""
    _, tc = configs(name)
    tabs = {k: _t(v) for k, v in tables(tc, 4).items()}
    x = _t(points(tc, "outside", 500, 5))
    g = _t(np.random.default_rng(6).normal(size=(500, tc.out_dim)).astype(np.float32))
    bmin, bmax = _t(BMIN), _t(BMAX)
    reset_launch_counts()

    t_ops = {k: v.clone().requires_grad_(True) for k, v in tabs.items()}
    f_ops, k_ops = tpg.packed_encode(t_ops, x, bmin, bmax, tc)
    (f_ops * g).sum().backward()
    t_ref = {k: v.clone().requires_grad_(True) for k, v in tabs.items()}
    f_ref, _ = tpg.packed_encode_ops(t_ref, x, bmin, bmax, tc)
    (f_ref * g).sum().backward()
    assert torch.equal(f_ops, f_ref)
    for k in tabs:
        assert torch.equal(t_ops[k].grad, t_ref[k].grad)

    t_k = {k: v.clone().requires_grad_(True) for k, v in tabs.items()}
    f_k, k_k = pe.PackedEncode.apply(t_k.get("dense"), t_k.get("fine"), x, bmin, bmax, tc)
    (f_k * g).sum().backward()
    f_p, k_p = pe.packed_encode_fwd_plain(tabs.get("dense"), tabs.get("fine"), x, bmin, bmax, tc)
    d_p = dict(zip(("dense", "fine"), pe.packed_encode_bwd_plain(x, bmin, bmax, g, tc)))
    assert torch.equal(f_k, f_p) and torch.equal(k_k, k_p) and torch.equal(k_k, k_ops)
    for k in tabs:
        assert torch.equal(t_k[k].grad, d_p[k])
        # the same terms as the torch-ops route, summed in other orders
        torch.testing.assert_close(t_k[k].grad, t_ops[k].grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(f_k, f_ops, rtol=1e-5, atol=1e-6)
    assert launch_counts()["packed_encode_fwd"] == 0 and launch_counts()["packed_encode_bwd"] == 0


REFUSALS = ["x_dtype", "table_dtype", "x_strided", "g_strided", "x_shape", "table_shape",
            "g_shape", "two_devices", "meta", "missing_table", "extra_table", "wide_f"]


@pytest.mark.parametrize("bad", REFUSALS)
def test_wrappers_refuse_bad_inputs(bad):
    """The checks come before the device's, so CPU tensors reach each of them."""
    _, tc = configs("L4_F2")
    tabs = {k: _t(v) for k, v in tables(tc, 7).items()}
    x, bmin, bmax = _t(points(tc, "outside", 64, 8)), _t(BMIN), _t(BMAX)
    g = torch.ones((64, tc.out_dim))
    fwd = dict(dense=tabs["dense"], fine=tabs["fine"], x=x, bbox_min=bmin, bbox_max=bmax, cfg=tc)
    bwd = dict(x=x, bbox_min=bmin, bbox_max=bmax, g_feats=g, cfg=tc)
    err = ValueError
    if bad == "x_dtype":
        fwd["x"] = bwd["x"] = x.double()
        err = TypeError
    elif bad == "table_dtype":
        fwd["fine"] = tabs["fine"].half()
        err = TypeError
    elif bad == "x_strided":
        fwd["x"] = bwd["x"] = torch.cat([x, x], dim=1)[:, ::2]
    elif bad == "g_strided":
        bwd["g_feats"] = torch.cat([g, g], dim=1)[:, ::2]
    elif bad == "x_shape":
        fwd["x"] = bwd["x"] = x[:, :2].contiguous()
    elif bad == "table_shape":
        fwd["dense"] = tabs["dense"][:-1]
    elif bad == "g_shape":
        bwd["g_feats"] = g[:, 1:].contiguous()
    elif bad == "two_devices":
        fwd["x"] = bwd["x"] = x.to("meta")
    elif bad == "meta":
        fwd = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in fwd.items()}
        bwd = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in bwd.items()}
    elif bad == "missing_table":
        fwd["dense"] = None
    elif bad == "extra_table":
        _, no_dense = configs("no_dense")
        fwd["cfg"], fwd["dense"] = no_dense, torch.zeros((8, 2))
        fwd["fine"] = torch.zeros(pe.table_shapes(no_dense)[1])
    elif bad == "wide_f":
        wide = tpg.PackedGridConfig(n_levels=2, n_features_per_level=9, log2_hashmap_size=13,
                                    finest_resolution=32, log2_blocks=10)
        fwd["cfg"] = bwd["cfg"] = wide
    if bad not in ("g_strided", "g_shape"):
        with pytest.raises(err):
            pe.packed_encode_fwd(**fwd)
    if bad not in ("table_dtype", "table_shape", "missing_table", "extra_table"):
        with pytest.raises(err):
            pe.packed_encode_bwd(**bwd)
