"""NeRFSmall's one-kernel forward (kernels/field_mlp.py) on the CPU: its
plain version against NeRFSmall's PyTorch route, its in-order arithmetic,
and the dispatch between the two routes.

The plain version is the PyTorch route's composition without autograd, so
the two are equal bit for bit on the CPU, for bf16 and for float32
operands. The route is taken for a bf16 or float32 net at the kernel's
widths whose call autograd records nothing; every other call (float16 and
float8 nets, a call that takes a gradient) keeps the PyTorch route.
`mlp_fused_points` counts the points the fused route answered.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_torch import kernels
from hashnerf_torch.kernels import field_mlp as fm
from hashnerf_torch.models.factory import EMBED_HASH, ModelConfig, NGPState, query_fn
from hashnerf_torch.models.nerf import NeRFSmall, NeRFSmallConfig
from hashnerf_torch.ops.hash_encoding import HashGridConfig
from hashnerf_torch.utils import profiling
from test_torch_field_query import SHAPES


# the kernel's roundings, and the compute_dtype of a net that has each
ROUNDINGS = {"bf16": (torch.bfloat16, "bfloat16"), "f32": (None, None)}


def _net(dtype="bfloat16", views=True, seed=0, **widths):
    cfg = NeRFSmallConfig(compute_dtype=dtype, input_ch_views=16 if views else 0, **widths)
    return NeRFSmall(cfg, torch.Generator().manual_seed(seed))


def _inputs(R, S, views=True, keep=True, seed=1):
    rng = np.random.default_rng(seed)
    N = R * S
    x = torch.from_numpy(rng.normal(size=(N, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(R, 16)).astype(np.float32)) if views else None
    k = torch.from_numpy(rng.uniform(size=N) < 0.8) if keep else None
    return x, v, k


def _pytorch_route(net, x, views, S, keep):
    """NeRFSmall's PyTorch route: the forward with autograd recording."""
    with torch.enable_grad():
        return net.forward_rays(x, views, S, keep).detach()


def _weights(net):
    return [l.weight for l in [*net.sigma_net, *net.color_net]]


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("keep", [True, False], ids=["keep", "no_keep"])
@pytest.mark.parametrize("views", [True, False], ids=["views", "no_views"])
@pytest.mark.parametrize("R,S", SHAPES)
def test_plain_version_equals_the_pytorch_route(R, S, views, keep, rounding):
    """Bit for bit, for a bf16 and a float32 net, with and without views
    and keep mask; rows outside the keep mask read sigma exactly 0."""
    rnd, dtype = ROUNDINGS[rounding]
    net = _net(dtype, views=views)
    x, v, k = _inputs(R, S, views, keep)
    want = _pytorch_route(net, x, v, S, k)
    with torch.no_grad():
        got = fm.field_mlp_fwd(x, v, S, k, _weights(net), rnd)
        routed = net.forward_rays(x, v, S, k)
    assert got.shape == (R * S, 4) and got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(routed, want)
    if keep:
        assert not k.all() and (got[~k, 3] == 0).all()


# (compute_dtype, grad mode, what requires a gradient) -> whether the fused route runs
DISPATCH = [
    ("bfloat16", "no_grad", "params", True),
    ("bfloat16", "inference_mode", "params", True),
    ("bfloat16", "enable_grad", "nothing", True),
    ("bfloat16", "enable_grad", "params", False),
    ("bfloat16", "enable_grad", "x", False),
    ("bfloat16", "enable_grad", "views", False),
    (None, "no_grad", "params", True),
    (None, "inference_mode", "params", True),
    (None, "enable_grad", "nothing", True),
    (None, "enable_grad", "params", False),
    (None, "enable_grad", "x", False),
    ("float32", "no_grad", "params", True),
    ("float64", "no_grad", "params", True),
    ("float16", "no_grad", "params", False),
    ("float8_e4m3fn", "no_grad", "params", False),
    ("float8_e5m2", "no_grad", "params", False),
]


@pytest.mark.parametrize("dtype,mode,grads,fused", DISPATCH,
                         ids=[f"{d}-{m}-{g}" for d, m, g, _ in DISPATCH])
def test_the_fused_route_runs_only_for_bf16_and_float32_without_a_gradient(dtype, mode, grads,
                                                                           fused, monkeypatch):
    """The route a call takes, its count of mlp_fused_points (N for a fused
    call, else 0), and the same raw as the PyTorch route either way. float32
    and float64 nets run the float32 product (compute_dtype_of: None) and
    so the float32 kernel; float16 and float8 nets keep the PyTorch
    route."""
    net = _net(dtype)
    R, S = 5, 8
    x, v, k = _inputs(R, S, seed=3)
    want = _pytorch_route(net, x, v, S, k)
    for p in net.parameters():
        p.requires_grad_(grads == "params")
    x.requires_grad_(grads == "x")
    v.requires_grad_(grads == "views")
    calls = []
    inner = fm.field_mlp_fwd
    monkeypatch.setattr(fm, "field_mlp_fwd", lambda *a: calls.append(1) or inner(*a))
    kernels.reset_launch_counts()
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "enable_grad": torch.enable_grad}[mode]
    with ctx():
        raw = net.forward_rays(x, v, S, k)
    assert len(calls) == int(fused)
    assert profiling.counters()["mlp_fused_points"] == (R * S if fused else 0)
    assert raw.requires_grad == (mode == "enable_grad" and grads != "nothing")
    assert torch.equal(raw.detach(), want)


@pytest.mark.parametrize("widths", [dict(hidden_dim=32, hidden_dim_color=32),
                                    dict(geo_feat_dim=7), dict(num_layers=3),
                                    dict(num_layers_color=2), dict(input_ch=16),
                                    dict(input_ch_views=9)],
                         ids=lambda w: "-".join(f"{k}{v}" for k, v in w.items()))
def test_other_widths_keep_the_pytorch_route(widths):
    """A bf16 net at widths the kernel was not written for keeps the
    PyTorch route under no_grad, and counts nothing."""
    cfg = NeRFSmallConfig(compute_dtype="bfloat16", **widths)
    net = NeRFSmall(cfg, torch.Generator().manual_seed(4))
    assert not fm.takes(cfg)
    R, S = 3, 4
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(R * S, cfg.input_ch)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(R, cfg.input_ch_views)).astype(np.float32))
    kernels.reset_launch_counts()
    with torch.no_grad():
        raw = net.forward_rays(x, v, S)
    assert raw.shape == (R * S, 4) and profiling.counters()["mlp_fused_points"] == 0


@pytest.mark.parametrize("dtype", ["bfloat16", None, "float16"], ids=["bf16", "f32", "f16"])
def test_a_frames_queries_count_their_fused_points(dtype):
    """query_fn under no_grad, as a frame's chunks and a grid update query:
    a bf16 or float32 state's every point is a fused point
    (mlp_fused_points equals mlp_points), a float16 state's none."""
    cfg = ModelConfig(i_embed=EMBED_HASH, N_importance=8, use_viewdirs=True, packed_layout=True,
                      log2_blocks=10, compute_dtype=dtype,
                      hash_grid=HashGridConfig(n_levels=4, n_features_per_level=8,
                                               log2_hashmap_size=13, base_resolution=4,
                                               finest_resolution=32))
    state = NGPState(cfg, torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (6, 24, 3)).astype(np.float32))
    d = rng.normal(size=(6, 3)).astype(np.float32)
    vd = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    bbox = torch.tensor([[-1.0] * 3, [1.0] * 3])
    kernels.reset_launch_counts()
    with torch.no_grad():
        raw = query_fn(state, pts, vd, bbox, fine=True)
        query_fn(state, pts.reshape(-1, 1, 3), vd.repeat_interleave(24, dim=0), bbox)
    c = profiling.counters()
    assert c["mlp_points"] == 2 * 6 * 24
    assert c["mlp_fused_points"] == (0 if dtype == "float16" else c["mlp_points"])
    # the same raw as the PyTorch route, the keep mask included
    want = query_fn(state, pts, vd, bbox, fine=True).detach()
    assert torch.equal(raw, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_the_wrapper_refuses_what_the_kernel_cannot_take(rounding):
    rnd, dtype = ROUNDINGS[rounding]
    net = _net(dtype)
    x, v, k = _inputs(4, 2)
    ws = _weights(net)
    with pytest.raises(ValueError, match="x"):
        fm.field_mlp_fwd(x[:, :16], v, 2, k, ws, rnd)  # 16 encoded columns
    with pytest.raises(ValueError, match="x"):
        fm.field_mlp_fwd(x[:7], v, 2, k[:7], ws, rnd)  # 7 rows are not 2 samples a ray
    with pytest.raises(ValueError, match="views"):
        fm.field_mlp_fwd(x, v[:3], 2, k, ws, rnd)
    with pytest.raises(ValueError, match="weights"):
        fm.field_mlp_fwd(x, None, 2, k, ws, rnd)  # the colour net's first layer expects views
    with pytest.raises(ValueError, match="weights"):
        fm.field_mlp_fwd(x, v, 2, k, ws[:4], rnd)
    with pytest.raises(ValueError, match="keep"):
        fm.field_mlp_fwd(x, v, 2, k.float(), ws, rnd)
    with pytest.raises(TypeError):
        fm.field_mlp_fwd(x.double(), v, 2, k, ws, rnd)
    with pytest.raises(ValueError, match="rounding"):
        fm.field_mlp_fwd(x, v, 2, k, ws, torch.float16)  # no kernel rounds to float16


def _fma32(acc, a, w) -> np.float32:
    """fmaf(a, w, acc) of three float32 values, from exact rationals: the
    nearest float32 to acc + a * w, ties to even."""
    exact = Fraction(float(acc)) + Fraction(float(a)) * Fraction(float(w))
    near = np.float32(float(exact))
    cands = [near, np.nextafter(near, np.float32(np.inf)), np.nextafter(near, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.array(c).view(np.int32)) & 1))


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_the_ordered_reference_adds_each_product_in_k_order(rounding):
    """field_mlp_fwd_ordered, the kernel's arithmetic in PyTorch ops: each
    output is acc = fmaf(a_k, w_k, acc) for k = 0, 1, ... from 0, as a loop
    of exact sums rounded to float32 adds them (bf16 operands first
    rounded; their products are exact); its forward is close to the plain
    version's: within a few bf16 ulps of a hidden value with bf16 operands
    (where another order of the same sums rounds a hidden value the other
    way), within a few float32 ulps of a column's scale with float32
    ones."""
    rnd, dtype = ROUNDINGS[rounding]
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.normal(size=(6, 31)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 31)).astype(np.float32))
    if rnd is not None:
        a, w = fm._rounded(a), fm._rounded(w)
    want = np.zeros((6, 5), np.float32)
    for i in range(6):
        for j in range(5):
            for k in range(31):
                want[i, j] = _fma32(want[i, j], a[i, k].item(), w[j, k].item())
    assert torch.equal(fm._ordered_linear(a, w, rnd), torch.from_numpy(want))
    net = _net(dtype)
    x, v, k = _inputs(5, 8, seed=9)
    ordered = fm.field_mlp_fwd_ordered(x, v, 8, k, _weights(net), rnd)
    plain = fm.field_mlp_fwd_plain(x, v, 8, k, _weights(net), rnd)
    scale = plain.abs().amax(0)
    assert ((ordered - plain).abs() <= (2.0 ** -6 if rnd else 1e-6) * scale).all()
    assert (ordered[~k, 3] == 0).all()


def test_the_float32_chain_rounds_each_fma_once():
    """Where the float64 sum of a float32 and an exact product lands on a
    midpoint between two float32 values, rounding it to float32 would round
    twice: 1 + 2^-23 plus 2^-24 (1 - 2^-46) is just below the midpoint
    1 + 2^-23 + 2^-24, whose tie goes to the even 1 + 2^-22; fmaf, and the
    chain, give 1 + 2^-23."""
    acc = torch.tensor([[1 + 2.0 ** -23]])
    a = torch.tensor([[2.0 ** -24 * (1 + 2.0 ** -23)]])
    w = torch.tensor([1 - 2.0 ** -23])
    assert (acc.double() + a.double() * w.double()).float().item() == 1 + 2.0 ** -22
    assert fm._fma_f32(acc, a, w).item() == 1 + 2.0 ** -23
    rng = np.random.default_rng(10)
    vals = (rng.normal(size=(3, 64)) * 2.0 ** rng.integers(-40, 40, (3, 64))).astype(np.float32)
    got = fm._fma_f32(torch.from_numpy(vals[0]), torch.from_numpy(vals[1]),
                      torch.from_numpy(vals[2]))
    assert got.tolist() == [float(_fma32(*c)) for c in vals.T]
