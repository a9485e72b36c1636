"""The port's kernel modules (hashnerf_torch/kernels) against the JAX
package on the CPU, where each wrapper takes its plain PyTorch version, and
against the plain versions on the card in test_torch_cuda.py.

The sorted segment-sum (K1's contract) is held against the JAX TPU
formulation `_sorted_segment_accumulate_tpu`, which runs the Pallas kernel
in interpret mode on the CPU; the scatter-add (K5's contract) against JAX's
`sorted_segment_accumulate`; HashEncode and its backward (K6's contract)
against `hash_encode_fast` and its custom VJP; take_rows against JAX
take_rows.
"""
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.kernels.segment_scatter import _sorted_segment_accumulate_tpu
from hashnerf_tpu.kernels.segment_scatter import sorted_segment_accumulate as jax_scatter
from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JCfg
from hashnerf_torch.kernels import KERNELS, build, launch_counts, reset_launch_counts
from hashnerf_torch.kernels import hash_encode as the
from hashnerf_torch.kernels import field_query as fq
from hashnerf_torch.kernels.field_mlp import field_mlp_fwd
from hashnerf_torch.kernels.field_query import field_colour_input, field_raw
from hashnerf_torch.kernels.gather import take_rows
from hashnerf_torch.kernels.segment_accum import (
    segment_accumulate_k1, segment_accumulate_k4, segment_accumulate_k5,
    segment_accumulate_sorted, sorted_segment_accumulate,
)
from hashnerf_torch.kernels.packed_encode import PackedEncode, packed_encode_bwd, packed_encode_fwd
from hashnerf_torch.ops.hash_encoding import HashGridConfig
from hashnerf_torch.ops.packed_grid import PackedGridConfig, init_packed_tables

from test_torch_cuda import K1_CASES, SCATTER_FAMILIES, encode_inputs, k1_case as _k1_case, scatter_family


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_matches_pallas_interpret(case):
    idx, vals, T = _k1_case(case)
    got = sorted_segment_accumulate(_t(idx), _t(vals), T).numpy()
    want = np.asarray(_sorted_segment_accumulate_tpu(jnp.asarray(idx), jnp.asarray(vals), num_rows=T))
    if case == "single_hot_row":
        assert got[2500, 0] == 100.0 and np.abs(got).sum() == 200.0
        np.testing.assert_array_equal(got, want)
    elif case == "large_m_same_sign":
        # float64 oracle at rtol 2e-5 (no small row lost to cancellation)
        oracle = np.zeros((T, 1), np.float64)
        np.add.at(oracle, idx, vals.astype(np.float64))
        np.testing.assert_allclose(got, oracle.astype(np.float32), rtol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5)
    else:
        # float32 sums of the same terms in another order
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_k1_wrapper_checks():
    idx, vals, T = _k1_case("dense")
    with pytest.raises(ValueError):
        segment_accumulate_sorted(_t(idx), _t(vals[:10]), T)
    # neither CPU nor CUDA: the wrapper raises instead of taking a plain path
    with pytest.raises(ValueError):
        segment_accumulate_sorted(_t(idx).to("meta"), _t(vals).to("meta"), T)


@pytest.mark.parametrize("family", SCATTER_FAMILIES)
def test_scatter_add_matches_jax(family):
    """The scatter-add every caller uses, on CPU tensors (K5's plain version),
    against the JAX package's sorted_segment_accumulate (XLA's scatter-add on
    the CPU), for the callers' row widths and id types."""
    idx, vals, T = scatter_family(family)
    got = sorted_segment_accumulate(_t(idx), _t(vals), T).numpy()
    want = np.asarray(jax_scatter(jnp.asarray(idx.astype(np.int32)), jnp.asarray(vals), T))
    assert got.shape == (T, vals.shape[1])
    if family == "single_hot_row":
        assert got[2500, 0] == 100.0 and np.abs(got).sum() == 200.0
        np.testing.assert_array_equal(got, want)
    else:
        # float32 sums of the same terms in another order
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bad", ["shape", "idx_dtype", "vals_dtype", "f0", "f257", "cpu", "meta"])
def test_k5_wrapper_checks(bad):
    idx, vals, T = _k1_case("dense")
    idx, vals, M = _t(idx), _t(vals), idx.shape[0]
    if bad == "meta":
        # neither CPU nor CUDA: the router raises instead of taking a plain path
        with pytest.raises(ValueError):
            sorted_segment_accumulate(idx.to("meta"), vals.to("meta"), T)
        return
    # the checks come before the device's, so CPU tensors reach each of them
    args = {
        "shape": (idx, vals[:10]),
        "idx_dtype": (idx.float(), vals),
        "vals_dtype": (idx, vals.double()),
        "f0": (idx, torch.zeros((M, 0))),
        "f257": (idx, torch.zeros((M, 257))),
        "cpu": (idx, vals),  # the kernel wrapper takes CUDA tensors only
    }[bad]
    with pytest.raises(TypeError if bad.endswith("dtype") else ValueError):
        segment_accumulate_k5(*args, T)


def _refused_call(case):
    """A call of the wrapper `case` on a meta tensor, or on CPU tensors
    with one on meta; for K1 and K4, whose routers take the CPU's plain
    version, on CPU tensors."""
    meta = lambda t: t.to("meta")
    bmin, bmax = torch.full((3,), -1.0), torch.ones(3)
    res = HashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4,
                         finest_resolution=8).resolutions_tensor("cpu")
    pcfg = PackedGridConfig(n_levels=4, n_features_per_level=8, log2_hashmap_size=13,
                            finest_resolution=32, log2_blocks=10)
    tables = init_packed_tables(pcfg)
    keep = torch.ones(8, dtype=torch.bool)
    weights = [torch.zeros(s) for s in ((64, 32), (16, 64), (64, 31), (64, 64), (3, 64))]
    idx, vals = torch.arange(8, dtype=torch.int32), torch.ones((8, 16))
    return {
        "hash_encode_fwd": lambda: the.hash_encode_fwd(
            torch.zeros(2, 256, 2), meta(torch.zeros(4, 3)), bmin, bmax, res),
        "hash_encode_bwd_expand": lambda: the.hash_encode_bwd_expand(
            meta(torch.zeros(4, 3)), bmin, bmax, res, torch.zeros(4, 4), 256),
        "packed_encode_fwd": lambda: packed_encode_fwd(
            tables["dense"], tables["fine"], meta(torch.zeros(4, 3)), bmin, bmax, pcfg),
        "packed_encode_bwd": lambda: packed_encode_bwd(
            meta(torch.zeros(4, 3)), meta(bmin), meta(bmax), meta(torch.zeros(4, pcfg.out_dim)),
            pcfg),
        "field_colour_input_fwd": lambda: fq.field_colour_input_fwd(
            meta(torch.zeros(2, 16)), torch.zeros(8, 16), 4),
        "field_colour_input_bwd": lambda: fq.field_colour_input_bwd(
            meta(torch.zeros(8, 31)), 16, 16),
        "field_raw_fwd": lambda: fq.field_raw_fwd(torch.zeros(8, 3), torch.zeros(8, 16),
                                                  meta(keep)),
        "field_raw_bwd": lambda: fq.field_raw_bwd(meta(torch.zeros(8, 4)), keep, 16),
        "field_mlp_fwd": lambda: field_mlp_fwd(meta(torch.zeros(8, 32)), torch.zeros(2, 16), 4,
                                               keep, weights),
        "segment_accumulate_k1": lambda: segment_accumulate_k1(idx, vals[:, :2], 8),
        "segment_accumulate_k4": lambda: segment_accumulate_k4(idx, vals, 8),
    }[case]


@pytest.mark.parametrize("case", [
    "hash_encode_fwd", "hash_encode_bwd_expand", "packed_encode_fwd", "packed_encode_bwd",
    "field_colour_input_fwd", "field_colour_input_bwd", "field_raw_fwd", "field_raw_bwd",
    "field_mlp_fwd", "segment_accumulate_k1", "segment_accumulate_k4"])
def test_wrappers_refuse_devices_they_cannot_route(case):
    """Every wrapper routes by launch.device_kind: a tensor on neither the
    CPU nor one CUDA device raises ValueError naming the wrapper, with
    nothing launched; K1 and K4 take CUDA tensors only."""
    call = _refused_call(case)
    reset_launch_counts()
    with pytest.raises(ValueError, match=case):
        call()
    assert not any(launch_counts().values())


def test_cpu_tensors_take_plain_versions_without_launching():
    reset_launch_counts()
    idx, vals, T = _k1_case("dense")
    sorted_segment_accumulate(_t(idx), _t(vals), T)
    cfg = HashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4, finest_resolution=8)
    table = torch.zeros(2, 256, 2, requires_grad=True)
    f, _ = the.hash_encode(table, torch.zeros(4, 3), torch.full((3,), -1.0),
                           torch.ones(3), cfg.resolutions_tensor("cpu"))
    f.sum().backward()
    sorted_segment_accumulate(_t(idx), torch.ones((idx.shape[0], 216)), T)  # the fine slabs' width
    take_rows(torch.zeros((T, 8), requires_grad=True), _t(idx).long()).sum().backward()
    pcfg = PackedGridConfig(n_levels=4, n_features_per_level=8, log2_hashmap_size=13,
                            finest_resolution=32, log2_blocks=10)
    tables = {k: v.requires_grad_(True) for k, v in init_packed_tables(pcfg).items()}
    f, _ = PackedEncode.apply(tables["dense"], tables["fine"], torch.zeros(4, 3),
                              torch.full((3,), -1.0), torch.ones(3), pcfg)
    f.sum().backward()
    h = torch.zeros((8, 16), requires_grad=True)
    c = field_colour_input(torch.zeros((2, 16)), h, 4)
    (c.sum() + field_raw(torch.zeros((8, 3)), h, torch.ones(8, dtype=torch.bool)).sum()).backward()
    weights = [torch.zeros(s) for s in ((64, 32), (16, 64), (64, 31), (64, 64), (3, 64))]
    field_mlp_fwd(torch.zeros((8, 32)), torch.zeros((2, 16)), 4, torch.ones(8, dtype=torch.bool),
                  weights)
    assert {k: n for k, n in launch_counts().items() if k in KERNELS} == {
        "segment_accumulate_k1": 0, "hash_encode_fwd": 0, "hash_encode_bwd_expand": 0,
        "segment_accumulate_k4": 0, "segment_accumulate_k5": 0, "hash_encode_bwd": 0,
        "packed_encode_fwd": 0, "packed_encode_bwd": 0, "field_colour_input_fwd": 0,
        "field_colour_input_bwd": 0, "field_raw_fwd": 0, "field_raw_bwd": 0,
        "field_mlp_fwd": 0}


def test_library_path_follows_headers(tmp_path, monkeypatch):
    """A source that includes csrc/*.cuh is rebuilt when a header changes."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    assert headers, "csrc/ holds no header"
    before = {name: build.library_path(name) for name in build.SOURCES}
    assert before == {name: build.library_path(name) for name in build.SOURCES}
    with open(csrc / headers[0], "ab") as f:
        f.write(b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(after[name] != before[name] for name in build.SOURCES)
    assert all(os.path.dirname(p) == build.BUILD_DIR for p in after.values())


@pytest.mark.parametrize("L,log2_T,F", [(4, 10, 2), (16, 12, 2), (4, 10, 8)])
def test_hash_encode_bwd_matches_jax_vjp(L, log2_T, F):
    """K6's contract on CPU tensors (its plain version) against the table
    cotangent of jax.vjp(hash_encode_fast)."""
    from hashnerf_tpu.kernels.hash_encode_vjp import hash_encode_fast

    base, finest, lo, hi = (4, 32, -1.0, 1.0) if L == 4 else (16, 512, -1.6, 1.6)
    table, x, probe, bmin, bmax, tcfg = encode_inputs(2, L, log2_T, base, finest, 300, lo, hi, F=F)
    jcfg = JCfg(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_T,
                base_resolution=base, finest_resolution=finest)
    jargs = (jnp.asarray(x), jnp.asarray(bmin), jnp.asarray(bmax))
    _, vjp = jax.vjp(lambda t: hash_encode_fast(t, *jargs, jcfg)[0], jnp.asarray(table))
    (want,) = vjp(jnp.asarray(probe))

    reset_launch_counts()
    got = the.hash_encode_bwd(_t(x), _t(bmin), _t(bmax), tcfg.resolutions_tensor("cpu"),
                              _t(probe), 1 << log2_T)
    assert launch_counts()["hash_encode_bwd"] == 0
    assert got.shape == (L, 1 << log2_T, F) and got.dtype == torch.float32
    # the same corner values summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("bad", ["x_shape", "g_shape", "bbox_shape", "dtype", "noncontiguous",
                                 "rows", "meta"])
def test_k6_wrapper_checks(bad):
    table, x, probe, bmin, bmax, cfg = encode_inputs(3, 4, 10, 4, 32, 64, -1.0, 1.0)
    x, probe, bmin, bmax = _t(x), _t(probe), _t(bmin), _t(bmax)
    res, T = cfg.resolutions_tensor("cpu"), 1 << 10
    # the checks come before the device's, so CPU tensors reach each of them
    args = {
        "x_shape": (x[:, :2], bmin, bmax, res, probe, T),
        "g_shape": (x, bmin, bmax, res, probe[:, :7], T),
        "bbox_shape": (x, bmin[:2], bmax, res, probe, T),
        "dtype": (x, bmin, bmax, res, probe.double(), T),
        "noncontiguous": (x, bmin, bmax, res, probe.t().contiguous().t(), T),
        "rows": (x, bmin, bmax, res, probe, 2**29),  # L*T = 2^31 overflows int32 row ids
        # neither CPU nor CUDA: the wrapper raises instead of taking a plain path
        "meta": tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                      for a in (x, bmin, bmax, res, probe, T)),
    }[bad]
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        the.hash_encode_bwd(*args)


@pytest.mark.parametrize("L,log2_T,base,finest,lo,hi", [
    (4, 10, 4, 32, -1.0, 1.0), (16, 12, 16, 512, -1.6, 1.6),
])
def test_hash_encode_matches_hash_encode_fast(L, log2_T, base, finest, lo, hi):
    from hashnerf_tpu.kernels.hash_encode_vjp import hash_encode_fast

    table, x, probe, bmin, bmax, tcfg = encode_inputs(0, L, log2_T, base, finest, 300, lo, hi)
    jcfg = JCfg(n_levels=L, log2_hashmap_size=log2_T, base_resolution=base, finest_resolution=finest)
    jargs = (jnp.asarray(x), jnp.asarray(bmin), jnp.asarray(bmax))

    # hash_encode_fast runs op by op outside jit, rounding each operation
    fj, kj = hash_encode_fast(jnp.asarray(table), *jargs, jcfg)
    gj = jax.grad(lambda t: jnp.sum(hash_encode_fast(t, *jargs, jcfg)[0] * jnp.asarray(probe)))(
        jnp.asarray(table))

    tt = _t(table).requires_grad_(True)
    ft, kt = the.hash_encode(tt, _t(x), _t(bmin), _t(bmax), tcfg.resolutions_tensor("cpu"))
    (ft * _t(probe)).sum().backward()

    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(ft.detach().numpy(), np.asarray(fj), rtol=1e-4, atol=1e-7)
    # table gradient: the same corner values summed in another order
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-7)


def test_bwd_expand_matches_jax_corner_geometry():
    from hashnerf_tpu.kernels.hash_encode_vjp import _corner_geometry

    table, x, probe, bmin, bmax, tcfg = encode_inputs(1, 16, 12, 16, 512, 200, -1.6, 1.6)
    jcfg = JCfg(n_levels=16, log2_hashmap_size=12)
    idx, cw, _ = _corner_geometry(jnp.asarray(x), jnp.asarray(bmin), jnp.asarray(bmax), jcfg)
    L, T = 16, 1 << 12
    want_idx = (np.asarray(idx) + (np.arange(L) * T)[:, None, None]).reshape(-1)
    g = probe.reshape(-1, L, 2).transpose(1, 0, 2)
    want_vals = (np.asarray(cw)[..., None] * g[:, :, None, :]).reshape(-1, 2)
    flat_idx, vals = the.hash_encode_bwd_expand(
        _t(x), _t(bmin), _t(bmax), tcfg.resolutions_tensor("cpu"), _t(probe), T)
    assert flat_idx.dtype == torch.int32
    np.testing.assert_array_equal(flat_idx.numpy(), want_idx)
    np.testing.assert_allclose(vals.numpy(), want_vals, rtol=1e-6, atol=0)


def test_take_rows_gradient_matches_jax():
    from hashnerf_tpu.kernels.gather_vjp import take_rows as jtake

    rng = np.random.default_rng(2)
    table = rng.normal(size=(4096, 2)).astype(np.float32)
    idx = rng.integers(0, 4096, (30, 50)).astype(np.int32)
    cot = rng.normal(size=(30, 50, 2)).astype(np.float32)
    want_out = np.asarray(jtake(jnp.asarray(table), jnp.asarray(idx)))
    want_g = jax.grad(lambda t: jnp.sum(jtake(t, jnp.asarray(idx)) * jnp.asarray(cot)))(jnp.asarray(table))

    tt = _t(table).requires_grad_(True)
    out = take_rows(tt, _t(idx))
    (out * _t(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want_out)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
