"""The port's kernel modules (hashnerf_torch/kernels) against the JAX
package on the CPU, where each wrapper takes its plain PyTorch version, and
against the plain versions on the card in test_torch_cuda.py.

K1 is held against the JAX TPU formulation `_sorted_segment_accumulate_tpu`,
which runs the Pallas kernel in interpret mode on the CPU; HashEncode
against `hash_encode_fast` and its custom VJP; take_rows against JAX
take_rows.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.kernels.segment_scatter import _sorted_segment_accumulate_tpu
from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JCfg
from hashnerf_torch.kernels import launch_counts, reset_launch_counts
from hashnerf_torch.kernels import hash_encode as the
from hashnerf_torch.kernels.gather import take_rows
from hashnerf_torch.kernels.segment_accum import (
    segment_accumulate_sorted, sorted_segment_accumulate,
)
from hashnerf_torch.ops.hash_encoding import HashGridConfig

from test_torch_cuda import K1_CASES, encode_inputs, k1_case as _k1_case


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


def test_cpu_tensors_take_plain_versions_without_launching():
    reset_launch_counts()
    idx, vals, T = _k1_case("dense")
    sorted_segment_accumulate(_t(idx), _t(vals), T)
    cfg = HashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4, finest_resolution=8)
    table = torch.zeros(2, 256, 2, requires_grad=True)
    f, _ = the.hash_encode(table, torch.zeros(4, 3), torch.full((3,), -1.0),
                           torch.ones(3), cfg.resolutions_tensor("cpu"))
    f.sum().backward()
    sorted_segment_accumulate(_t(idx), torch.ones((idx.shape[0], 216)), T)  # K4's width
    assert launch_counts() == {"segment_accumulate_k1": 0, "hash_encode_fwd": 0,
                               "hash_encode_bwd_expand": 0, "segment_accumulate_k4": 0}


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
