"""The shapes the port's kernels take on the packed path, on the CPU (the
kernels themselves run only on the card: tests/test_torch_cuda.py holds
them to their plain versions there).

- The TV losses' take_rows calls at the main paths' widths (the chair's
  hash grid, the packed dense cubes and slabs), the shapes chip_smoke.py
  times K5 at.
- take_rows' backward at the packed TV widths against JAX's take_rows VJP.
- K7's plain version against JAX's packed_encode at ragged point counts
  (a block's tile and a warp cut short on the card) and L = 4 and 8.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.ops import packed_grid as jpg
from hashnerf_torch.kernels import packed_encode as pe
from hashnerf_torch.kernels.gather import take_rows

from test_torch_cuda import packed_config, packed_points, packed_tables


@functools.lru_cache(maxsize=None)
def tv_shapes():
    """{name: (M, F, num_rows, id bytes)} of the take_rows calls the TV
    losses make at the main paths' widths (configs/chair.txt's hash grid;
    the packed path's L4 / F8, 2^16 block rows), recorded on the CPU."""
    from hashnerf_torch.ops.hash_encoding import HashGridConfig
    from hashnerf_torch.ops.packed_grid import PackedGridConfig, init_packed_tables
    from hashnerf_torch.train import losses

    got = []
    take = losses.take_rows

    def recording(table, idx):
        got.append((idx.numel(), table.shape[1], table.shape[0], idx.element_size()))
        return take(table, idx)

    gen = torch.Generator().manual_seed(0)
    hcfg = HashGridConfig(log2_hashmap_size=19)
    pcfg = PackedGridConfig(n_levels=4, n_features_per_level=8, log2_hashmap_size=19,
                            log2_blocks=16)
    try:
        losses.take_rows = recording
        losses.total_variation_loss_all_levels(
            torch.zeros((16, 1 << 19, 2)), hcfg.base_resolution, hcfg.finest_resolution, 19,
            generator=gen)
        losses.total_variation_loss_packed(init_packed_tables(pcfg, gen), pcfg, generator=gen)
    finally:
        losses.take_rows = take
    return dict(zip(["chair_tv", "packed_tv_dense_0", "packed_tv_dense_1", "packed_tv_slabs"], got))


def test_tv_shapes_are_the_main_paths():
    shapes = tv_shapes()
    assert shapes["packed_tv_slabs"] == (4096, 216, 131072, 8)
    assert shapes["packed_tv_dense_0"][:3] == (4096, 8, 17**3 + 51**3)
    assert shapes["chair_tv"][1:] == (2, 16 << 19, 8)


@pytest.mark.parametrize("F,rows,M", [(8, 4913, 4096), (216, 2048, 1024)])
def test_take_rows_backward_matches_jax_at_tv_widths(F, rows, M):
    from hashnerf_tpu.kernels.gather_vjp import take_rows as jtake

    rng = np.random.default_rng(F)
    table = rng.normal(size=(rows, F)).astype(np.float32)
    idx = rng.integers(0, rows, M)
    cot = rng.normal(size=(M, F)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jtake(t, jnp.asarray(idx.astype(np.int32))) * cot))(
        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    (take_rows(tt, torch.from_numpy(idx)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["L4_F8", "L8_F4"])
@pytest.mark.parametrize("N", [1, 31, 33])
def test_packed_encode_fwd_plain_matches_jax_at_ragged_n(N, name):
    """Features within 2 gamma(8) of their blend's absolute sum (a float32
    dot product of 8 terms on either side), keep equal."""
    jc, tc = packed_config(name, jpg), packed_config(name)
    tabs = packed_tables(tc, N)
    x = packed_points(tc, "block_edges", N, N)
    bmin, bmax = np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32)
    fj, kj = jpg.packed_encode({k: jnp.asarray(v) for k, v in tabs.items()}, jnp.asarray(x),
                               jnp.asarray(bmin), jnp.asarray(bmax), jc)
    args = tuple(torch.from_numpy(a) for a in (x, bmin, bmax))
    ft, kt = pe.packed_encode_fwd_plain(torch.from_numpy(tabs["dense"]),
                                        torch.from_numpy(tabs["fine"]), *args, tc)
    abs_sum, _ = pe.packed_encode_fwd_plain(torch.from_numpy(np.abs(tabs["dense"])),
                                            torch.from_numpy(np.abs(tabs["fine"])), *args, tc)
    assert ft.shape == (N, tc.out_dim)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    g8 = 8 * 2.0**-24 / (1 - 8 * 2.0**-24)
    assert (np.abs(ft.numpy() - np.asarray(fj)) <= 2 * g8 * abs_sum.numpy()).all()
