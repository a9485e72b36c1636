"""sample_pdf's two step functions in the JAX package and the port, side by
side on the CPU: its denominator, replaced by 1 below 1e-5, and its count
of cdf entries <= u at u = 1. Each test puts the decision one ulp either
side of its threshold: both packages take the same decision on each input
(the same samples, bit for bit) and jump together between the two, by the
size stated. These are the reference's own discontinuities: a card and a
CPU that differ in the last bits of a cdf can decide them apart
(chip_smoke.py's view gate, PERF.md §7).

The weights are chosen so that the cdf is the same in both packages: two
bins, whose sums have one order, or three, at draws whose cdf both form
alike (JAX and torch sum longer rows in other orders on the CPU, which
moves a cdf by an ulp)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

F = np.float32(1e-5)


def _both(bins, weights, u):
    """(port's samples, JAX's samples) of sample_pdf on numpy inputs."""
    from hashnerf_tpu.ops.sampling import sample_pdf as jpdf
    from hashnerf_torch.ops.sampling import sample_pdf as tpdf

    zt = tpdf(torch.from_numpy(bins), torch.from_numpy(weights), u.shape[-1],
              u=torch.from_numpy(u)).numpy()
    zj = np.asarray(jpdf(None, jnp.asarray(bins), jnp.asarray(weights), u.shape[-1],
                         u=jnp.asarray(u)))
    return zt, zj


def _first_denominator(w1):
    """Bin 0's denominator in sample_pdf for weights (0, w1): cdf[1] - 0 =
    pdf[0] = (0 + 1e-5) / ((0 + 1e-5) + (w1 + 1e-5)), each step one float32
    operation."""
    v0, v1 = np.float32(0) + F, np.float32(w1) + F
    return v0 / np.float32(v0 + v1)


def _switch_weights():
    """The weights (0, w1) whose bin-0 denominator is 1 ulp above and 1
    ulp below float32(1e-5): w1 walked from 1 - 2e-5 in steps of 2^-24."""
    want = {"above": np.nextafter(F, np.float32(1)), "below": np.nextafter(F, np.float32(0))}
    found = {}
    for k in range(-4096, 4096):
        w1 = np.float32(np.float32(1 - 2e-5) - np.float32(k) * np.float32(2**-24))
        for side, d in want.items():
            if side not in found and _first_denominator(w1) == d:
                found[side] = w1
        if len(found) == 2:
            return found
    raise AssertionError(f"no weights put the denominator 1 ulp from 1e-5: {found}")


def test_denominator_switch_one_ulp_either_side_of_1e5():
    """A draw u = 1e-5 / 2 lands in bin 0 (edges 0 and 0.5) at about half
    its mass. Its denominator 1 ulp above 1e-5: t = u / denom, the sample at
    0.25. 1 ulp below: the denominator becomes 1, t = u, the sample at
    2.5e-6. Both packages jump by 0.25 - 2.5e-6, half the bin; the draws
    in the other bin move by less than 1e-6."""
    bins = np.array([[0.0, 0.5, 1.0]], np.float32)
    u = np.array([[0.0, F / 2, 0.5, 1.0]], np.float32)
    z = {}
    for side, w1 in _switch_weights().items():
        zt, zj = _both(bins, np.array([[0.0, w1]], np.float32), u)
        np.testing.assert_array_equal(zt, zj, err_msg=side)
        z[side] = zt[0]
    assert z["above"][1] == pytest.approx(0.25, rel=1e-6)
    assert z["below"][1] == pytest.approx(0.5 * F / 2, rel=1e-6)
    assert z["above"][1] - z["below"][1] == pytest.approx(0.25 - 2.5e-6, rel=1e-6)
    np.testing.assert_allclose(z["above"][[0, 2, 3]], z["below"][[0, 2, 3]], atol=1e-6)


def _end_weights(last: float):
    """Three weights (w0, w1, last) from seeded draws, the first whose cdf
    ends 1 ulp above 1 and the first whose cdf ends 1 ulp below, each with
    its last bin's denominator (cdf[-1] - cdf[-2]) below 1e-5 when last is
    0, above it otherwise. JAX sums three terms in another order than torch
    on some draws, and its cdf then differs by an ulp: a decision is
    compared on one cdf, so the draws taken are those whose cdf the two
    packages form bit for bit alike."""
    rng = np.random.default_rng(0)
    w = rng.random((65536, 3)).astype(np.float32)
    w[:, 2] = last
    p = (torch.from_numpy(w) + 1e-5) / (torch.from_numpy(w) + 1e-5).sum(-1, keepdim=True)
    cdf = torch.cumsum(p, -1)
    wj = jnp.asarray(w) + 1e-5
    same = torch.from_numpy(np.asarray(jnp.cumsum(wj / jnp.sum(wj, -1, keepdims=True), -1))
                            == cdf.numpy()).all(dim=-1)
    end, d = cdf[:, -1], cdf[:, -1] - cdf[:, -2]
    switched = d < 1e-5 if last == 0 else d > 1e-5
    out = {}
    for side, v in (("above", np.nextafter(np.float32(1), np.float32(2))),
                    ("below", np.nextafter(np.float32(1), np.float32(0)))):
        hit = ((end == torch.tensor(v)) & switched & same).nonzero().flatten()
        assert hit.numel(), side
        out[side] = w[int(hit[0])][None]
    return out


@pytest.mark.parametrize("last", [0.0, 0.1])
def test_u_one_with_cdf_end_one_ulp_either_side_of_1(last):
    """u = 1 against a cdf that ends 1 ulp above 1 or 1 ulp below
    (edges 0, 0.25, 0.5, 1). Below: every entry is <= 1, so the count is
    4, the bin clamps to the last edge, the sample is at 1.0. Above: the
    count is 3 and u takes the last bin [0.5, 1]. With an empty last bin
    (last = 0) its denominator is below 1e-5, becomes 1, t = 1 - cdf[-2]
    (about 1e-5): the sample is at 0.5, and both packages jump by the last
    bin's width, 0.5, to within 1e-5 of it. With a last bin of mass
    (last = 0.1), t = (1 - cdf[-2]) / denom is 1 less a few ulps over the
    denominator: the sample moves by less than 1e-5 of the bin, no jump."""
    bins = np.array([[0.0, 0.25, 0.5, 1.0]], np.float32)
    u = np.array([[0.0, 0.5, 1.0]], np.float32)
    z = {}
    for side, w in _end_weights(last).items():
        zt, zj = _both(bins, w, u)
        np.testing.assert_array_equal(zt, zj, err_msg=side)
        z[side] = zt[0]
    assert z["below"][2] == 1.0
    jump = z["below"][2] - z["above"][2]
    if last == 0.0:
        assert jump == pytest.approx(0.5, abs=0.5 * 1e-5), jump
    else:
        assert 0.0 <= jump < 0.5 * 1e-5, jump


# chip_diag.py llff-view (PERF.md §7): at fern's test view on the card, the
# u = 1 draw's count flipped on about a third of the rays held, each time with
# cdf[-1] 1 ulp or 2 above 1 on one device and at or below 1 on the other.
# Ray 86459 of state 5 (last bin's denominator 1.5626e-3) moved its last fine
# sample by 1.19e-6 and its colour by 1.44e-3; a ray whose last bin was
# below 1e-5 moved it by a whole bin, 0.015873 (every state).
DIAG_LAST_DENOM = 1.5626e-3


def _fern_bins():
    """sample_pdf's 63 bin edges at fern's 64 coarse samples in NDC (near
    0, far 1): the mid-points of linspace(0, 1, 64)."""
    z = np.arange(64, dtype=np.float32) / np.float32(63)
    z[-1] = 1.0
    return (np.float32(0.5) * (z[1:] + z[:-1]))[None]


def _cdf_port(v):
    t = torch.from_numpy(v) + 1e-5
    return torch.cumsum(t / t.sum(-1, keepdim=True), -1).numpy()


def _cdf_jax(v):
    j = jnp.asarray(v) + 1e-5
    return np.asarray(jnp.cumsum(j / jnp.sum(j, -1, keepdims=True), -1))


def _ends_apart(w, cdf_of, switched=None):
    """Two copies of the 62 weights w, each multiplied by 1 + 3e-7 N(0, 1)
    (seeded): the first whose cdf (as cdf_of forms it) ends above 1, its
    last bin's denominator below 1e-5 or not as `switched` asks, and the
    first whose cdf ends at or below 1 (the devices' roles: the same
    weights but for their last bits). JAX and torch sum 62 terms in other
    orders, so each package is given the pair its own cdf puts apart."""
    rng = np.random.default_rng(1)
    out = {}
    for _ in range(8192):
        v = (w * (1 + 3e-7 * rng.standard_normal(w.shape))).astype(np.float32)[None]
        cdf = cdf_of(v)[0]
        if cdf[-1] <= 1:
            out.setdefault("at_or_below", (v, cdf))
        elif switched is None or (cdf[-1] - cdf[-2] < 1e-5) == switched:
            out.setdefault("above", (v, cdf))
        if len(out) == 2:
            return out
    raise AssertionError(f"no pair of cdf ends either side of 1: {sorted(out)}")


@pytest.mark.parametrize("last, switched", [("mass", None), ("empty", True), ("empty", False)],
                         ids=["last_bin_of_mass", "last_bin_empty_switched",
                              "last_bin_empty_unswitched"])
def test_u_one_at_fern_shapes_moves_the_last_sample_as_on_the_card(last, switched):
    """The mechanism the card showed, at fern's shapes (62 bins, 64 draws
    in eval mode, NDC bin edges, an opaque ray), from weights alike but for
    their last bits. The u = 1 draw's sample sits at the last edge where
    cdf[-1] <= 1, and at bins[-2] + t * width, t = (1 - cdf[-2]) / denom,
    where cdf[-1] > 1. With a last bin of the diagnostic's denominator
    (1.5626e-3) it moves by width * (cdf[-1] - 1) / denom, 1.2e-6 as on the
    card. An empty last bin's denominator, near 1 - sum(pdf) at the cdf's
    end, falls on a grid of 2^-24 around 1e-5 (9.954e-6 or 1.0014e-5), so
    the cdf's last bits also decide sample_pdf's switch there: switched,
    t = 1 - cdf[-2], and the sample moves by the whole bin, 1/63, as on
    the card; not, t = 1 - (cdf[-1] - 1) / denom and it stops short of the
    last edge by that fraction of the bin, about 1.2% (1.9e-4). JAX and the
    port each jump so, by the same size."""
    from hashnerf_tpu.ops.sampling import sample_pdf as jpdf
    from hashnerf_torch.ops.sampling import sample_pdf as tpdf

    rng = np.random.default_rng(0)
    w = (rng.random(62) ** 8).astype(np.float64)
    w[-1] = 0.0
    w *= 0.9999 / w.sum()  # an opaque ray: the pdf's sum past 1 - 62e-5
    if last == "mass":
        # w[-1] + 1e-5 = DIAG_LAST_DENOM of the new total
        w[-1] = DIAG_LAST_DENOM * (w.sum() + 62e-5) / (1 - DIAG_LAST_DENOM) - 1e-5
    w = w.astype(np.float32)
    bins = _fern_bins()
    u = np.linspace(0, 1, 64, dtype=np.float32)
    u[-1] = 1.0
    width = float(bins[0, -1] - bins[0, -2])
    packages = {
        "port": (_cdf_port, lambda v: tpdf(torch.from_numpy(bins), torch.from_numpy(v), 64,
                                           u=torch.from_numpy(u[None])).numpy()),
        "jax": (_cdf_jax, lambda v: np.asarray(jpdf(None, jnp.asarray(bins), jnp.asarray(v), 64,
                                                    u=jnp.asarray(u[None])))),
    }
    jumps = {}
    for name, (cdf_of, place) in packages.items():
        pair = _ends_apart(w, cdf_of, switched)
        z = {side: place(v)[0] for side, (v, _) in pair.items()}
        cdf = pair["above"][1]
        assert z["at_or_below"][-1] == bins[0, -1], name
        dz = float(z["at_or_below"][-1] - z["above"][-1])
        denom = float(cdf[-1] - cdf[-2])
        t = (1 - float(cdf[-2])) / (1.0 if denom < 1e-5 else denom)
        assert dz == pytest.approx(width * (1 - t), rel=0.05), (name, dz)
        if last == "mass":
            assert denom == pytest.approx(DIAG_LAST_DENOM, rel=1e-3), name
            assert 5e-7 < dz < 3e-6, (name, dz)
        elif switched:
            assert denom < 1e-5 and dz == pytest.approx(1 / 63, rel=1e-3), (name, dz)
        else:
            assert denom > 1e-5 and 0 < dz < 0.02 * width, (name, dz)
        np.testing.assert_allclose(z["above"][:-1], z["at_or_below"][:-1], atol=1e-5, err_msg=name)
        jumps[name] = dz
    assert jumps["port"] == pytest.approx(jumps["jax"], rel=0.5 if switched is None else 1e-3)
