"""Force/potential kernel validation against brute-force numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.ops.yukawa import (
    yukawa_forces, yukawa_forces_potential, yukawa_potential)
from mdqtplasmasims_tpu.units import PlasmaUnits


def brute_force(R, L, ldeb, mask=None):
    d = R[:, None, :] - R[None, :, :]
    d -= L * np.round(d / L)
    r = np.sqrt((d ** 2).sum(-1))
    valid = (r > 0) & (r < L / 2)
    if mask is not None:
        valid = valid & (mask[None, :] > 0)
    rs = np.where(valid, r, 1.0)
    ft = np.where(valid, (1 / rs + 1 / ldeb) * np.exp(-rs / ldeb) / rs ** 2, 0.0)
    F = (d * ft[:, :, None]).sum(1)
    pot = np.where(valid, np.exp(-rs / ldeb) / rs, 0.0).sum(1)
    if mask is not None:
        F = F * mask[:, None]
        pot = pot * mask
    return F, pot


@pytest.fixture(scope="module")
def system():
    n0 = 300
    pu = PlasmaUnits(density=2.0, Ge=0.1)
    L = PlasmaUnits.box_length(n0)
    rng = np.random.default_rng(42)
    R = rng.uniform(0, L, (n0, 3))
    return R, L, pu.debye_length


def test_forces_match_numpy(system):
    R, L, ldeb = system
    F_np, pot_np = brute_force(R, L, ldeb)
    F, pot = yukawa_forces_potential(jnp.asarray(R), L, ldeb, chunk=128)
    assert np.abs(np.array(F) - F_np).max() < 1e-10
    assert np.abs(np.array(pot) - pot_np).max() < 1e-10


def test_potential_scalar(system):
    R, L, ldeb = system
    _, pot_np = brute_force(R, L, ldeb)
    ep = float(yukawa_potential(jnp.asarray(R), L, ldeb))
    assert ep == pytest.approx(pot_np.sum() / 2 / R.shape[0], rel=1e-12)


def test_newton_third_law(system):
    """Total force vanishes (the reference's racy scatter violates this
    nondeterministically; ours is exact)."""
    R, L, ldeb = system
    F = np.array(yukawa_forces(jnp.asarray(R), L, ldeb))
    assert np.abs(F.sum(0)).max() < 1e-9


def test_mask(system):
    R, L, ldeb = system
    n = R.shape[0]
    mask = np.ones(n)
    mask[n // 2:] = 0.0
    F_np, _ = brute_force(R, L, ldeb, mask)
    F = np.array(yukawa_forces(jnp.asarray(R), L, ldeb,
                               mask=jnp.asarray(mask), chunk=128))
    assert np.abs(F - F_np).max() < 1e-10
    assert np.abs(F[n // 2:]).max() == 0.0


def test_uneven_chunking(system):
    R, L, ldeb = system
    F_a = np.array(yukawa_forces(jnp.asarray(R), L, ldeb, chunk=128))
    F_b = np.array(yukawa_forces(jnp.asarray(R), L, ldeb, chunk=77))
    assert np.abs(F_a - F_b).max() < 1e-10


def test_mc_family_equivalence(system):
    """The MC family force law exp(-kr)(1/r^3 + k/r^2) equals the cooling
    family law (1/r + 1/lDeb) exp(-r/lDeb)/r^2 with k = 1/lDeb."""
    R, L, ldeb = system
    kappa = 1.0 / ldeb
    d = R[:, None, :] - R[None, :, :]
    d -= L * np.round(d / L)
    r = np.sqrt((d ** 2).sum(-1))
    valid = (r > 0) & (r < L / 2)
    rs = np.where(valid, r, 1.0)
    aij = np.where(valid, np.exp(-kappa * rs) * (rs ** -3 + kappa / rs ** 2), 0.0)
    F_mc = (d * aij[:, :, None]).sum(1)
    F = np.array(yukawa_forces(jnp.asarray(R), L, ldeb, chunk=128))
    assert np.abs(F - F_mc).max() < 1e-10


def _planes(R, npad):
    """[N, 3] positions -> padded [3, npad] lane planes + [1, npad] mask."""
    n = R.shape[0]
    Rp = jnp.zeros((3, npad), R.dtype).at[:, :n].set(R.T)
    return Rp, jnp.zeros((1, npad), R.dtype).at[0, :n].set(1.0)


@pytest.mark.parametrize("n,npad", [(120, 128), (300, 384), (600, 640),
                                    (1000, 1024)])
def test_soa_planes_match_rows(n, npad):
    """Forces from the fused loop's padded [3, Np] planes equal the [N, 3]
    path on real lanes, and padded lanes feel no force."""
    from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_soa
    pu = PlasmaUnits(density=2.0, Ge=0.1)
    L = PlasmaUnits.box_length(n)
    R = jnp.asarray(np.random.default_rng(n).uniform(0, L, (n, 3)))
    Rp, mask_row = _planes(R, npad)
    F = np.asarray(yukawa_forces_soa(Rp, mask_row, L, pu.debye_length))
    F_ref, _ = brute_force(np.asarray(R), L, pu.debye_length)
    assert np.abs(F[:, :n].T - F_ref).max() < 1e-10
    assert np.abs(F[:, n:]).max() == 0.0


@pytest.mark.parametrize("per_member", [False, True])
def test_soa_batched_masked_forces(system, per_member):
    """Member-batched forces on the folded [3, E*npad] layout: each
    member equals its own brute-force sum under its mask (a shared
    [1, npad] row or per-member [E, npad] rows, the Poissonian-N fold),
    and members stay uncoupled."""
    from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_soa_batched
    R, L, ldeb = system
    n, npad, e = R.shape[0], 384, 2
    rng = np.random.default_rng(3)
    RE = np.stack([R, rng.uniform(0, L, R.shape)])
    masks = np.zeros((e, npad))
    masks[:, :n] = 1.0
    if per_member:
        masks[1, n - 40:] = 0.0
    RE = RE * masks[:, :n, None]
    Rp = np.zeros((3, e, npad))
    Rp[:, :, :n] = np.transpose(RE, (2, 0, 1))
    rows = masks if per_member else masks[:1]
    F = np.asarray(yukawa_forces_soa_batched(
        jnp.asarray(Rp.reshape(3, e * npad)), jnp.asarray(rows), e, L,
        ldeb)).reshape(3, e, npad)
    for j in range(e):
        F_ref, _ = brute_force(RE[j], L, ldeb, masks[j, :n])
        assert np.abs(F[:, j, :n].T - F_ref).max() < 1e-10
        assert np.abs(F[:, j, n:]).max() == 0.0


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_cols_gather_matches_full_sum(n_shards):
    """The ion-sharded "gather" schedule: each shard's rows against the
    all-gathered columns sum to the unsharded forces (masked padding on
    every shard, per-member masks)."""
    from mdqtplasmasims_tpu.ops.yukawa import (
        yukawa_forces_soa_batched, yukawa_forces_soa_cols_batched)
    pu = PlasmaUnits(density=2.0, Ge=0.1)
    e, n_loc, npad = 2, 40, 64
    L = PlasmaUnits.box_length(n_loc * n_shards)
    rng = np.random.default_rng(n_shards)
    mask = np.zeros((e, n_shards * npad))
    for s in range(n_shards):
        mask[:, s * npad:s * npad + n_loc] = 1.0
    R = rng.uniform(0, L, (e, n_shards * npad, 3)) * mask[:, :, None]
    fold = lambda x: jnp.asarray(np.transpose(x, (2, 0, 1)).reshape(3, -1))
    F_full = np.asarray(yukawa_forces_soa_batched(
        fold(R), jnp.asarray(mask), e, L, pu.debye_length)).reshape(
            3, e, n_shards * npad)
    for s in range(n_shards):
        sl = slice(s * npad, (s + 1) * npad)
        F_s = np.asarray(yukawa_forces_soa_cols_batched(
            fold(R[:, sl]), jnp.asarray(R), jnp.asarray(mask),
            jnp.asarray(mask[:, sl]), e, L, pu.debye_length))
        np.testing.assert_allclose(F_s.reshape(3, e, npad),
                                   F_full[:, :, sl], rtol=1e-11,
                                   atol=1e-12)


class TestTracedLdeb:
    """Kappa sweeps (transport family): the screening length can be a
    traced scalar, so one compiled program serves members with different
    ldeb."""

    def test_traced_ldeb_matches_static(self, system):
        R, L, ldeb = system
        Rj = jnp.asarray(R)
        F_static = np.asarray(yukawa_forces(Rj, L, ldeb))
        F_traced = np.asarray(jax.jit(
            lambda r, ld: yukawa_forces(r, L, ld))(Rj, jnp.asarray(ldeb)))
        np.testing.assert_allclose(F_traced, F_static, rtol=1e-12,
                                   atol=1e-14)

    def test_vmapped_traced_ldeb(self, system):
        """The transport sweep's composition: vmap over members whose
        traced ldeb differs, each equal to its brute-force sum."""
        R, L, ldeb = system
        rng = np.random.default_rng(13)
        RE = np.stack([R, rng.uniform(0, L, R.shape)])
        ldebs = np.asarray([ldeb, 0.7 * ldeb])
        FV = np.asarray(jax.vmap(lambda r, ld: yukawa_forces(r, L, ld))(
            jnp.asarray(RE), jnp.asarray(ldebs)))
        for j in range(2):
            F_ref, _ = brute_force(RE[j], L, ldebs[j])
            assert np.abs(FV[j] - F_ref).max() < 1e-10
        F_other, _ = brute_force(RE[1], L, ldeb)
        assert np.abs(FV[1] - F_other).max() > 1e-3

    def test_best_forces_fn_traced_ldeb(self, system):
        """The families' entry (best_forces_fn) accepts a traced ldeb."""
        from mdqtplasmasims_tpu.ops.yukawa import best_forces_fn
        R, L, ldeb = system
        F = np.asarray(jax.jit(lambda ld: best_forces_fn(
            R.shape[0], L, ld)(jnp.asarray(R))[0])(jnp.asarray(ldeb)))
        F_ref, _ = brute_force(R, L, ldeb)
        assert np.abs(F - F_ref).max() < 1e-10
