"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mdqtplasmasims_tpu.core.scheduler import CoolingScheduler
from mdqtplasmasims_tpu.core.init import frozen_gas_init
from mdqtplasmasims_tpu.experiments.laser_cooling import (
    CoolingConfig, build_engine, build_scheduler)
from mdqtplasmasims_tpu.parallel.ensemble import (
    batched_initial_states, make_sharded_md_step, shard_keys,
    sharded_forces_fn)
from mdqtplasmasims_tpu.parallel.mesh import factor_devices, make_mesh
from mdqtplasmasims_tpu.state import make_state
from mdqtplasmasims_tpu.units import PlasmaUnits

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")


def _init_one(cfg):
    def init(key):
        kinit, krun = jax.random.split(key)
        R, V, psi, _ = frozen_gas_init(kinit, cfg.n0, n_states=12,
                                       exact_n=True, dtype=jnp.float64)
        return make_state(R, V, psi, krun, dtype=jnp.float64)
    return init


@needs_devices
class TestShardedStep:
    def test_matches_single_device(self):
        """One sharded MD step over (ens=2, ions=4) must equal the
        single-device step for each ensemble member bit-for-bit in f64."""
        cfg = CoolingConfig(n0=64, dtype="float64")
        pu = PlasmaUnits(cfg.density, cfg.ge)
        L = PlasmaUnits.box_length(cfg.n0)
        n_ens, n_ions = 2, 4
        mesh = make_mesh(n_ens, n_ions)

        def factory(forces_fn):
            return CoolingScheduler(engine=build_engine(cfg),
                                    forces_fn=forces_fn, L=L, qdt=cfg.qdt,
                                    ratio=cfg.ratio)

        step = make_sharded_md_step(factory, mesh, L, pu.debye_length)
        keys = shard_keys(jax.random.PRNGKey(0), n_ens, n_ions)
        states = batched_initial_states(_init_one(cfg), keys[:, 0])
        states = states._replace(key=keys)

        out = step(states)
        assert out.R.shape == (n_ens, cfg.n0, 3)
        assert int(out.tick[0]) == cfg.ratio

        # single-device comparison for member 0: same forces, but RNG
        # streams differ per ion shard, so compare only the classical part
        # after disabling the QT kick pathway via identical keys is not
        # possible; instead check force consistency directly:
        fn_local = build_scheduler(cfg).forces_fn
        F_ref, _ = fn_local(states.R[0])
        assert np.allclose(np.asarray(out.F[0]), np.asarray(F_ref),
                           rtol=1e-12, atol=1e-12)

    def test_full_state_matches_single_device(self):
        """On an ens-only mesh (n_ions=1) the per-member RNG streams are
        identical to the unsharded ones, so three sharded MD steps plus a
        diagnostics sample must reproduce the full SimState of the
        unsharded scheduler exactly (f64)."""
        from mdqtplasmasims_tpu.core.md import kinetic_energies
        from mdqtplasmasims_tpu.ops.yukawa import (yukawa_forces_potential,
                                                   yukawa_potential)

        cfg = CoolingConfig(n0=48, dtype="float64")
        pu = PlasmaUnits(cfg.density, cfg.ge)
        L = PlasmaUnits.box_length(cfg.n0)
        n_ens, n_ions = 8, 1
        mesh = make_mesh(n_ens, n_ions)

        def factory(forces_fn):
            return CoolingScheduler(engine=build_engine(cfg),
                                    forces_fn=forces_fn, L=L, qdt=cfg.qdt,
                                    ratio=cfg.ratio)

        step = make_sharded_md_step(factory, mesh, L, pu.debye_length)
        keys = shard_keys(jax.random.PRNGKey(3), n_ens, n_ions)
        states = batched_initial_states(_init_one(cfg), keys[:, 0])
        states = states._replace(key=keys)

        out = states
        for _ in range(3):
            out = step(out)

        # unsharded replay, same math (cols=R is the identical row-block
        # computation the sharded path performs after its all_gather)
        sched = factory(lambda R: yukawa_forces_potential(R, L,
                                                          pu.debye_length,
                                                          cols=R))
        for i in range(n_ens):
            member = jax.tree.map(lambda a: a[i], states)
            member = member._replace(key=states.key[i, 0])
            for _ in range(3):
                member = sched.md_step(member)
            for name in ("R", "V", "F", "t_part"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(out, name)[i]),
                    np.asarray(getattr(member, name)), err_msg=name)
            np.testing.assert_array_equal(np.asarray(out.psi[i]),
                                          np.asarray(member.psi))
            assert int(out.tick[i]) == int(member.tick)
            # diagnostics sample on the sharded result == unsharded
            ek_s = kinetic_energies(out.V[i])
            ek_u = kinetic_energies(member.V)
            np.testing.assert_array_equal(np.asarray(ek_s),
                                          np.asarray(ek_u))
            np.testing.assert_allclose(
                float(yukawa_potential(out.R[i], L, pu.debye_length)),
                float(yukawa_potential(member.R, L, pu.debye_length)),
                rtol=1e-14)

    def test_ring_step_matches_gather_step(self):
        """A full MD step with the ppermute-ring force path == the
        all_gather path (same keys; forces differ only by summation
        order -> 1e-12 f64)."""
        cfg = CoolingConfig(n0=64, dtype="float64")
        pu = PlasmaUnits(cfg.density, cfg.ge)
        L = PlasmaUnits.box_length(cfg.n0)
        n_ens, n_ions = 2, 4
        mesh = make_mesh(n_ens, n_ions)

        def factory(forces_fn):
            return CoolingScheduler(engine=build_engine(cfg),
                                    forces_fn=forces_fn, L=L, qdt=cfg.qdt,
                                    ratio=cfg.ratio)

        keys = shard_keys(jax.random.PRNGKey(5), n_ens, n_ions)
        states = batched_initial_states(_init_one(cfg), keys[:, 0])
        states = states._replace(key=keys)

        out_g = make_sharded_md_step(factory, mesh, L, pu.debye_length,
                                     forces="gather")(states)
        out_r = make_sharded_md_step(factory, mesh, L, pu.debye_length,
                                     forces="ring")(states)
        for name in ("R", "V", "F", "t_part"):
            np.testing.assert_allclose(
                np.asarray(getattr(out_r, name)),
                np.asarray(getattr(out_g, name)),
                rtol=1e-11, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(np.asarray(out_r.psi),
                                   np.asarray(out_g.psi),
                                   rtol=1e-11, atol=1e-12)

    def test_sharded_forces_match(self):
        """Row-sharded force computation == unsharded."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential

        n = 96
        L = PlasmaUnits.box_length(n)
        ldeb = PlasmaUnits(2.0, 0.1).debye_length
        R = jax.random.uniform(jax.random.PRNGKey(1), (n, 3), jnp.float64,
                               0, L)
        mesh = make_mesh(1, 8)
        fn = sharded_forces_fn(L, ldeb)
        sharded = shard_map(lambda r: fn(r)[0], mesh=mesh,
                            in_specs=P("ions"), out_specs=P("ions"))
        F_sharded = sharded(R)
        F_ref = yukawa_forces_potential(R, L, ldeb)[0]
        assert np.allclose(np.asarray(F_sharded), np.asarray(F_ref),
                           rtol=1e-12, atol=1e-12)

    def test_ring_forces_match(self):
        """ppermute-ring force circulation == unsharded (memory-lean path
        for very large N)."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from mdqtplasmasims_tpu.ops.yukawa import yukawa_forces_potential
        from mdqtplasmasims_tpu.parallel.ensemble import ring_forces_fn

        n = 96
        L = PlasmaUnits.box_length(n)
        ldeb = PlasmaUnits(2.0, 0.1).debye_length
        R = jax.random.uniform(jax.random.PRNGKey(2), (n, 3), jnp.float64,
                               0, L)
        mesh = make_mesh(1, 8)
        fn = ring_forces_fn(L, ldeb)
        sharded = shard_map(fn, mesh=mesh, in_specs=P("ions"),
                            out_specs=(P("ions"), P("ions")))
        F_ring, pot_ring = sharded(R)
        F_ref, pot_ref = yukawa_forces_potential(R, L, ldeb)
        assert np.allclose(np.asarray(F_ring), np.asarray(F_ref),
                           rtol=1e-12, atol=1e-12)
        assert np.allclose(np.asarray(pot_ring), np.asarray(pot_ref),
                           rtol=1e-12, atol=1e-12)


@needs_devices
def test_ensemble_members_independent():
    """Different jobs produce different trajectories (independent RNG)."""
    cfg = CoolingConfig(n0=48)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    states = batched_initial_states(_init_one(
        CoolingConfig(n0=48, dtype="float64")), keys)
    assert not np.allclose(np.asarray(states.R[0]), np.asarray(states.R[1]))


@needs_devices
class TestMemberShardedFamilies:
    """Every batched family spreads its job array / sweep over the
    mesh's ens axis bit-exactly (parallel/ensemble.member_sharded —
    SURVEY.md §2 parallelism axis 2, the SLURM array over chips)."""

    def test_transport_ensemble_and_sweep(self):
        from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import (
            MCTransportConfig, run_ensemble, run_sweep)
        cfg = MCTransportConfig(
            n=27, mc_steps=400, gr_every_mc=200, pre_record_md_steps=10,
            record_steps=40, gr_every_record=20, instant_aniso_steps=10,
            reequil_steps=10, aniso_relax_steps=10, aniso_time_us=1.0)
        mesh = make_mesh(n_ens=8, n_ions=1)
        a = run_ensemble(cfg, 8, seed=3)
        b = run_ensemble(cfg, 8, seed=3, mesh=mesh)
        for j in range(8):
            for k in a[j]:
                np.testing.assert_array_equal(np.asarray(a[j][k]),
                                              np.asarray(b[j][k]))
        ra, _ = run_sweep(cfg, [{"gamma": g} for g in (0.5, 1, 3, 30)],
                          jobs_per_point=2, seed=5)
        rb, _ = run_sweep(cfg, [{"gamma": g} for g in (0.5, 1, 3, 30)],
                          jobs_per_point=2, seed=5, mesh=mesh)
        for j in range(8):
            np.testing.assert_array_equal(ra[j]["temps"], rb[j]["temps"])

    def test_frozen_tag_ensemble_and_sweep(self):
        from mdqtplasmasims_tpu.experiments.frozen_tagging import (
            FrozenTagConfig, run_ensemble, run_sweep)
        cfg = FrozenTagConfig(variant="422linear", n0=48, tstart=1.0,
                              tmax=3.0, timestep=0.01, sample_freq=20,
                              tpump_seconds=2e-7)
        mesh = make_mesh(n_ens=8, n_ions=1)
        a = run_ensemble(cfg, 8, seed=2)
        b = run_ensemble(cfg, 8, seed=2, mesh=mesh)
        for j in range(8):
            np.testing.assert_array_equal(a[j]["outs"]["moments"],
                                          b[j]["outs"]["moments"])
            np.testing.assert_array_equal(a[j]["spin_up"], b[j]["spin_up"])
        ra, _ = run_sweep(cfg, [{"detuning": d} for d in (-4, -2, -1, 0)],
                          jobs_per_point=2, seed=3)
        rb, _ = run_sweep(cfg, [{"detuning": d} for d in (-4, -2, -1, 0)],
                          jobs_per_point=2, seed=3, mesh=mesh)
        for j in range(8):
            np.testing.assert_array_equal(ra[j]["spin_up"],
                                          rb[j]["spin_up"])

    def test_mc_tag_ensemble(self):
        from mdqtplasmasims_tpu.experiments.mc_qt_tagging import (
            MCTagConfig, run_ensemble)
        cfg = MCTagConfig(variant="408quad", n=27, mc_steps=300,
                          pre_record_md_steps=10, record_steps=40,
                          gr_every_record=20)
        mesh = make_mesh(n_ens=8, n_ions=1)
        a = run_ensemble(cfg, 8, seed=9)
        b = run_ensemble(cfg, 8, seed=9, mesh=mesh)
        for j in range(8):
            np.testing.assert_array_equal(a[j]["moments"], b[j]["moments"])
            np.testing.assert_array_equal(a[j]["tags"], b[j]["tags"])

    def test_three_state_ensemble_and_sweep(self):
        from mdqtplasmasims_tpu.experiments.three_state import (
            ThreeStateConfig, run_ensemble, run_sweep)
        cfg = ThreeStateConfig(n0=64, tmax=50.0, sample_freq=100,
                               dispatch_segments=3)
        mesh = make_mesh(n_ens=8, n_ions=1)
        a = run_ensemble(cfg, 8, seed=4)
        b = run_ensemble(cfg, 8, seed=4, mesh=mesh)
        np.testing.assert_array_equal(a["ekin_x"], b["ekin_x"])
        ra, _ = run_sweep(cfg, [{"detuning": d} for d in (-0.5, -1, -2,
                                                          -4)],
                          jobs_per_point=2, seed=4)
        rb, _ = run_sweep(cfg, [{"detuning": d} for d in (-0.5, -1, -2,
                                                          -4)],
                          jobs_per_point=2, seed=4, mesh=mesh)
        np.testing.assert_array_equal(ra["ekin_x"], rb["ekin_x"])

    def test_guards(self):
        from mdqtplasmasims_tpu.experiments.three_state import (
            ThreeStateConfig, run_ensemble)
        cfg = ThreeStateConfig(n0=16, tmax=5.0, sample_freq=100,
                               dispatch_segments=2)
        with pytest.raises(ValueError, match="ion shards"):
            run_ensemble(cfg, 8, mesh=make_mesh(n_ens=4, n_ions=2))
        with pytest.raises(ValueError, match="divide"):
            run_ensemble(cfg, 6, mesh=make_mesh(n_ens=8, n_ions=1))
