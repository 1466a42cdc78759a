"""Ensemble + ion-sharded execution over a device mesh.

Replaces the reference's share-nothing SLURM job array
(exampleSlurmFile.slurm) with a single SPMD program: trajectories are
batched on the ``ens`` mesh axis (vmap within a device, shard_map across
devices) and the ion axis may additionally be sharded for the O(N^2) pair
forces, with one ``all_gather`` of positions per force refresh.

RNG: every (job, ion-shard) pair gets an independent threefry key via
nested ``jax.random.split`` (``shard_keys``: base -> per-job -> per-shard)
— replacing (and fixing) the reference's ``srand48(time+job)`` plus
unseeded ``std::random_device`` (SURVEY.md L4).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..state import SimState
from ..core.scheduler import CoolingScheduler, fold_sweep_lanes
from ..ops.yukawa import yukawa_forces_potential
from .mesh import ENS_AXIS, ION_AXIS, state_pspec


def batched_initial_states(init_one: Callable[[jax.Array], SimState],
                           keys: jax.Array) -> SimState:
    """vmap an initializer over per-job keys -> SimState with leading E."""
    return jax.vmap(init_one)(keys)


def sharded_forces_fn(L: float, ldeb: float, chunk: int = 512):
    """Row-sharded force evaluation: gather the global positions over the
    ion axis, compute this shard's force rows locally."""

    def fn(R_local):
        R_full = jax.lax.all_gather(R_local, ION_AXIS, axis=0, tiled=True)
        return yukawa_forces_potential(R_local, L, ldeb, chunk=chunk,
                                       cols=R_full)
    return fn


def ring_forces_fn(L: float, ldeb: float, axis: str = ION_AXIS,
                   chunk: int = 512):
    """Ring-permute force evaluation for very large N: instead of
    all-gathering the global positions (memory O(N) per device), circulate
    position blocks around the ICI ring with ``ppermute`` and accumulate
    partial row forces — the blockwise/ring-attention idea applied to the
    N x N pair interaction (SURVEY.md section 5, long-context analog).
    Peak per-device memory is O(N/k)."""

    def fn(R_local):
        k = jax.lax.axis_size(axis)
        n_loc = R_local.shape[0]
        perm = [(i, (i + 1) % k) for i in range(k)]

        def body(i, carry):
            F, pot, buf = carry
            Fi, poti = yukawa_forces_potential(R_local, L, ldeb, chunk=chunk,
                                               cols=buf)
            buf = jax.lax.ppermute(buf, axis, perm)
            return F + Fi, pot + poti, buf

        F0 = jnp.zeros_like(R_local)
        pot0 = jnp.zeros_like(R_local[:, 0])
        F, pot, _ = jax.lax.fori_loop(0, k, body, (F0, pot0, R_local))
        return F, pot
    return fn


def make_sharded_md_step(scheduler_factory: Callable[[Callable], "CoolingScheduler"],
                         mesh: Mesh, L: float, ldeb: float,
                         forces: str = "gather"):
    """Build a jitted [E, N, ...] SimState -> SimState step over the mesh.

    ``scheduler_factory(forces_fn)`` returns a scheduler whose ``md_step``
    advances one single-system state; it is vmapped over the local ensemble
    block inside shard_map.  ``forces`` picks the cross-shard force path:
    ``"gather"`` (one all_gather of positions per refresh) or ``"ring"``
    (ppermute circulation, O(N/k) peak memory per device — for huge N).
    """
    if forces not in ("gather", "ring"):
        raise ValueError(f"forces must be 'gather' or 'ring', got "
                         f"{forces!r}")
    fn = (ring_forces_fn(L, ldeb) if forces == "ring"
          else sharded_forces_fn(L, ldeb))
    sched = scheduler_factory(fn)
    spec = state_pspec()

    def local_step(state: SimState) -> SimState:
        # state leaves are local blocks [E_loc, N_loc, ...]; key is
        # [E_loc, 1] typed keys (one per (ens, ion-shard)); tick/t: [E_loc].
        def one(member: SimState) -> SimState:
            member = member._replace(key=member.key[0])
            out = sched.md_step(member)
            return out._replace(key=out.key[None])
        return jax.vmap(one)(state)

    step = shard_map(local_step, mesh=mesh, in_specs=(spec,), out_specs=spec)
    return jax.jit(step)


def gather_soa_forces(L: float, ldeb: float, e_loc: int, npad: int,
                      mrows: jax.Array, axis: str = ION_AXIS):
    """Ion-sharded force schedule for the fused loop, inside shard_map:
    all-gather each member's positions (and masks) over ``axis`` and
    compute this shard's rows against the whole member.  ``mrows``
    ``[1, npad]`` or ``[E_loc, npad]`` marks the shard's real ions.
    Returns ``soa_forces`` mapping ``Rp [3, E_loc*npad] -> F [3,
    E_loc*npad]``, zero on masked rows so padded lanes stay inert."""
    from ..ops.yukawa import yukawa_forces_soa_cols_batched
    cm = jnp.broadcast_to(mrows, (e_loc, npad))

    def soa_forces(Rp):
        col_mask = jax.lax.all_gather(cm, axis, axis=1, tiled=True)
        R3 = jnp.swapaxes(Rp.reshape(3, e_loc, npad), 0, 1)
        cols = jax.lax.all_gather(jnp.swapaxes(R3, 1, 2), axis, axis=1,
                                  tiled=True)            # [E, I*npad, 3]
        return yukawa_forces_soa_cols_batched(Rp, cols, col_mask, cm,
                                              e_loc, L, ldeb)
    return soa_forces


def fused_local_stepper(sched: "CoolingScheduler", ldeb: float,
                        n_ion_shards: int):
    """Local (per-device) fused production stepper for shard_map.

    Returns ``local_run(states, n_steps)`` advancing a local ensemble
    block [E_loc, N_loc, ...] by ``n_steps`` multirate MD steps on the
    production program: members fold into the fused tick-block kernel's
    ion axis (core/qt_fused.py) and pair forces run on the XLA path —
    member-local when each member's ions are device-local
    (``n_ion_shards == 1``, the production ensemble layout), or this
    shard's rows against an ``all_gather`` of the member's global
    positions when the ion axis is sharded (large-N layout; the reaction
    half of each pair lives on another shard).  Pallas interpret mode
    (``sched.interpret``) makes the same program run on a CPU mesh for
    tests and the dry run.

    RNG: per-member rolls come from each member's own key, so
    trajectories are invariant to how the ensemble axis is laid out
    across devices.

    ``local_run(states, n_steps, mask=None, sweep_e0=None)``: the
    optional local ``mask [E_loc, N_loc]`` marks each member's real ions
    (Poissonian-N fold); masked lanes are kept exactly inert —
    row-masked forces on every path and source masking via the kernels'
    mask columns.  ``sweep_e0 [E_loc, S]`` gives each local member its
    own diagonal energies (detuning sweep; requires a spec with
    ``per_lane_e0``).

    ``split_last=True`` splits the LAST MD step at the reference's
    output instant — one quantum tick in
    (laserCoolingPlusExpansionMDQTSpeedUp.cpp:1365-1368) — and returns
    ``(states_mid, states_end)`` so the sharded sampler sees the exact
    state the reference's output() sees."""
    from ..ops.yukawa import yukawa_forces_soa_batched

    def local_run(states: SimState, n_steps: int, mask=None,
                  sweep_e0=None, sweep_om=None, split_last: bool = False):
        E_loc, n_loc = states.R.shape[0], states.R.shape[1]
        npad = sched._npad(n_loc)
        if mask is None:
            mrows = jnp.zeros((1, npad),
                              jnp.float32).at[0, :n_loc].set(1.0)
        else:
            mrows = jnp.zeros((E_loc, npad), jnp.float32).at[
                :, :n_loc].set(mask.astype(jnp.float32))
        if n_ion_shards == 1:
            soa_forces = lambda Rp: yukawa_forces_soa_batched(
                Rp, mrows, E_loc, sched.L, ldeb)
        else:
            soa_forces = gather_soa_forces(sched.L, ldeb, E_loc, npad,
                                           mrows)

        e0p, omp = fold_sweep_lanes(sched.fused_spec, npad,
                                    sweep_e0=sweep_e0, sweep_om=sweep_om)
        local = states._replace(key=states.key[:, 0])
        carry = sched.soa_ens_init(local, local.F)
        n_full = n_steps - 1 if split_last else n_steps
        carry = jax.lax.fori_loop(
            0, n_full,
            lambda i, c: sched.soa_ens_md_step(c, soa_forces,
                                               per_member_rolls=True,
                                               e0_lanes=e0p,
                                               om_lanes=omp),
            carry)
        if not split_last:
            out = sched.soa_ens_restore(carry, local)
            return out._replace(key=out.key[:, None])
        carry = sched.soa_ens_md_step(carry, soa_forces,
                                      per_member_rolls=True,
                                      e0_lanes=e0p, om_lanes=omp,
                                      n_ticks=1)
        mid = sched.soa_ens_restore(carry, local)
        if sched.ratio > 1:
            carry = sched.soa_ens_md_step(carry, soa_forces,
                                          per_member_rolls=True,
                                          e0_lanes=e0p, om_lanes=omp,
                                          n_ticks=sched.ratio - 1,
                                          reuse_forces=True)
        out = sched.soa_ens_restore(carry, local)
        return (mid._replace(key=mid.key[:, None]),
                out._replace(key=out.key[:, None]))
    return local_run


def make_sharded_fused_step(sched: "CoolingScheduler", ldeb: float,
                            mesh: Mesh, n_steps: int = 1, with_mask=False):
    """Jitted sharded [E, N, ...] SimState -> SimState over ``n_steps``
    MD steps on the fused production path (see fused_local_stepper).
    ``sched`` must carry a ``fused_spec``.  With ``with_mask`` the step
    takes ``(states, mask [E, N])`` for Poissonian-N members."""
    if sched.fused_spec is None:
        raise ValueError("make_sharded_fused_step needs a scheduler with "
                         "a fused_spec: the GPU route of "
                         "routing.kernel_route, or a config with "
                         "fused_interpret=True")
    spec = state_pspec()
    local = fused_local_stepper(sched, ldeb, mesh.shape[ION_AXIS])
    # check_vma=False: pallas_call does not yet annotate its outputs with
    # varying-mesh-axes metadata, so the vma checker rejects any Pallas
    # kernel inside shard_map
    if with_mask:
        step = shard_map(lambda s, m: local(s, n_steps, mask=m),
                         mesh=mesh,
                         in_specs=(spec, P(ENS_AXIS, ION_AXIS)),
                         out_specs=spec, check_vma=False)
    else:
        step = shard_map(lambda s: local(s, n_steps), mesh=mesh,
                         in_specs=(spec,), out_specs=spec,
                         check_vma=False)
    return jax.jit(step)


def shard_keys(base_key: jax.Array, n_ens: int, n_ion_shards: int) -> jax.Array:
    """[E, I] typed keys: independent stream per (job, ion shard)."""
    ens_keys = jax.random.split(base_key, n_ens)

    def per_ens(k):
        return jax.random.split(k, n_ion_shards)
    return jax.vmap(per_ens)(ens_keys)


def member_sharded(fn, mesh):
    """Multi-device form of a batched job array for the share-nothing
    families (transport, tagging, 3-state toy): wrap an [E]-batched
    member function — every input and output pytree leaf carries the
    member axis leading — so members shard over the mesh's ``ens`` axis.
    Pure data parallelism, zero collectives (SURVEY.md §2 parallelism
    axis 2: the reference's SLURM array, spread over devices).

    These families keep whole members on one device (their production N
    fits comfortably), so a mesh with an ion axis would only replicate
    work; ask for ``make_mesh(n_ions=1)`` instead."""
    if ION_AXIS in mesh.shape and mesh.shape[ION_AXIS] != 1:
        raise ValueError(
            "member_sharded shards members only; use make_mesh(n_ions=1) "
            f"(got {mesh.shape[ION_AXIS]} ion shards)")
    n_ens = mesh.shape[ENS_AXIS]
    spec = P(ENS_AXIS)

    def wrapped(*args):
        e = jax.tree.leaves(args[0])[0].shape[0]
        if e % n_ens:
            raise ValueError(f"{e} members do not divide over "
                             f"{n_ens} ens-axis devices")
        # check_vma=False: scan carries inside the pipelines start as
        # replicated constants and become varying when combined with the
        # sharded member data (same waiver as make_sharded_fused_step)
        return shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                         out_specs=spec, check_vma=False)(*args)

    return wrapped
