"""Frozen-gas-start quantum-trajectory velocity tagging.

JAX re-expression of randomFrozenStartTag{408Linear,408Quad,
422Linear}.cpp (call stack SURVEY.md 3.4): frozen (T=0) random positions
undergo disorder-induced heating under pure Yukawa MD; inside the pump
window [tstart, tstart+tpump] an optical-pumping QT engine spin-polarizes a
velocity class (no recoil); at the window's end every ion is projectively
measured (spin-up list); afterwards the tagged subset's moments, KDE
velocity distribution, and streaming VAF (or v^2 autocorrelation "LongKin"
for the 408Quad variant) are recorded.

Phase structure (each phase one jitted device program):
  A: MD + windowed pumping up to the pump end (no outputs);
  tag: projective measurement, interval snapshot, first output row;
  B: MD to tmax, output block every sample_freq MD steps (aligned to the
     reference's global (c0+1) %% sampleFreq gate).

Measurement instant: the reference tags at the first quantum tick with
t >= tendV0 (randomFrozenStartTag422Linear.cpp:1000-1005).  Between that
tick and the enclosing MD boundary nothing but t advances (qstep is
gated off past the window; R/V change only in step()), so measuring at
the boundary is bit-identical in content — rows carry the reference's
exact tick timestamps (:func:`tag_tick`, the gate offsets in
run_phase_b), landing on the identical grid the compiled binary writes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.init import frozen_gas_init
from ..core.md import kinetic_energies
from ..core.qt import QTEngine
from ..core.scheduler import FrozenTagScheduler
from ..core.tagging import (spin_up_probability_408, spin_up_probability_422,
                            tagged_moments)
from ..io import checkpoint as ckpt
from ..io.datfiles import DatWriter
from ..io.dirs import frozen_tag_dir
from ..levels import tag408, tag422
from ..ops.correlations import streaming_long_kin, streaming_vaf
from ..ops.kde import centered_bins, centered_bins_np, gaussian_kde
from ..ops.yukawa import best_forces_fn, yukawa_potential
from ..state import SimState, make_state
from ..units import (PlasmaUnits, pump_window_einstein, qt_units_408,
                     qt_units_422)

VARIANTS = ("408linear", "408quad", "422linear")

# (detuning, om, tpump_seconds) as compiled into each reference file:
# randomFrozenStartTag408Linear.cpp:56-58, 408Quad.cpp:58-60,
# 422Linear.cpp:55-57
FROZEN_VARIANT_DEFAULTS = {
    "408linear": (-2.5, 0.7, 2e-7),
    "408quad": (0.0, 2.0, 1e-7),
    "422linear": (-1.0, 1.3, 1e-7),
}


@dataclasses.dataclass(frozen=True)
class FrozenTagConfig:
    """Inputs of the randomFrozenStartTag family (e.g. 422Linear:52-83).
    ``detuning``/``om``/``tpump_seconds`` default per variant to the
    values compiled into the corresponding reference file."""

    variant: str = "422linear"
    detuning: Optional[float] = None   # / gamma of the pump line
    om: Optional[float] = None
    tpump_seconds: Optional[float] = None
    tstart: float = 15.0          # tstartV0
    tmax: float = 25.0
    ge: float = 0.1
    density: float = 2.0
    n0: int = 3500
    timestep: float = 0.002
    sample_freq: int = 40
    job: int = 1
    exact_n: bool = True
    dtype: str = "float32"
    save_directory: Optional[str] = None

    def __post_init__(self):
        assert self.variant in VARIANTS, self.variant
        d = FROZEN_VARIANT_DEFAULTS[self.variant]
        if self.detuning is None:
            object.__setattr__(self, "detuning", d[0])
        if self.om is None:
            object.__setattr__(self, "om", d[1])
        if self.tpump_seconds is None:
            object.__setattr__(self, "tpump_seconds", d[2])

    @property
    def units(self):
        return (qt_units_422(self.density) if self.variant == "422linear"
                else qt_units_408(self.density))

    @property
    def ratio(self) -> int:
        return self.units.ratio_frozen()

    @property
    def qdt(self) -> float:
        return self.timestep / self.ratio

    @property
    def tpump(self) -> float:
        return pump_window_einstein(self.tpump_seconds, self.density)

    @property
    def tend(self) -> float:
        return self.tstart + self.tpump

    @property
    def n_states(self) -> int:
        return 5 if self.variant == "422linear" else 7

    @property
    def np_dtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32

    def scheme(self):
        if self.variant == "422linear":
            return tag422(self.detuning, self.om)
        return tag408(self.detuning, self.om,
                      linear=(self.variant == "408linear"))

    def scheme_unit(self):
        """The variant's scheme at detuning=om=1 — the base pattern that
        sweep folds scale per member (core/qt.sweep_qt_params)."""
        if self.variant == "422linear":
            return tag422(1.0, 1.0)
        return tag408(1.0, 1.0, linear=(self.variant == "408linear"))

    def spin_up_probability(self, psi):
        if self.variant == "422linear":
            return spin_up_probability_422(psi)
        return spin_up_probability_408(psi)


def build_scheduler(cfg: FrozenTagConfig, qt_params=None,
                    mask=None) -> FrozenTagScheduler:
    """``qt_params``: optional traced QTParams override (one sweep
    member's detuning/om — core/qt.sweep_qt_params); None uses cfg's
    static scheme.  ``mask``: traced real-ion marker for padded members
    (Poissonian-N fold) — the pair forces gate both sides of every
    pair, so padded R=V=0 lanes stay exactly inert."""
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    u = cfg.units
    engine = QTEngine(cfg.scheme(), h=cfg.qdt * u.gamma_to_einstein,
                      dt_plasma=cfg.qdt,
                      plas_to_quant_vel=u.plas_to_quant_vel,
                      gamma_to_einstein=u.gamma_to_einstein,
                      apply_force=False)
    return FrozenTagScheduler(
        engine=engine,
        forces_fn=best_forces_fn(cfg.n0, L, pu.debye_length, mask=mask),
        L=L, qdt=cfg.qdt, ratio=cfg.ratio,
        t_pump_start=cfg.tstart, t_pump_end=cfg.tend,
        qt_params=qt_params)


def initial_state(cfg: FrozenTagConfig, seed: Optional[int] = None) -> SimState:
    key = jax.random.PRNGKey(cfg.job if seed is None else seed)
    k_init, k_run = jax.random.split(key)
    R, V, psi, _ = frozen_gas_init(k_init, cfg.n0, n_states=cfg.n_states,
                                   exact_n=cfg.exact_n, dtype=cfg.np_dtype,
                                   seed_for_count=cfg.job)
    st = make_state(R, V, psi, k_run, dtype=cfg.np_dtype)
    # the reference's first step_R computes forces before its 2nd-order
    # drift (randomFrozenStartTag422Linear.cpp:324-333); seed F accordingly
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    forces_fn = best_forces_fn(cfg.n0, L, pu.debye_length)
    F, _ = forces_fn(st.R)
    return st._replace(F=F)


def resume_run(directory: str, c0: int, cfg: FrozenTagConfig):
    """Reference-compatible restart (readConditions + spinUpIonsList,
    randomFrozenStartTag422Linear.cpp:676-764; sets recordedSpinUps=1).
    Returns (state, spin_up)."""
    R, V = ckpt.read_conditions(directory, c0)
    spin_up = ckpt.read_spinup_list(directory, c0).astype(bool)
    if spin_up.shape[0] != R.shape[0]:
        raise ValueError(
            f"{directory}/spinUpIonsList_timestep{c0:06d}.dat has "
            f"{spin_up.shape[0]} rows for {R.shape[0]} ions — truncated "
            "or mismatched checkpoint")
    key = jax.random.PRNGKey(cfg.job * 7919 + c0)
    st = make_state(R, V, jnp.zeros((R.shape[0], cfg.n_states),
                                    jnp.complex64), key, dtype=cfg.np_dtype,
                    t=ckpt.restore_time(c0, cfg.timestep))
    tick = int(round(ckpt.restore_time(c0, cfg.timestep) / cfg.qdt))
    return st._replace(tick=jnp.asarray(tick, jnp.int32)), jnp.asarray(spin_up)


@partial(jax.jit, static_argnames=("cfg", "n_md"))
def run_phase_a(cfg: FrozenTagConfig, state: SimState, n_md: int,
                qt_params=None, mask=None) -> SimState:
    """MD up to the pump end.  The pump window [tstart, tend] is static,
    so the loop splits at trace time into [pure MD | windowed MDQT |
    pure MD] — only the handful of MD steps that can overlap the window
    pay for the quantum tick scan (see scheduler.md_step_pure).
    ``qt_params`` overrides the pump Hamiltonian with traced per-member
    (detuning, om) tables (run_sweep); ``mask`` marks real ions for
    padded members (Poissonian-N fold)."""
    sched = build_scheduler(cfg, qt_params, mask=mask)
    dt_md = cfg.qdt * cfg.ratio
    k_lo = max(0, min(n_md, int(cfg.tstart / dt_md) - 1))
    k_hi = max(k_lo, min(n_md, int(np.ceil(cfg.tend / dt_md)) + 1))
    state = jax.lax.fori_loop(0, k_lo,
                              lambda i, s: sched.md_step_pure(s), state)
    state = jax.lax.fori_loop(k_lo, k_hi,
                              lambda i, s: sched.md_step(s), state)
    return jax.lax.fori_loop(k_hi, n_md,
                             lambda i, s: sched.md_step_pure(s), state)


@partial(jax.jit, static_argnames=("cfg",))
def measure(cfg: FrozenTagConfig, state: SimState):
    """Projective spin measurement + interval snapshot (measureSpinUps)."""
    key, sub = jax.random.split(state.key)
    p = cfg.spin_up_probability(state.psi)
    spin_up = jax.random.uniform(sub, p.shape, p.dtype) < p
    vholder = state.V[:, 0]
    return state._replace(key=key), spin_up, vholder


def _output_block(cfg, state, spin_up, vholder, epot0, L, ldeb, bins,
                  mask=None, toff: float = 0.0):
    """One post-tag output (reference output() + Zfunc/LongKin).
    ``mask`` marks real ions for padded members: every 1/N normalization
    uses the real count (padded lanes are V=0, psi=0 -> untagged, so
    they never enter the sums themselves).

    ``toff`` maps the MD-boundary state time onto the reference's row
    timestamp.  The reference's post-tag gate fires one quantum tick
    into the block after MD step l ((c0+1)%sampleFreq==0 &&
    timeStepCounter==1, randomFrozenStartTag422Linear.cpp:1009), so its
    row carries t = l*dt + qdt while R/V/psi are bit-for-bit the MD
    boundary values (post-window ticks only advance t; V changes only in
    step()) — the label shifts, the physics content does not."""
    ekx, eky, ekz, _ = kinetic_energies(state.V, mask=mask)
    epot = yukawa_potential(state.R, L, ldeb, mask=mask)
    w = spin_up.astype(state.V.dtype)
    pvel_x = gaussian_kde(state.V[:, 0], bins, folded=False, weights=w)
    moments = tagged_moments(state.V[:, 0], spin_up)
    vaf = streaming_vaf(state.V[:, 0], vholder, x_only=True, mask=mask)
    long_kin = streaming_long_kin(state.V[:, 0], vholder, mask=mask)
    return dict(t=state.t - jnp.asarray(toff, state.t.dtype),
                energies=jnp.stack([ekx, eky, ekz, epot,
                                    ekx + eky + ekz + epot - epot0]),
                pvel_x=pvel_x, moments=moments, vaf=vaf, long_kin=long_kin,
                n_up=jnp.sum(spin_up))


def tag_tick(cfg: FrozenTagConfig) -> int:
    """The reference's measurement instant as a global quantum-tick
    index: the first tick with t >= tendV0
    (randomFrozenStartTag422Linear.cpp:1000 — the gate is checked every
    tick, before that iteration's step()).  Between this tick and the
    enclosing MD boundary nothing but t advances (qstep is gated off at
    t >= tendV0 and step() fires only at timeStepCounter==ratio), so
    measuring at the boundary gives bit-identical R/V/psi; only the row
    timestamp is this tick's."""
    return int(np.ceil(cfg.tend / cfg.qdt - 1e-9))


@partial(jax.jit, static_argnames=("cfg",))
def tag_instant_output(cfg: FrozenTagConfig, state: SimState, spin_up,
                       vholder, epot0, mask=None):
    """Output block at the tag instant itself.  The reference emits it
    the moment ``t >= tendV0``: the 422 variant writes only the tau=0
    VAF row (measureSpinUps(); Zfunc(0); printVAF —
    randomFrozenStartTag422Linear.cpp:1000-1005), the 408 variants also
    call output() there (randomFrozenStartTag408Linear.cpp /
    408Quad.cpp, same block), so energies/moments/vel_dist get a first
    row at the tag instant too.  Since ``vholder`` is the velocity
    snapshot just taken, the VAF value is the <v^2> normalization row.
    The row timestamp is the reference's exact measurement tick
    (:func:`tag_tick`); the state content at that tick equals the MD
    boundary content bit-for-bit (see tag_tick)."""
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    bins = centered_bins(cfg.np_dtype)
    n_md_a = int(np.ceil(cfg.tend / cfg.timestep))
    toff = n_md_a * cfg.timestep - tag_tick(cfg) * cfg.qdt
    return _output_block(cfg, state, spin_up, vholder, epot0, L,
                         pu.debye_length, bins, mask=mask, toff=toff)


@partial(jax.jit, static_argnames=("cfg", "seg_lengths", "tail"))
def run_phase_b(cfg: FrozenTagConfig, state: SimState, spin_up, vholder,
                epot0, seg_lengths: tuple, mask=None, tail: int = 0):
    """Post-tag MD with an output block after each segment.  seg_lengths
    must all be equal (one scan) except possibly the first (alignment).
    ``tail``: MD steps past the last sample gate up to tmax — the
    reference keeps stepping to tmax regardless of the sample grid, so
    the terminal checkpoint (labeled n_md_total-1) must include them."""
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    sched = build_scheduler(cfg, mask=mask)
    bins = centered_bins(cfg.np_dtype)
    # the reference's gate fires one quantum tick into the next block
    # (t = l*dt + qdt at gate label l); state.t here is (l+1)*dt and the
    # contents are bit-identical at both instants (see _output_block)
    toff = cfg.timestep - cfg.qdt

    outs = []
    # phase B is entirely past the pump window -> pure-MD steps
    first, rest = seg_lengths[0], seg_lengths[1:]
    state = jax.lax.fori_loop(0, first,
                              lambda i, s: sched.md_step_pure(s), state)
    out0 = _output_block(cfg, state, spin_up, vholder, epot0, L,
                         pu.debye_length, bins, mask=mask, toff=toff)

    if rest:
        n_rest = len(rest)
        assert all(r == rest[0] for r in rest)

        def segment(state, _):
            state = jax.lax.fori_loop(
                0, rest[0], lambda i, s: sched.md_step_pure(s), state)
            return state, _output_block(cfg, state, spin_up, vholder, epot0,
                                        L, pu.debye_length, bins, mask=mask,
                                        toff=toff)

        state, outs = jax.lax.scan(segment, state, None, length=n_rest)
        # prepend the first (alignment) output
        outs = jax.tree.map(lambda a, b: jnp.concatenate([a[None], b]),
                            out0, outs)
    else:
        outs = jax.tree.map(lambda a: a[None], out0)
    if tail:
        state = jax.lax.fori_loop(0, tail,
                                  lambda i, s: sched.md_step_pure(s), state)
    return state, outs


def _gate_grid(cfg: FrozenTagConfig):
    """Post-tag sample-gate grid: (n_md_a, n_md_total, f, l0, n_lab).

    ``l0`` is the first gate label — the reference's
    (c0+1)%sampleFreq==0 gate first fires there — and ``n_lab`` the
    number of gates up to tmax.  Single source of the gate arithmetic
    for the fresh-run plan (:func:`_phase_b_plan`) and the resume
    continuation (:func:`_resume_continue`), which must stay in exact
    lockstep or resumed runs desynchronize from fresh ones."""
    n_md_a = int(np.ceil(cfg.tend / cfg.timestep))
    n_md_total = int(round(cfg.tmax / cfg.timestep))
    f = cfg.sample_freq
    l0 = n_md_a + (f - n_md_a % f) - 1
    n_lab = max(0, (n_md_total - 1 - l0) // f + 1)
    return n_md_a, n_md_total, f, l0, n_lab


def _phase_b_plan(cfg: FrozenTagConfig):
    """Shared post-tag schedule: (n_md_a, n_md_total, seg_lengths, tail).

    ``seg_lengths`` aligns output blocks to the global sample grid;
    ``tail`` is the MD steps past the last gate up to tmax, which the
    terminal checkpoint must include."""
    n_md_a, n_md_total, f, l0, n_lab = _gate_grid(cfg)
    if n_lab == 0:
        raise ValueError(
            f"tmax={cfg.tmax} ends before the first post-tag sample gate "
            f"(MD step {l0}); extend tmax past "
            f"{(l0 + 1) * cfg.timestep:g}")
    seg_lengths = (l0 - n_md_a + 1,) + (f,) * (n_lab - 1)
    tail = n_md_total - 1 - (l0 + (n_lab - 1) * f)
    return n_md_a, n_md_total, seg_lengths, tail


def run(cfg: FrozenTagConfig, seed: Optional[int] = None,
        resume: bool = False):
    """One frozen-tag job.  ``resume=True`` continues the newest
    checkpoint in the job's directory through tmax (the reference's
    newRun=0 walltime chaining, randomFrozenStartTag422Linear.cpp:
    987-995; post-tag only — the reference never persists wavefunctions
    for this family, so a mid-pump restart has no state to continue)."""
    if resume:
        return _resume_continue(cfg)
    state = initial_state(cfg, seed)
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    epot0 = yukawa_potential(state.R, L, pu.debye_length)

    # job/save_directory only pick seeds and output paths, not the traced
    # program — strip them so sequential jobs (cli --jobs) share one
    # compiled program (recompiles can be minutes-slow on this backend)
    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    n_md_a, n_md_total, seg_lengths, tail = _phase_b_plan(cfg)
    state = run_phase_a(cfg_run, state, n_md_a)
    state, spin_up, vholder = measure(cfg_run, state)
    out_tag = tag_instant_output(cfg_run, state, spin_up, vholder, epot0)
    state, outs = run_phase_b(cfg_run, state, spin_up, vholder, epot0,
                              seg_lengths, tail=tail)
    jax.block_until_ready(state)

    outs = jax.device_get(outs)
    out_tag = jax.device_get(out_tag)
    final = jax.device_get(state)
    spin_up_np = np.asarray(jax.device_get(spin_up))
    results = dict(outs=outs, out_tag=out_tag, spin_up=spin_up_np,
                   epot0=float(epot0), final=final, n_md_a=n_md_a,
                   vholder=np.asarray(jax.device_get(vholder)))

    if cfg.save_directory is not None:
        d = frozen_tag_dir(cfg.save_directory,
                           tpump_seconds=cfg.tpump_seconds,
                           tstart=cfg.tstart, detuning=cfg.detuning,
                           om=cfg.om, density=cfg.density, ge=cfg.ge,
                           n0=cfg.n0, job=cfg.job)
        write_outputs(d, cfg, results, n_md_total)
    return final, results


def _resume_continue(cfg: FrozenTagConfig):
    """Continue a frozen-tag job from its newest checkpoint through tmax.

    The reference restart (newRun=0) restores N/counter, SpinUpList and
    R|V, sets recordedSpinUps=1, and keeps emitting post-tag output
    blocks until the (possibly extended) tmax
    (randomFrozenStartTag422Linear.cpp:987-995,1000-1014).  From a
    native .npz checkpoint this also restores psi, the tag-instant
    velocity snapshot (so the streaming VAF/LongKin rows continue
    against the true vholder), and epot0 for the energy-audit column;
    from the ASCII schema those default to zero exactly as the
    reference's globals do after readConditions."""
    if cfg.save_directory is None:
        raise ValueError("resume needs cfg.save_directory")
    d = frozen_tag_dir(cfg.save_directory, tpump_seconds=cfg.tpump_seconds,
                       tstart=cfg.tstart, detuning=cfg.detuning, om=cfg.om,
                       density=cfg.density, ge=cfg.ge, n0=cfg.n0,
                       job=cfg.job)
    from .laser_cooling import latest_checkpoint
    c0_native = latest_checkpoint(d)
    c0_ascii = ckpt.latest_ascii_checkpoint(d)
    if c0_native is None and c0_ascii is None:
        raise FileNotFoundError(f"no checkpoint under {d}")
    # newest checkpoint wins across formats: after the reference binary
    # continues a framework run (interop chaining) only ASCII
    # conditions_/spinUpIonsList_ files advance, and resuming from a
    # stale native .npz would replay covered steps and duplicate rows
    native = None
    if c0_native is not None and (c0_ascii is None or c0_native >= c0_ascii):
        c0 = c0_native
        native = ckpt.load_native(d, c0)
    else:
        c0 = c0_ascii

    n_md_a, n_md_total, f, l0, n_lab = _gate_grid(cfg)
    if c0 < n_md_a:
        raise ValueError(
            f"checkpoint c0={c0} precedes the pump end (MD step "
            f"{n_md_a}); the frozen-tag schema never persists mid-pump "
            "wavefunctions (reference parity) so only post-tag resume "
            "is possible")
    labels = [l0 + k * f for k in range(max(0, (c0 - l0) // f + 1), n_lab)]
    if not labels and n_md_total <= c0 + 1:
        raise ValueError(f"checkpoint c0={c0} already covers "
                         f"tmax={cfg.tmax}; extend tmax to continue")

    rdt = cfg.np_dtype
    cdt = jnp.complex64 if cfg.dtype == "float32" else jnp.complex128
    if native is not None:
        R, V = native["R"], native["V"]
        n = R.shape[0]
        psi = native.get("psi", np.zeros((n, cfg.n_states), np.complex64))
        spin_up = native["spin_up"].astype(bool)
        vholder = native.get("vholder", np.zeros(n))
        epot0 = float(native.get("epot0", 0.0))
        counter = int(native["counter"])
    else:
        R, V = ckpt.read_conditions(d, c0)
        n = R.shape[0]
        psi = np.zeros((n, cfg.n_states), np.complex64)
        spin_up = ckpt.read_spinup_list(d, c0).astype(bool)
        if spin_up.shape[0] != n:
            raise ValueError(
                f"{d}/spinUpIonsList_timestep{c0:06d}.dat has "
                f"{spin_up.shape[0]} rows for {n} ions — truncated or "
                "mismatched member checkpoint")
        vholder = np.zeros(n)
        epot0 = 0.0
        _, counter = ckpt.read_ions(d, c0)

    key = jax.random.PRNGKey(cfg.job * 7919 + c0)
    st = make_state(jnp.asarray(R, rdt), jnp.asarray(V, rdt),
                    jnp.asarray(psi, cdt), key, dtype=cfg.np_dtype,
                    t=(c0 + 1) * cfg.timestep)
    st = st._replace(tick=jnp.asarray((c0 + 1) * cfg.ratio, jnp.int32))
    spin_up = jnp.asarray(spin_up)
    vholder = jnp.asarray(vholder, rdt)

    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    if labels:
        segs = (labels[0] - c0,) + (f,) * (len(labels) - 1)
        tail = n_md_total - (labels[-1] + 1)
        st, outs = run_phase_b(cfg_run, st, spin_up, vholder, epot0,
                               tuple(segs), tail=tail)
    else:
        # tail-only extension: no sample gate fits in the new window, but
        # the reference binary would still step to tmax and republish its
        # terminal conditions — advance without output rows
        outs = None
        sched = build_scheduler(cfg_run)
        st = jax.jit(lambda s: jax.lax.fori_loop(
            0, n_md_total - (c0 + 1),
            lambda i, x: sched.md_step_pure(x), s))(st)
    jax.block_until_ready(st)

    if outs is not None:
        outs = jax.device_get(outs)
    final = jax.device_get(st)
    spin_np = np.asarray(jax.device_get(spin_up))
    results = dict(outs=outs, spin_up=spin_np, epot0=epot0, final=final,
                   n_md_a=n_md_a, labels=labels,
                   vholder=np.asarray(jax.device_get(vholder)))

    w = DatWriter(d)
    if outs is not None:
        bins = centered_bins_np()
        energies = np.concatenate([outs["t"][:, None], outs["energies"]],
                                  axis=1)
        w.append("energies.dat", energies)
        moments = np.concatenate([outs["t"][:, None], outs["moments"]],
                                 axis=1)
        w.append("taggedMoments.dat", moments)
        ac = outs["long_kin" if cfg.variant == "408quad" else "vaf"]
        w.append("vSquareAutoCorr.dat" if cfg.variant == "408quad"
                 else "VAF.dat", np.stack([outs["t"], ac], -1))
        for k, lab in enumerate(labels):
            w.write(f"vel_distX_timestep{lab:06d}.dat",
                    np.stack([bins, outs["pvel_x"][k]], -1))
    c0f = n_md_total - 1
    new_counter = counter + len(labels)
    ckpt.write_ions(d, c0f, n, new_counter)
    ckpt.write_conditions(d, c0f, np.asarray(final.R), np.asarray(final.V))
    ckpt.write_spinup_list(d, c0f, spin_np.astype(int))
    ckpt.save_native(d, c0f, R=final.R, V=final.V, psi=final.psi,
                     counter=new_counter, spin_up=spin_np,
                     vholder=results["vholder"],
                     extra={"epot0": epot0})
    return final, results


def _run_batched(cfg: FrozenTagConfig, member_cfgs, keys, qt_params=None,
                 mesh=None, mask=None):
    """vmap all three phases over the member axis (one compiled program;
    pair forces and the pump-window QT scan are member-parallel XLA),
    fetch once, write each member's .dat tree under its own
    param-encoded directory.
    ``qt_params``: optional [E]-batched QTParams pytree (sweep folds).
    ``mesh`` shards the member axis over the mesh's ``ens`` devices
    (parallel/ensemble.member_sharded — zero collectives).
    ``mask [E, n_arr]`` gives each member its own Poissonian ion count
    inside the fixed-shape fold (reference init draws a fresh N per
    array job, randomFrozenStartTag422Linear.cpp:245-303): members are
    padded to the largest draw, padded lanes start R=V=psi=0 and stay
    exactly inert (both-side pair-force masking; dp=0 never jumps), and
    every 1/N normalization uses the member's real count.  Lane-major
    roll draws (scheduler.md_step) keep each ion's RNG stream independent
    of the padded lane count, so a member reproduces its exact-shape run
    up to f32 rounding (the chunked force sum reduces over the lane
    count)."""
    cfg_run = dataclasses.replace(cfg, job=1, save_directory=None)
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    n_md_a, n_md_total, seg_lengths, tail = _phase_b_plan(cfg)
    n_arr = cfg.n0 if mask is None else mask.shape[1]

    def init_one(key, mk=None):
        k_init, k_run = jax.random.split(key)
        if mk is None:
            R, V, psi, _ = frozen_gas_init(k_init, cfg.n0,
                                           n_states=cfg.n_states,
                                           exact_n=True, dtype=cfg.np_dtype)
        else:
            # frozen_gas_init's draw layout at the padded lane count, with
            # padded lanes zeroed (same L: the cell is set by N0, the
            # member's count fluctuates inside it as in the reference)
            from ..core.init import frozen_gas_positions
            from ..core.qt import random_s_superposition
            kr, kp = jax.random.split(k_init)
            mc = mk.astype(cfg.np_dtype)[:, None]
            R = frozen_gas_positions(kr, n_arr, L, cfg.np_dtype) * mc
            V = jnp.zeros((n_arr, 3), cfg.np_dtype)
            cdtype = (jnp.complex64 if cfg.np_dtype == jnp.float32
                      else jnp.complex128)
            psi = random_s_superposition(kp, n_arr, cfg.n_states,
                                         cdtype) * mc
        st = make_state(R, V, psi, k_run, dtype=cfg.np_dtype)
        forces_fn = best_forces_fn(n_arr, L, pu.debye_length, mask=mk)
        F, _ = forces_fn(st.R)
        return st._replace(F=F)

    if mask is None:
        states = jax.jit(jax.vmap(init_one))(keys)
    else:
        states = jax.jit(jax.vmap(init_one))(keys, mask)

    def member(s, p=None, mk=None):
        e = yukawa_potential(s.R, L, pu.debye_length, mask=mk)
        s = run_phase_a(cfg_run, s, n_md_a, qt_params=p, mask=mk)
        s, spin_up, vholder = measure(cfg_run, s)
        out_tag = tag_instant_output(cfg_run, s, spin_up, vholder, e,
                                     mask=mk)
        s, outs = run_phase_b(cfg_run, s, spin_up, vholder, e, seg_lengths,
                              mask=mk, tail=tail)
        return s, spin_up, e, out_tag, outs, vholder

    if mask is None:
        fn = jax.vmap(member)
        args = (states,) if qt_params is None else (states, qt_params)
    elif qt_params is None:
        fn = jax.vmap(lambda s, mk: member(s, mk=mk))
        args = (states, mask)
    else:                      # Poissonian-N sweep members
        fn = jax.vmap(lambda s, p, mk: member(s, p, mk))
        args = (states, qt_params, mask)
    if mesh is not None:
        from ..parallel.ensemble import member_sharded
        fn = member_sharded(fn, mesh)
    states, spin_up, epot0, out_tag, outs, vholder = jax.jit(fn)(*args)
    jax.block_until_ready(states)

    outs_np = jax.device_get(outs)
    out_tag_np = jax.device_get(out_tag)
    final_np = jax.device_get(states)
    spin_np = np.asarray(jax.device_get(spin_up))
    epot0_np = np.asarray(jax.device_get(epot0))
    vhold_np = np.asarray(jax.device_get(vholder))
    n_js = (None if mask is None
            else np.asarray(mask).sum(axis=1).astype(int))

    results = []
    for j, mcfg in enumerate(member_cfgs):
        res = dict(outs=jax.tree.map(lambda a: a[j], outs_np),
                   out_tag=jax.tree.map(lambda a: a[j], out_tag_np),
                   spin_up=spin_np[j], epot0=float(epot0_np[j]),
                   final=jax.tree.map(lambda a: a[j], final_np),
                   n_md_a=n_md_a, vholder=vhold_np[j])
        if n_js is not None:
            # checkpoints and the spin list carry the member's real N
            nj = int(n_js[j])
            res["final"] = jax.tree.map(
                lambda a: a[:nj] if getattr(a, "ndim", 0) and
                a.shape[0] == n_arr else a, res["final"])
            res["spin_up"] = res["spin_up"][:nj]
            res["vholder"] = res["vholder"][:nj]
            res["n_ions"] = nj
        results.append(res)
        if mcfg.save_directory is not None:
            d = frozen_tag_dir(mcfg.save_directory,
                               tpump_seconds=mcfg.tpump_seconds,
                               tstart=mcfg.tstart, detuning=mcfg.detuning,
                               om=mcfg.om, density=mcfg.density,
                               ge=mcfg.ge, n0=mcfg.n0, job=mcfg.job)
            write_outputs(d, mcfg, res, n_md_total)
    return results


def run_ensemble(cfg: FrozenTagConfig, n_jobs: int, seed: int = 0,
                 mesh=None, resume: bool = False):
    """Batched job array — the batched replacement for the
    reference's SLURM array over randomFrozenStartTag* jobs
    (README.md:63: pooled statistics need 10+ jobs).  Per-job .dat trees
    land in ``job<k>/`` exactly as the array jobs' would.  Returns the
    per-job results list.  ``mesh`` spreads jobs over the mesh's ``ens``
    devices.  With ``cfg.exact_n=False`` every member draws its own
    Poissonian ion count as the reference's array jobs do
    (randomFrozenStartTag422Linear.cpp:245-303), carried as per-member
    masks inside one fixed-shape fold (see _run_batched).

    ``resume=True`` continues every job's newest checkpoint through an
    extended tmax (per-job newRun=0 chaining, see _resume_continue);
    the jitted continuation canonicalizes job away, so all exact-N jobs
    share one compiled program."""
    if resume:
        if mesh is not None:
            # each job continues from its own checkpoint (formats and ion
            # counts can differ per job), which does not fold into one
            # fixed-shape mesh program — be loud rather than silently
            # serializing what the caller asked to spread over devices
            import warnings
            warnings.warn(
                "frozen-tag run_ensemble(resume=True) continues jobs "
                "sequentially on the default device; the mesh argument "
                "is ignored on resume", stacklevel=2)
        return [
            run(dataclasses.replace(cfg, job=j + 1), resume=True)[1]
            for j in range(n_jobs)]
    keys = jax.random.split(jax.random.PRNGKey(seed), n_jobs)
    member_cfgs = [dataclasses.replace(cfg, job=j + 1)
                   for j in range(n_jobs)]
    mask = None if cfg.exact_n else _poisson_mask(cfg.n0, n_jobs, seed)
    return _run_batched(cfg, member_cfgs, keys, mesh=mesh, mask=mask)


def _poisson_mask(n0: int, n_members: int, seed: int) -> jax.Array:
    """[E, max(N_j)] real-ion mask with per-member Poissonian counts
    (the reference's per-job init draw, SURVEY.md L2)."""
    from ..core.init import poisson_member_mask
    m, _ = poisson_member_mask(n0, n_members, seed)
    return jnp.asarray(m)


def run_sweep(cfg: FrozenTagConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None):
    """Run a pump-laser (detuning, om) grid as ONE vmapped program.

    The reference compiles the pump detuning and Rabi frequency into each
    tagging binary (randomFrozenStartTag422Linear.cpp:55-57) and rebuilds
    per point; mapping the tagged velocity class vs detuning therefore
    costs a rebuild + SLURM array per point.  Here the pump Hamiltonian
    is linear in both knobs, so each member carries its own traced
    QTParams (core/qt.sweep_qt_params: e0 = detuning*e0_unit, coupling =
    om*C_unit) through the vmapped pump window — every grid point costs
    one more batched member.

    ``points``: dicts with keys among ``detuning``/``om`` (unset fields
    keep cfg's value).  ``jobs_per_point`` replicates each point with
    independent seeds; member order is point-major.  With
    ``cfg.save_directory`` set, each member writes the full reference
    .dat tree under its own detuning/om-encoded directory.  With
    ``cfg.exact_n=False`` every member additionally draws its own
    Poissonian ion count (per-member masks, as run_ensemble).  Returns
    ``(results, member_cfgs)``."""
    from ..core.qt import sweep_member_params
    cdtype = jnp.complex64 if cfg.dtype == "float32" else jnp.complex128
    member_cfgs, params = sweep_member_params(
        cfg, points, jobs_per_point, cfg.scheme_unit(), cfg.np_dtype,
        cdtype)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(member_cfgs))
    mask = (None if cfg.exact_n
            else _poisson_mask(cfg.n0, len(member_cfgs), seed))
    results = _run_batched(cfg, member_cfgs, keys, qt_params=params,
                           mesh=mesh, mask=mask)
    return results, member_cfgs


def write_outputs(directory: str, cfg: FrozenTagConfig, res: dict,
                  n_md_total: int) -> None:
    w = DatWriter(directory)
    outs = res["outs"]
    out_tag = res["out_tag"]
    bins = centered_bins_np()

    # tag-instant emission: the VAF/LongKin tau=0 normalization row for
    # every variant; the 408 variants additionally call output() there
    # (see tag_instant_output) so their other streams get the row too.
    full_tag_row = cfg.variant != "422linear"
    if full_tag_row:
        outs = {k: np.concatenate([np.asarray(out_tag[k])[None], v])
                for k, v in outs.items()}
        ac_t = outs["t"]
        ac = outs["long_kin" if cfg.variant == "408quad" else "vaf"]
    else:
        # only 422linear reaches here (full_tag_row covers the 408s),
        # and its autocorrelation stream is the x-only VAF
        ac_t = np.concatenate([[out_tag["t"]], outs["t"]])
        ac = np.concatenate([[out_tag["vaf"]], outs["vaf"]])
    n_samples = outs["t"].shape[0]

    # c0 at the measurement instant: the reference has completed
    # n_md_a = ceil(tend/dt) step() calls there and its counter runs one
    # behind (init sets c0=-1, randomFrozenStartTag422Linear.cpp:302), so
    # measureSpinUps names the file with c0 = n_md_a - 1 (:617)
    c0_tag = res["n_md_a"] - 1
    w.write_text(f"spinUpIons_timestep{c0_tag:06d}.dat",
                 str(int(out_tag["n_up"])))

    energies = np.concatenate([outs["t"][:, None], outs["energies"]], axis=1)
    w.append("energies.dat", energies)
    moments = np.concatenate([outs["t"][:, None], outs["moments"]], axis=1)
    w.append("taggedMoments.dat", moments)
    if cfg.variant == "408quad":
        w.append("vSquareAutoCorr.dat", np.stack([ac_t, ac], -1))
    else:
        w.append("VAF.dat", np.stack([ac_t, ac], -1))
    # File numbering matches the reference's global MD-step counter: the
    # output gate (c0+1)%sampleFreq==0 (randomFrozenStartTag422Linear.cpp
    # :1009) first fires at c0 = n_md_a + first - 1 and then every
    # sampleFreq steps; the 408 variants additionally emit at the tag
    # instant itself, labeled c0_tag = n_md_a - 1 (the reference's
    # counter runs one behind its completed step() calls — see the
    # c0_tag derivation above).
    f = cfg.sample_freq
    first_len = f - (res["n_md_a"] % f)
    labels = [res["n_md_a"] + first_len - 1 + j * f
              for j in range(n_samples)]
    if full_tag_row:
        labels = [c0_tag] + labels[:-1]
    for k in range(n_samples):
        w.write(f"vel_distX_timestep{labels[k]:06d}.dat",
                np.stack([bins, outs["pvel_x"][k]], -1))

    c0 = n_md_total - 1
    n = res["final"].R.shape[0]
    ckpt.write_ions(directory, c0, n, n_samples)
    ckpt.write_conditions(directory, c0, np.asarray(res["final"].R),
                          np.asarray(res["final"].V))
    ckpt.write_spinup_list(directory, c0, res["spin_up"].astype(int))
    ckpt.save_native(directory, c0, R=res["final"].R, V=res["final"].V,
                     psi=res["final"].psi, counter=n_samples,
                     spin_up=res["spin_up"],
                     vholder=res.get("vholder"),
                     extra={"epot0": res["epot0"]})
