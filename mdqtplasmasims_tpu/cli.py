"""Config-driven command-line runner.

One CLI replaces the reference's 11 copy-edited ``main()``s (each of which
had to be recompiled to change a parameter — README.md:40-55).  Every
experiment family is a subcommand whose flags are generated from its config
dataclass:

    python -m mdqtplasmasims_tpu.cli cooling --n0 3500 --tmax 30 \
        --save-directory dataLaserCool/ --job 1
    python -m mdqtplasmasims_tpu.cli frozen-tag --variant 422linear ...
    python -m mdqtplasmasims_tpu.cli mc-tag --variant 408quad ...
    python -m mdqtplasmasims_tpu.cli transport --n 4096 --gamma 3 ...
    python -m mdqtplasmasims_tpu.cli three-state --detuning -0.5 ...
    python -m mdqtplasmasims_tpu.cli cooling-ensemble --jobs 16 ...

``--job N`` replaces the SLURM array index (exampleSlurmFile.slurm:16); an
ensemble subcommand batches trajectories on-device instead.  ``--mesh-ens
K`` spreads a batched job array / sweep over K devices of a mesh (plus
``--mesh-ions I`` ion sharding for the cooling family's large-N mode).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import types
import typing


def _parse_bool(s: str) -> bool:
    v = s.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        t = hints.get(f.name, str)
        origin = typing.get_origin(t)
        if origin in (typing.Union, types.UnionType):   # Optional / X | None
            args = [a for a in typing.get_args(t) if a is not type(None)]
            t = args[0] if args else str
        default = f.default if f.default is not dataclasses.MISSING else None
        if t is bool:
            parser.add_argument(name, type=_parse_bool, default=default,
                                metavar="BOOL")
        elif t is tuple or origin is tuple:
            parser.add_argument(name, type=lambda s: tuple(
                float(x) for x in s.split(",") if x), default=default,
                metavar="CSV")
        elif t in (int, float, str):
            parser.add_argument(name, type=t, default=default)
        # unsupported field types are construction-time only


def _sweep_points(parser, grids: dict, cross: bool):
    """CSV grids -> sweep-point dicts: full cartesian product under
    ``cross``, else zipped (length-1 grids broadcast as constants)."""
    if cross:
        points = [{}]
        for key, vals in grids.items():
            points = [{**p, key: v} for p in points for v in vals]
        return points
    n_pts = max(len(v) for v in grids.values())
    for key, vals in grids.items():
        if len(vals) == 1:
            grids[key] = vals * n_pts           # broadcast constants
        elif len(vals) != n_pts:
            parser.error("zipped sweep needs equal-length grids "
                         "(use --cross for a product)")
    return [{k: grids[k][i] for k in grids} for i in range(n_pts)]


def _add_mesh_args(parser: argparse.ArgumentParser,
                   ions: bool = False) -> None:
    parser.add_argument("--mesh-ens", type=int, default=0, metavar="K",
                        help="spread members over a K-device mesh ens "
                             "axis (multi-chip job array; members must "
                             "divide evenly)")
    if ions:
        parser.add_argument("--mesh-ions", type=int, default=1,
                            metavar="I",
                            help="additionally shard each member's ion "
                                 "axis over I devices (mesh uses K*I "
                                 "devices; large-N only)")


def _mesh_from_flags(ns: argparse.Namespace):
    k = getattr(ns, "mesh_ens", 0)
    if not k:
        return None
    from .parallel.mesh import make_mesh
    return make_mesh(n_ens=k, n_ions=getattr(ns, "mesh_ions", 1))


def _build_cfg(cls, ns: argparse.Namespace):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if hasattr(ns, f.name) and getattr(ns, f.name) is not None:
            kwargs[f.name] = getattr(ns, f.name)
    return cls(**kwargs)


def _version_string() -> str:
    try:
        from importlib.metadata import version
        return version("mdqtplasmasims_tpu")
    except Exception:          # running from a source tree, not installed
        return "0.1.0+src"


def _add_host_subcommands(sub) -> None:
    """The host-only (no JAX) subcommands: plot and analyze."""
    pp = sub.add_parser(
        "plot",
        help="render the quicklook PNG summary of a job directory's "
             ".dat output tree (any family; see quicklook.py)")
    pp.add_argument("job_dir")
    pp.add_argument("-o", "--out", default=None,
                    help="output PNG (default <job_dir>/quicklook.png)")

    pa = sub.add_parser(
        "analyze",
        help="numeric summary of a job directory's .dat tree: energies/"
             "audit, temperatures, Green-Kubo D, L+T dispersion, S(k), "
             "g(r), tagged moments (analysis.analyze_job)")
    pa.add_argument("job_dir")
    pa.add_argument("--timestep", type=float, default=0.002,
                    help="MD step in omega_E^-1 for the dispersion time "
                         "axis (default 0.002)")
    pa.add_argument("--max-shell", type=int, default=None,
                    help="largest integer |k|^2 shell for dispersion/S(k)")
    pa.add_argument("--skip", type=int, default=0,
                    help="initial J samples to drop (e.g. the DIH "
                         "transient)")
    pa.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON instead of text")


def _dispatch_host(ns, parser) -> int:
    """Run a host-only subcommand (returns 0; errors via parser.error)."""
    if ns.cmd == "plot":
        from .quicklook import render
        try:
            print(render(ns.job_dir, ns.out))
        except ValueError as e:
            parser.error(str(e))
        return 0
    import glob as _glob
    from .analysis import (analyze_ensemble, analyze_job,
                           format_ensemble_report, format_job_report)
    # a parameter directory (job* subdirs) pools across jobs
    ensemble = bool(_glob.glob(os.path.join(ns.job_dir, "job*")))
    try:
        if ensemble:
            rep = analyze_ensemble(ns.job_dir, timestep=ns.timestep,
                                   max_shell=ns.max_shell,
                                   skip=ns.skip)
        else:
            rep = analyze_job(ns.job_dir, timestep=ns.timestep,
                              max_shell=ns.max_shell, skip=ns.skip)
    except ValueError as e:
        parser.error(str(e))
    if ns.as_json:
        import json
        print(json.dumps(rep, indent=1))
    else:
        print(format_ensemble_report(rep) if ensemble
              else format_job_report(rep))
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    # fast path: --version / plot / analyze are pure host commands —
    # dispatch them before the JAX + experiment-family imports and the
    # compile-cache setup so `mdqt plot <dir>` starts without loading
    # JAX (quicklook keeps matplotlib lazy for the same reason)
    first_pos = next((a for a in args if not a.startswith("-")), None)
    if (args and args[0] == "--version") or first_pos in ("plot",
                                                          "analyze"):
        parser = argparse.ArgumentParser(prog="mdqt")
        parser.add_argument("--version", action="version",
                            version=f"%(prog)s {_version_string()}")
        sub = parser.add_subparsers(dest="cmd", required=True)
        _add_host_subcommands(sub)
        return _dispatch_host(parser.parse_args(args), parser)
    argv = args

    from .util import enable_compilation_cache
    enable_compilation_cache()
    from .experiments import (frozen_tagging, laser_cooling,
                              mc_md_anisotropy, mc_qt_tagging, three_state)

    families = {
        "cooling": (laser_cooling.CoolingConfig, laser_cooling.run),
        "frozen-tag": (frozen_tagging.FrozenTagConfig, frozen_tagging.run),
        "mc-tag": (mc_qt_tagging.MCTagConfig, mc_qt_tagging.run),
        "transport": (mc_md_anisotropy.MCTransportConfig,
                      mc_md_anisotropy.run),
        "three-state": (three_state.ThreeStateConfig, three_state.run),
    }
    # families with an on-device batched job array (one vmapped program)
    batched = {
        "frozen-tag": frozen_tagging.run_ensemble,
        "mc-tag": mc_qt_tagging.run_ensemble,
        "transport": mc_md_anisotropy.run_ensemble,
        "three-state": three_state.run_ensemble,
    }

    parser = argparse.ArgumentParser(prog="mdqt")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {_version_string()}")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, (cls, _) in families.items():
        p = sub.add_parser(name)
        _add_dataclass_args(p, cls)
        p.add_argument("--jobs", type=int, default=0, metavar="K",
                       help="run jobs 1..K sequentially in-process (the "
                            "SLURM-array replacement; the compiled program "
                            "is shared across jobs)")
        if name in ("cooling", "frozen-tag"):
            p.add_argument("--resume", action="store_true",
                           help="continue from the newest checkpoint "
                                "(the reference's newRun=0 walltime "
                                "chaining; frozen-tag resumes post-tag "
                                "recording)")
        if name in ("mc-tag", "transport"):
            p.add_argument("--resume", action="store_true",
                           help="continue the staged pipeline from the "
                                "newest native pipeline checkpoint "
                                "(published when "
                                "--checkpoint-every-chunks > 0; the "
                                "reference cannot checkpoint these "
                                "programs at all)")
        if name in ("frozen-tag", "mc-tag", "transport",
                    "three-state"):
            p.add_argument("--batch-jobs", type=int, default=0,
                           metavar="K",
                           help="run K jobs batched on-device in one "
                                "vmapped program (vs --jobs sequential)")
            _add_mesh_args(p)
    pe = sub.add_parser("cooling-ensemble")
    _add_dataclass_args(pe, laser_cooling.CoolingConfig)
    pe.add_argument("--jobs", type=int, default=8)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--resume", action="store_true",
                    help="rebuild the fold from the newest checkpoint "
                         "common to all job directories")
    _add_mesh_args(pe, ions=True)
    ps = sub.add_parser(
        "cooling-sweep",
        help="run a laser-parameter grid (detSP/detDP/OmSP/OmDP) as ONE "
             "fused fold — the reference recompiles the binary per point")
    _add_dataclass_args(ps, laser_cooling.CoolingConfig)
    ps.add_argument("--det-sp-values", type=str, default=None,
                    metavar="CSV", help="detSP grid, e.g. -1.0,-0.5")
    ps.add_argument("--det-dp-values", type=str, default=None,
                    metavar="CSV",
                    help="detDP grid, same length (zipped) or crossed "
                         "with --cross")
    ps.add_argument("--om-values", type=str, default=None, metavar="CSV",
                    help="OmSP grid (H is linear in each Rabi frequency, "
                         "so Om points fold like detuning points)")
    ps.add_argument("--om-dp-values", type=str, default=None,
                    metavar="CSV", help="OmDP grid")
    ps.add_argument("--cross", action="store_true",
                    help="full cartesian product of the given grids")
    ps.add_argument("--jobs-per-point", type=int, default=1)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--resume", action="store_true")
    _add_mesh_args(ps, ions=True)
    pt = sub.add_parser(
        "transport-sweep",
        help="run a (Gamma, kappa) phase-diagram grid as ONE vmapped "
             "program — the reference rebuilds the binary per point")
    _add_dataclass_args(pt, mc_md_anisotropy.MCTransportConfig)
    pt.add_argument("--gamma-values", type=str, default=None,
                    metavar="CSV", help="Gamma grid, e.g. 1,3,10,30")
    pt.add_argument("--kappa-values", type=str, default=None,
                    metavar="CSV",
                    help="kappa grid, same length (zipped) or crossed "
                         "with --cross")
    pt.add_argument("--cross", action="store_true",
                    help="full cartesian product of the given grids")
    pt.add_argument("--jobs-per-point", type=int, default=1)
    pt.add_argument("--seed", type=int, default=0)
    _add_mesh_args(pt)
    # pump-laser (detuning, om) sweeps for the QT tagging families and
    # the 3-state toy — per-member traced QTParams in one batched program
    qt_sweeps = {
        "frozen-tag-sweep": (frozen_tagging.FrozenTagConfig,
                             frozen_tagging.run_sweep),
        "mc-tag-sweep": (mc_qt_tagging.MCTagConfig,
                         mc_qt_tagging.run_sweep),
        "three-state-sweep": (three_state.ThreeStateConfig,
                              three_state.run_sweep),
    }
    for name, (cls, _) in qt_sweeps.items():
        pq = sub.add_parser(
            name,
            help="run a (detuning, om) laser grid as ONE batched program "
                 "— the reference rebuilds the binary per point")
        _add_dataclass_args(pq, cls)
        pq.add_argument("--det-values", type=str, default=None,
                        metavar="CSV", help="detuning grid, e.g. -3,-1,0")
        pq.add_argument("--om-values", type=str, default=None,
                        metavar="CSV",
                        help="Rabi grid, same length (zipped) or crossed "
                             "with --cross")
        pq.add_argument("--cross", action="store_true",
                        help="full cartesian product of the given grids")
        pq.add_argument("--jobs-per-point", type=int, default=1)
        pq.add_argument("--seed", type=int, default=0)
        _add_mesh_args(pq)

    _add_host_subcommands(sub)

    ns = parser.parse_args(argv)
    # defensive fallback only: the fast path in main() intercepts every
    # plot/analyze invocation before the full parser is built
    if ns.cmd in ("plot", "analyze"):
        return _dispatch_host(ns, parser)
    t0 = time.perf_counter()
    if ns.cmd == "cooling-sweep":
        cfg = _build_cfg(laser_cooling.CoolingConfig, ns)
        grids = {}
        for key, csv in (("detuning", ns.det_sp_values),
                         ("detuning_dp", ns.det_dp_values),
                         ("om", ns.om_values),
                         ("om_dp", ns.om_dp_values)):
            if csv is not None:
                grids[key] = [float(x) for x in csv.split(",") if x]
        if not grids:
            parser.error("give at least one of --det-sp-values/"
                         "--det-dp-values/--om-values/--om-dp-values")
        points = _sweep_points(parser, grids, ns.cross)
        final, outs, mcfgs = laser_cooling.run_sweep(
            cfg, points, jobs_per_point=ns.jobs_per_point, seed=ns.seed,
            resume=ns.resume, mesh=_mesh_from_flags(ns))
        print(f"[{ns.cmd}] {len(points)} points x {ns.jobs_per_point} "
              f"jobs in one fold, {time.perf_counter() - t0:.1f}s"
              + (f" -> {cfg.save_directory}" if cfg.save_directory else ""))
    elif ns.cmd == "transport-sweep":
        cfg = _build_cfg(mc_md_anisotropy.MCTransportConfig, ns)
        grids = {}
        for key, csv in (("gamma", ns.gamma_values),
                         ("kappa", ns.kappa_values)):
            if csv is not None:
                grids[key] = [float(x) for x in csv.split(",") if x]
        if not grids:
            parser.error("give at least one of --gamma-values/"
                         "--kappa-values")
        points = _sweep_points(parser, grids, ns.cross)
        results, mcfgs = mc_md_anisotropy.run_sweep(
            cfg, points, jobs_per_point=ns.jobs_per_point, seed=ns.seed,
            mesh=_mesh_from_flags(ns))
        print(f"[{ns.cmd}] {len(points)} points x {ns.jobs_per_point} "
              f"jobs in one vmapped program, "
              f"{time.perf_counter() - t0:.1f}s"
              + (f" -> {cfg.save_directory}" if cfg.save_directory else ""))
    elif ns.cmd in qt_sweeps:
        cls, sweep_fn = qt_sweeps[ns.cmd]
        cfg = _build_cfg(cls, ns)
        grids = {}
        for key, csv in (("detuning", ns.det_values),
                         ("om", ns.om_values)):
            if csv is not None:
                grids[key] = [float(x) for x in csv.split(",") if x]
        if not grids:
            parser.error("give at least one of --det-values/--om-values")
        points = _sweep_points(parser, grids, ns.cross)
        sweep_fn(cfg, points, jobs_per_point=ns.jobs_per_point,
                 seed=ns.seed, mesh=_mesh_from_flags(ns))
        print(f"[{ns.cmd}] {len(points)} points x {ns.jobs_per_point} "
              f"jobs in one batched program, "
              f"{time.perf_counter() - t0:.1f}s"
              + (f" -> {cfg.save_directory}" if cfg.save_directory else ""))
    elif ns.cmd == "cooling-ensemble":
        cfg = _build_cfg(laser_cooling.CoolingConfig, ns)
        final, outs = laser_cooling.run_ensemble(cfg, ns.jobs, ns.seed,
                                                 resume=ns.resume,
                                                 mesh=_mesh_from_flags(ns))
        n_samp = 0 if outs is None else outs["t"].shape[1]
        print(f"[{ns.cmd}] {ns.jobs} trajectories, "
              f"{n_samp} samples each, "
              f"{time.perf_counter() - t0:.1f}s")
    else:
        cls, runner = families[ns.cmd]
        cfg = _build_cfg(cls, ns)
        if getattr(ns, "batch_jobs", 0) > 1:
            kw = ({"resume": True} if getattr(ns, "resume", False) else {})
            batched[ns.cmd](cfg, ns.batch_jobs,
                            mesh=_mesh_from_flags(ns), **kw)
            print(f"[{ns.cmd}] {ns.batch_jobs} batched trajectories in "
                  f"{time.perf_counter() - t0:.1f}s"
                  + (f" -> {cfg.save_directory}"
                     if cfg.save_directory else ""))
        elif getattr(ns, "jobs", 0) > 1:
            # sequential in-process array (all jitted phases canonicalize
            # job away, so the compiled programs are reused across jobs);
            # --resume applies per job where the family supports it
            kw = {"resume": True} if getattr(ns, "resume", False) else {}
            for j in range(1, ns.jobs + 1):
                runner(dataclasses.replace(cfg, job=j), **kw)
                print(f"[{ns.cmd}] job {j}/{ns.jobs} at "
                      f"{time.perf_counter() - t0:.1f}s")
        elif getattr(ns, "resume", False):
            runner(cfg, resume=True)
        else:
            runner(cfg)
        print(f"[{ns.cmd}] done in {time.perf_counter() - t0:.1f}s"
              + (f" -> {cfg.save_directory}" if cfg.save_directory else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
