"""Validation gallery (VERDICT round-4 item 8): render the curves the
reference's users actually look at (README.md:103-142 output schema) as
framework-vs-compiled-reference overlays, and write docs/VALIDATION.md.

Panels (each overlays pooled reference .dat output from the
tools/validate_all.py workdirs against freshly computed framework
pools at the matched shrunken configs, CPU f64):

  * DIH rise / peak / oscillation / plateau: pooled EkinX(t), flagship
    at N0=600, tmax=6 (the dih_pooled configuration);
  * normalized VAF(t) and g(r): transport at N=512, Gamma=3, kappa=0.5
    (the pooled-transport configuration; 8 jobs per side);
  * frozen-start 422 tagging: pooled tagged <vx>(t) after the tag
    instant (the velocity-selective pumping signature);
  * 3-state Doppler cooling: normalized EkinX(t) single-job overlay.

Requires the validate_all workdirs (reference binaries already run):
  dih:      <workroot>/dih/refdata_dih/*/job*/energies.dat
  transport:<xval>/refdata/*/job*/{VAF.dat,pairPairCorrStepNum500.dat}
  frozen:   <workroot>/frozen_422/refdata_422linear/*/job*/taggedMoments.dat
  3-state:  <workroot>/three_state/refdata/**/job1/energies.dat
Panels whose reference tree is missing are skipped with a note.

Usage: python tools/validation_gallery.py [--workroot /tmp/validate_all]
           [--xval /tmp/xval_transport_pooled] [--jobs 8]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# categorical slots 1-2 of the skill-validated reference palette, fixed
# order: blue = compiled reference, orange = this framework (identity is
# constant across every panel)
C_REF = "#2a78d6"
C_FW = "#eb6834"
GRID = dict(color="#d9d8d4", linewidth=0.6)


def _pool(files, cols=None):
    """[jobs, rows(, cols)] stack truncated to the shortest job."""
    tabs = [np.loadtxt(f, ndmin=2) for f in files]
    n = min(t.shape[0] for t in tabs)
    out = np.stack([t[:n] for t in tabs])
    return out if cols is None else out[:, :, cols]


def _style(ax, xlabel, ylabel, title):
    ax.grid(True, **GRID)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title, fontsize=10, loc="left")


def _overlay(ax, t, ref_pool, fw_pool, ylabel, title, xlabel):
    """Pooled mean lines with a +-1 job-sd band on the reference."""
    rm, rs = ref_pool.mean(0), ref_pool.std(0, ddof=1)
    fm = fw_pool.mean(0)
    ax.fill_between(t, rm - rs, rm + rs, color=C_REF, alpha=0.18,
                    linewidth=0)
    ax.plot(t, rm, color=C_REF, linewidth=2,
            label=f"reference ({ref_pool.shape[0]} jobs, +-1 sd)")
    ax.plot(t, fm, color=C_FW, linewidth=2,
            label=f"framework ({fw_pool.shape[0]} jobs)")
    _style(ax, xlabel, ylabel, title)
    ax.legend(frameon=False, fontsize=8)


def panel_dih(args, ax):
    ref_files = sorted(glob.glob(os.path.join(
        args.workroot, "dih", "refdata_dih", "*", "job*",
        "energies.dat")))[:args.jobs]
    if not ref_files:
        return "dih: no reference tree (run validate_all dih_pooled)"
    from mdqtplasmasims_tpu.experiments.laser_cooling import (
        CoolingConfig, run)
    ref = _pool(ref_files)
    fw = []
    for j in range(args.jobs):
        cfg = CoolingConfig(n0=600, tmax=6.0, sample_freq=20,
                            dtype="float64",
                            job=j + 1)
        _, res = run(cfg)
        o = res["outs"]
        fw.append(np.stack([np.asarray(o["t"]),
                            np.asarray(o["ekin"])[:, 0]], -1))
    n = min(min(f.shape[0] for f in fw), ref.shape[1])
    fw = np.stack([f[:n] for f in fw])
    _overlay(ax, ref[0, :n, 0], ref[:, :n, 1], fw[:, :, 1],
             "EkinX [E_c]", "Disorder-induced heating + oscillation "
             "(flagship, N0=600)", "t [1/omega_E]")
    return None


def panel_transport(args, ax_vaf, ax_gr):
    base = os.path.join(args.xval, "refdata", "*", "job*")
    vaf_files = sorted(glob.glob(os.path.join(
        base, "VAF.dat")))[:args.jobs]
    if not vaf_files:
        return "transport: no reference tree (run transport_pooled)"
    from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import (
        MCTransportConfig, run_ensemble)
    cfg = MCTransportConfig(
        n=512, kappa=0.5, gamma=3.0, density=0.4, mc_steps=30_000,
        gr_every_mc=10_000, pre_record_md_steps=200, record_steps=600,
        gr_every_record=100, instant_aniso_steps=8, reequil_steps=8,
        aniso_time_us=0.1, aniso_relax_steps=8, dtype="float64")
    res = run_ensemble(cfg, args.jobs, seed=7)

    ref = _pool(vaf_files)
    refn = ref[:, :, 1] / ref[:, :1, 1]
    fwn = np.stack([np.asarray(r["vaf"]) / np.asarray(r["vaf"])[0]
                    for r in res])
    n = min(refn.shape[1], fwn.shape[1], 300)
    _overlay(ax_vaf, ref[0, :n, 0], refn[:, :n], fwn[:, :n],
             "VAF(t)/VAF(0)", "Velocity autocorrelation "
             "(transport, N=512, Gamma=3, kappa=0.5)",
             "lag [1/omega_E]")

    gr_files = sorted(glob.glob(os.path.join(
        base, "pairPairCorrStepNum500.dat")))[:args.jobs]
    refg = _pool(gr_files)
    fwg = np.stack([np.asarray(r["gr_record"][-1])[:refg.shape[1]]
                    for r in res])
    _overlay(ax_gr, refg[0, :, 0], refg[:, :, 1], fwg,
             "g(r)", "Pair correlation at the last record snapshot",
             "r [a]")
    ax_gr.set_xlim(0, 5)
    return None


def panel_frozen(args, ax):
    ref_files = sorted(glob.glob(os.path.join(
        args.workroot, "frozen_422", "refdata_422linear", "*", "job*",
        "taggedMoments.dat")))[:args.jobs]
    if not ref_files:
        return "frozen: no reference tree (run frozen_pooled_422)"
    from mdqtplasmasims_tpu.experiments.frozen_tagging import (
        FrozenTagConfig, run)
    ref = _pool(ref_files)
    fw, fw_t = [], None
    for j in range(args.jobs):
        cfg = FrozenTagConfig(variant="422linear", n0=600, tstart=1.0,
                              tmax=2.0, sample_freq=10,
                              dtype="float64",
                              job=j + 1)
        _, res = run(cfg)
        # outs["moments"] is the post-tag tagged-moment time series;
        # the 422 reference's taggedMoments row 0 is its first post-tag
        # sample too (cross_validate_frozen_pooled alignment note)
        fw.append(np.asarray(res["outs"]["moments"])[:, 0])
        fw_t = np.asarray(res["outs"]["t"])
    n = min(ref.shape[1], min(len(f) for f in fw))
    fwp = np.stack([f[:n] for f in fw])
    _overlay(ax, fw_t[:n] - fw_t[0], ref[:, :n, 1], fwp,
             "tagged <vx> [a omega_E]",
             "Velocity-selective 422 tagging: tagged-class <vx>(t) "
             "(frozen start, N0=600)", "t since tag [1/omega_E]")
    return None


def panel_three_state(args, ax):
    # the 3-state reference nests TWO parameter directory levels
    # (saveDirectory/Om<..>/Det<..>.../jobN, laserCoolNoPlasmaThreeState
    # .cpp dirMaker) — match any depth
    ref_files = glob.glob(os.path.join(
        args.workroot, "three_state", "refdata", "**", "job1",
        "energies.dat"), recursive=True)
    if not ref_files:
        return "three_state: no reference tree (run three_state)"
    from mdqtplasmasims_tpu.experiments.three_state import (
        ThreeStateConfig, run)
    ref = np.loadtxt(ref_files[0], ndmin=2)
    res = run(ThreeStateConfig(n0=1000, tmax=float(ref[-1, 0]),
                               sample_freq=1000))
    n = min(ref.shape[0], len(res["t"]))
    ax.plot(ref[:n, 0], ref[:n, 1] / ref[0, 1], color=C_REF,
            linewidth=2, label="reference (1 job)")
    ax.plot(np.asarray(res["t"])[:n],
            np.asarray(res["ekin_x"])[:n] / res["ekin_x"][0],
            color=C_FW, linewidth=2, label="framework (1 job)")
    _style(ax, "t [1/gamma]", "EkinX(t)/EkinX(0)",
           "3-state Doppler cooling (N0=1000, free ions)")
    ax.legend(frameon=False, fontsize=8)
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workroot", default="/tmp/validate_all")
    ap.add_argument("--xval", default="/tmp/xval_transport_pooled")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(REPO, "docs"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from mdqtplasmasims_tpu.util import enable_compilation_cache
    enable_compilation_cache()
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgdir = os.path.join(args.out, "img")
    os.makedirs(imgdir, exist_ok=True)
    notes = []
    fig, axes = plt.subplots(3, 2, figsize=(11, 12), dpi=130)
    fig.patch.set_facecolor("#fcfcfb")
    for ax in axes.ravel():
        ax.set_facecolor("#fcfcfb")
    for fn, axs in ((panel_dih, (axes[0, 0],)),
                    (panel_transport, (axes[0, 1], axes[1, 0])),
                    (panel_frozen, (axes[1, 1],)),
                    (panel_three_state, (axes[2, 0],))):
        try:
            note = fn(args, *axs)
        except Exception as e:       # a missing tree must not kill the rest
            note = f"{fn.__name__}: failed ({e})"
        if note:
            notes.append(note)
            print("note:", note)
        else:
            print(f"{fn.__name__}: ok", flush=True)
    axes[2, 1].axis("off")
    fig.tight_layout()
    png = os.path.join(imgdir, "validation_overlays.png")
    fig.savefig(png)
    print("wrote", png)

    md = ["# Validation gallery", "",
          "Framework (orange) vs the compiled reference binaries (blue, "
          "pooled over jobs with a +-1 job-sd band) at the matched "
          "shrunken configurations of tools/validate_all.py — the "
          "curves the reference's users look at (README.md:103-142).",
          "", "![validation overlays](img/validation_overlays.png)", ""]
    if notes:
        md += ["Skipped panels:", ""] + [f"- {n}" for n in notes] + [""]
    matrix = os.path.join(REPO, "artifacts", "validate_all", "MATRIX.md")
    if os.path.exists(matrix):
        md += ["## Machine-checked matrix", ""]
        md += open(matrix).read().splitlines()[2:]
        md += ["", "(regenerate: `python tools/validate_all.py`; full "
               "logs in artifacts/validate_all/logs/)"]
    with open(os.path.join(args.out, "VALIDATION.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    print("wrote", os.path.join(args.out, "VALIDATION.md"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
