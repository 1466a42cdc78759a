"""Fault-injection tests for the checkpoint/interop readers (VERDICT r3
weak #6): every unreadable-state defect must raise a ``ValueError``
naming the offending file and the problem — never an opaque numpy
reshape/loadtxt traceback.  The reference's fscanf loops silently
misparse the same defects (SURVEY §5 failure-detection gap); the
framework must do strictly better.
"""

import os

import numpy as np
import pytest

from mdqtplasmasims_tpu.io import checkpoint as ckpt
from mdqtplasmasims_tpu.io.datfiles import read_rows


# ------------------------------------------------------------ fixtures ----

N, S, C0 = 16, 12, 99


@pytest.fixture
def good_ckpt(tmp_path):
    """A complete, healthy ASCII checkpoint group at c0=99."""
    rng = np.random.default_rng(0)
    d = str(tmp_path)
    R = rng.uniform(0, 5, (N, 3))
    V = rng.normal(0, 0.1, (N, 3))
    psi = rng.normal(size=(N, S)) + 1j * rng.normal(size=(N, S))
    ckpt.write_ions(d, C0, N, 3)
    ckpt.write_conditions(d, C0, R, V)
    ckpt.write_wvfns(d, C0, psi)
    ckpt.write_vzero(d, C0, rng.normal(size=(2, N, 3)))
    ckpt.write_spinup_list(d, C0, rng.integers(0, 2, N))
    return d


def _truncate(path, keep_bytes):
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def _path(d, name):
    return os.path.join(d, name)


# ----------------------------------------------------------- read_rows ----

def test_read_rows_truncated_mid_row(good_ckpt, tmp_path):
    p = _path(good_ckpt, f"conditions_timestep{C0:06d}.dat")
    size = os.path.getsize(p)
    _truncate(p, size - 20)           # cuts the last row mid-number
    with pytest.raises(ValueError, match="conditions_timestep"):
        read_rows(p, expect_cols=6)


def test_read_rows_empty_file(tmp_path):
    p = str(tmp_path / "empty.dat")
    open(p, "w").close()
    with pytest.raises(ValueError, match="empty"):
        read_rows(p)


def test_read_rows_non_numeric(tmp_path):
    p = str(tmp_path / "garbage.dat")
    with open(p, "w") as f:
        f.write("this is not\ta float table\n")
    with pytest.raises(ValueError, match="garbage.dat"):
        read_rows(p)


def test_read_rows_wrong_column_count(good_ckpt):
    p = _path(good_ckpt, f"conditions_timestep{C0:06d}.dat")
    with pytest.raises(ValueError, match="expected 7 columns"):
        read_rows(p, expect_cols=7)


def test_read_rows_mixed_column_counts(tmp_path):
    p = str(tmp_path / "ragged.dat")
    with open(p, "w") as f:
        f.write("1 2 3\n4 5\n6 7 8\n")
    with pytest.raises(ValueError, match="ragged.dat"):
        read_rows(p)


# --------------------------------------------------------- ASCII group ----

def test_conditions_row_count_vs_ions(good_ckpt):
    """conditions_ rows disagreeing with ions_'s declared N — the classic
    half-written-checkpoint defect — must be named, not misparsed."""
    p = _path(good_ckpt, f"conditions_timestep{C0:06d}.dat")
    lines = open(p).readlines()
    with open(p, "w") as f:
        f.writelines(lines[:-3])      # drop 3 complete ion rows
    with pytest.raises(ValueError, match="declares N=16"):
        ckpt.read_conditions(good_ckpt, C0, expect_n=N)


def test_ions_file_garbage(good_ckpt):
    p = _path(good_ckpt, f"ions_timestep{C0:06d}.dat")
    with open(p, "w") as f:
        f.write("sixteen three")
    with pytest.raises(ValueError, match="two integers"):
        ckpt.read_ions(good_ckpt, C0)


def test_ions_file_wrong_token_count(good_ckpt):
    p = _path(good_ckpt, f"ions_timestep{C0:06d}.dat")
    with open(p, "w") as f:
        f.write("16")
    with pytest.raises(ValueError, match="two integers"):
        ckpt.read_ions(good_ckpt, C0)


def test_wvfns_odd_columns(good_ckpt):
    p = _path(good_ckpt, f"wvFns_timestep{C0:06d}.dat")
    arr = read_rows(p)
    with open(p, "w") as f:
        for row in arr[:, :-1]:       # drop one column -> odd count
            f.write("\t".join("%g" % v for v in row) + "\n")
    with pytest.raises(ValueError, match="Re/Im pairs"):
        ckpt.read_wvfns(good_ckpt, C0)


def test_wvfns_row_count_mismatch(good_ckpt):
    with pytest.raises(ValueError, match="wavefunction rows"):
        ckpt.read_wvfns(good_ckpt, C0, expect_n=N + 5)


def test_vzero_missing_interval(good_ckpt):
    os.remove(_path(good_ckpt, f"VZERO_timestep{C0:06d}_interval1.dat"))
    with pytest.raises(ValueError, match="interval 1"):
        ckpt.read_vzero(good_ckpt, C0, 2)


def test_vzero_interval_n_mismatch(good_ckpt):
    p = _path(good_ckpt, f"VZERO_timestep{C0:06d}_interval1.dat")
    lines = open(p).readlines()
    with open(p, "w") as f:
        f.writelines(lines[:-2])
    with pytest.raises(ValueError, match="disagree on ion count"):
        ckpt.read_vzero(good_ckpt, C0, 2)


def test_spinup_list_non_binary(good_ckpt):
    p = _path(good_ckpt, f"spinUpIonsList_timestep{C0:06d}.dat")
    with open(p, "a") as f:
        f.write("7\n")
    with pytest.raises(ValueError, match="other than 0/1"):
        ckpt.read_spinup_list(good_ckpt, C0)


def test_spinup_list_garbage(good_ckpt):
    p = _path(good_ckpt, f"spinUpIonsList_timestep{C0:06d}.dat")
    with open(p, "w") as f:
        f.write("yes\nno\n")
    with pytest.raises(ValueError, match="spinUpIonsList"):
        ckpt.read_spinup_list(good_ckpt, C0)


# -------------------------------------------------------------- native ----

def test_native_truncated_npz(tmp_path):
    d = str(tmp_path)
    ckpt.save_native(d, C0, R=np.zeros((N, 3)), V=np.zeros((N, 3)))
    p = _path(d, f"checkpoint_{C0:06d}.npz")
    _truncate(p, os.path.getsize(p) // 2)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        ckpt.load_native(d, C0)


def test_native_not_a_zipfile(tmp_path):
    d = str(tmp_path)
    p = _path(d, f"checkpoint_{C0:06d}.npz")
    with open(p, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        ckpt.load_native(d, C0)


def test_native_missing_required_array(tmp_path):
    d = str(tmp_path)
    p = _path(d, f"checkpoint_{C0:06d}.npz")
    np.savez(p, R=np.zeros((N, 3)))   # no V
    with pytest.raises(ValueError, match="missing required array 'V'"):
        ckpt.load_native(d, C0)


def test_native_shape_mismatch(tmp_path):
    d = str(tmp_path)
    p = _path(d, f"checkpoint_{C0:06d}.npz")
    np.savez(p, R=np.zeros((N, 3)), V=np.zeros((N - 2, 3)))
    with pytest.raises(ValueError, match="R shape"):
        ckpt.load_native(d, C0)


def test_native_missing_file_is_filenotfound(tmp_path):
    """A missing checkpoint is a *different* condition from a corrupt
    one: resume paths probe for existence and must keep seeing
    FileNotFoundError."""
    with pytest.raises(FileNotFoundError):
        ckpt.load_native(str(tmp_path), C0)


# ----------------------------------------------------- resume surfaces ----

def test_resume_state_names_truncated_wvfns(good_ckpt):
    """The user-facing cooling resume surfaces the reader diagnostics."""
    from mdqtplasmasims_tpu.experiments.laser_cooling import (CoolingConfig,
                                                              resume_state)
    p = _path(good_ckpt, f"wvFns_timestep{C0:06d}.dat")
    lines = open(p).readlines()
    with open(p, "w") as f:
        f.writelines(lines[:-4])
    with pytest.raises(ValueError, match="wvFns_timestep"):
        resume_state(good_ckpt, C0, CoolingConfig(n0=N, dtype="float64"))


def test_frozen_resume_names_spinup_mismatch(good_ckpt):
    from mdqtplasmasims_tpu.experiments.frozen_tagging import (
        FrozenTagConfig, resume_run)
    p = _path(good_ckpt, f"spinUpIonsList_timestep{C0:06d}.dat")
    lines = open(p).readlines()
    with open(p, "w") as f:
        f.writelines(lines[:-3])
    with pytest.raises(ValueError, match="spinUpIonsList"):
        resume_run(good_ckpt, C0, FrozenTagConfig(n0=N, dtype="float64"))


# ------------------------------------------- pipeline checkpoints (r5) ----

def _write_pipeline(tmp_path, **extra):
    payload = dict(stage=np.int64(0), chunk=np.int64(1),
                   R=np.zeros((4, 3)), V=np.zeros((4, 3)),
                   k_run=np.zeros(2, np.uint32),
                   mc_accepted=np.int64(0), n=np.int64(4),
                   gamma=np.float64(3.0))
    payload.update(extra)
    return ckpt.save_pipeline_checkpoint(str(tmp_path), 1, "transport",
                                         payload)


def test_pipeline_newest_only_pruning(tmp_path):
    _write_pipeline(tmp_path)
    ckpt.save_pipeline_checkpoint(str(tmp_path), 2, "transport",
                                  dict(stage=np.int64(1),
                                       chunk=np.int64(0)))
    files = sorted(os.listdir(tmp_path))
    assert files == ["pipeline_checkpoint_000002.npz"]
    z = ckpt.load_pipeline_checkpoint(str(tmp_path), "transport")
    assert int(z["stage"]) == 1


def test_pipeline_wrong_family_named(tmp_path):
    _write_pipeline(tmp_path)
    with pytest.raises(ValueError, match="'transport' pipeline"):
        ckpt.load_pipeline_checkpoint(str(tmp_path), "mc_tag")


def test_pipeline_corrupt_archive_named(tmp_path):
    p = _write_pipeline(tmp_path)
    data = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        ckpt.load_pipeline_checkpoint(str(tmp_path), "transport")


def test_pipeline_missing_returns_none(tmp_path):
    assert ckpt.load_pipeline_checkpoint(str(tmp_path),
                                         "transport") is None


def test_pipeline_meta_mismatch_named(tmp_path):
    from mdqtplasmasims_tpu.experiments.mc_md_anisotropy import (
        check_pipeline_meta)
    _write_pipeline(tmp_path)
    z = ckpt.load_pipeline_checkpoint(str(tmp_path), "transport")
    check_pipeline_meta(z, str(tmp_path), n=4, gamma=3.0)   # matches
    with pytest.raises(ValueError, match="refusing to splice"):
        check_pipeline_meta(z, str(tmp_path), n=8)
    with pytest.raises(ValueError, match="refusing to splice"):
        check_pipeline_meta(z, str(tmp_path), variant="422linear")
