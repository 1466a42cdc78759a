#!/usr/bin/env bash
# Equivalent of the reference's exampleSlurmFile.slurm: instead of a
# 10-99-way SLURM job array (one binary, 4 OpenMP threads, 8 h walltime per
# job), the whole ensemble batches onto GPUs in one process.
#
# Reference workflow:            This framework:
#   #SBATCH --array=1-16           --jobs 16 (one device program)
#   srun runFile $TASK_ID          one python invocation
#   8 h per job                    ~minutes total
#   aggregate .dat offline         same job<k>/ tree + analysis.py helpers
set -euo pipefail

JOBS="${1:-16}"
OUT="${2:-dataLaserCool}"

# On a multi-GPU host, add --mesh-ens <n_gpus> to spread the jobs over the
# mesh's ens axis (--mesh-ions shards each member's ions for large N);
# the share-nothing families take the same flag on their batched/sweep
# subcommands.
python -m mdqtplasmasims_tpu.cli cooling-ensemble \
    --jobs "$JOBS" \
    --n0 3500 --tmax 30 --save-directory "$OUT"

python - <<PY
from mdqtplasmasims_tpu.analysis import ensemble_temperature_curve, job_dirs
import glob
param_dir = sorted(glob.glob("$OUT/*"))[0]
curve = ensemble_temperature_curve(param_dir)
print(f"{len(job_dirs(param_dir))} jobs aggregated; "
      f"T(t={curve[-1,0]:.1f}) = {curve[-1,1]:.4f} E_c/k_B")
PY
