"""SLURM PBT launcher (reference pbt/launcher/run_slurm.py parity).

    python -m isaacgyminsertion_tpu_torch.pbt.slurm --policies 8 --jobs 4 \\
        --workspace /shared/pbt_ws --time 12:00:00 [--dry-run]

Port of `scripts/run_pbt_slurm.py`, with its flags and the same variables in
each job (WORKSPACE, POLICIES, LOCAL_POLICIES, POLICY_OFFSET, NUM_ENVS). It
writes one sbatch script per job and submits it; the jobs coordinate through
the shared-filesystem workspace like the single-host driver (checkpoint
exchange by atomic file writes, no inter-job RPC), each running
`python -m isaacgyminsertion_tpu_torch.pbt.run` on its slice of the
population. `--dry-run`, or a host without `sbatch`, prints the scripts
instead of submitting them. Against the reference: the partition defaults to
`gpu`, and each job asks for one GPU (`#SBATCH --gres=gpu:1`).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name=pbt_{job}
#SBATCH --partition={partition}
#SBATCH --time={time}
#SBATCH --nodes=1
#SBATCH --gres=gpu:1
#SBATCH --output={workspace}/slurm_{job}_%j.log
{extra_directives}
export WORKSPACE={workspace}
export POLICIES={total_policies}
export LOCAL_POLICIES={policies_per_job}
export POLICY_OFFSET={offset}
export NUM_ENVS={num_envs}
cd {repo}
python -m isaacgyminsertion_tpu_torch.pbt.run
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policies", type=int, default=8, help="population size")
    ap.add_argument("--jobs", type=int, default=4, help="SLURM jobs (hosts)")
    ap.add_argument("--workspace", default="outputs/pbt_slurm")
    ap.add_argument("--partition", default="gpu")
    ap.add_argument("--time", default="12:00:00")
    ap.add_argument("--num-envs", type=int, default=512)
    ap.add_argument("--extra", default="", help="extra #SBATCH directives, ';'-separated")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.workspace, exist_ok=True)
    per_job = max(args.policies // args.jobs, 1)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    extra = "\n".join(f"#SBATCH {d}" for d in args.extra.split(";") if d)

    scripts = []
    for j in range(args.jobs):
        body = SBATCH_TEMPLATE.format(
            job=j, partition=args.partition, time=args.time,
            workspace=os.path.abspath(args.workspace),
            policies_per_job=per_job, offset=j * per_job,
            total_policies=args.policies,
            num_envs=args.num_envs, repo=repo, extra_directives=extra,
        )
        path = os.path.join(args.workspace, f"pbt_job_{j}.sbatch")
        with open(path, "w") as f:
            f.write(body)
        scripts.append(path)

    if args.dry_run or shutil.which("sbatch") is None:
        for p in scripts:
            print(f"--- {p} ---")
            with open(p) as f:
                print(f.read())
        if not args.dry_run:
            print("sbatch not found on this host; scripts written, not submitted",
                  file=sys.stderr)
        return scripts

    for p in scripts:
        subprocess.run(["sbatch", p], check=True)
    return scripts


if __name__ == "__main__":
    main()
