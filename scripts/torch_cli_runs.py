"""Time the port's CLI as its users run it: one argv, first in fresh
processes (each pays the CUDA context, the first use of every torch
kernel and the loading of the port's kernel library inside its phases),
then repeated in one process (warm).

    python3 scripts/torch_cli_runs.py [--fresh N] [--warm M] -- <cli argv>

For example, the headline with every stage the CLI has:

    python3 scripts/torch_cli_runs.py -- phj 1 256000000 16000000 \\
        --json --timelog --check --aggregate

Prints the card's name and power limit, then one line per run, "fresh
i" or "warm i" and the CLI's JSON report (the argv needs --json).
Imports nothing of the JAX package.  Exits non-zero when a run fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_line(text: str) -> str:
    lines = text.strip().splitlines()
    return lines[-1] if lines else ""


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--fresh", type=int, default=3)
    p.add_argument("--warm", type=int, default=2)
    p.add_argument("argv", nargs=argparse.REMAINDER)
    args = p.parse_args()
    argv = args.argv[1:] if args.argv[:1] == ["--"] else args.argv
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for i in range(args.fresh):
        proc = subprocess.run(
            [sys.executable, "-m", "hash_join_codes_knl_tpu_torch.cli",
             *argv], cwd=REPO, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-2000:], file=sys.stderr)
            return proc.returncode
        print(f"fresh {i} {_last_line(proc.stdout)}", flush=True)
    sys.path.insert(0, REPO)
    from hash_join_codes_knl_tpu_torch import cli

    for i in range(args.warm):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc:
            return rc
        print(f"warm {i} {_last_line(out.getvalue())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
