"""Shared by the tests of examples/torch_*.py: each example and its JAX
twin run as processes at once (the JAX examples as tests/test_examples.py
runs them), and the printed lines to compare.  The tests are split over
two files so that the test workers run them side by side."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    "basic_join": ["20000", "80000"],
    "dataframe_style": [],
    "out_of_core": None,  # gets a spill directory of its own
    "multichip": [],
    "aggregate": ["60000"],
}


def _commands(name, args, tmp):
    """(port command, JAX command, JAX environment) for one example."""
    if args is None:
        args = [os.path.join(tmp, "port")], [os.path.join(tmp, "jax")]
    else:
        args = args, args
    port = [sys.executable, os.path.join(REPO, "examples",
                                         f"torch_{name}.py"),
            *args[0], "--device", "cpu"]
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            f"exec(open({os.path.join(REPO, 'examples', name + '.py')!r})"
            ".read())")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    return port, [sys.executable, "-c", code, *args[1]], env


def run_examples(names, tmp_path_factory) -> dict:
    """name -> ((rc, stdout, stderr) of the port's example, the same of
    the JAX example), every process run at once."""
    procs = {}
    for name in names:
        args = EXAMPLES[name]
        tmp = str(tmp_path_factory.mktemp(name))
        port, jax_cmd, env = _commands(name, args, tmp)
        procs[name] = (
            subprocess.Popen(port, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            subprocess.Popen(jax_cmd, cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True))
    out = {}
    for name, pair in procs.items():
        out[name] = []
        for p in pair:
            stdout, stderr = p.communicate(timeout=600)
            out[name].append((p.returncode, stdout, stderr))
    return out


def lines(stdout):
    """Printed lines with the plan, the first row and JAX's mesh-shape
    type left out."""
    out = []
    for line in stdout.strip().splitlines():
        line = re.sub(r" plan=.*", "", line)
        line = re.sub(r"; first: \(.*\)", "", line)
        line = re.sub(r"OrderedDict\((\{.*?\})\)", r"\1", line)
        out.append(line)
    return out


