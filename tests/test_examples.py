"""End-to-end smoke tests of the example CLIs (subprocess, CPU, tiny)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=600):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.argv = [%r] + %r;"
        "import runpy; runpy.run_path(%r, run_name='__main__')"
        % (script, list(args), os.path.join(REPO, "examples", script)))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ex")
    data = str(d / "ys.csv")
    with open(os.path.join(REPO, "data", "spy_returns.csv")) as f:
        rows = [next(f) for _ in range(120)]
    open(data, "w").writelines(rows)
    post = str(d / "post.csv")
    open(post, "w").write("1.0,0.5,0.0002\n0.9,0.6,0.0003\n")
    return d, data, post


def test_estimate_univ_svol_cli(small_data):
    d, data, _ = small_data
    out = _run("estimate_univ_svol.py", data, str(d / "s"), str(d / "m"),
               "4", "2", "--particles", "32", "--no-timestamp")
    assert out.returncode == 0, out.stderr[-1500:]
    assert len(open(str(d / "s")).read().strip().split("\n")) == 4
    assert "done: 4 iters" in out.stderr


def test_liu_west_cli(small_data):
    d, data, _ = small_data
    out = _run("liu_west_leverage.py", data, "--particles", "64",
               "--forecast", "2")
    assert out.returncode == 0, out.stderr[-1500:]
    assert "log-likelihood:" in out.stdout
    assert "phi" in out.stderr


def test_swarm_cli(small_data):
    d, data, post = small_data
    out = _run("swarm_forecast.py", data, post, "--state-particles", "32",
               "--param-particles", "4", "--forecast", "2")
    assert out.returncode == 0, out.stderr[-1500:]
    assert "conditional evidence" in out.stdout


def test_estimate_svol_leverage_tuned_cli(small_data):
    """The --tuned preset's code path (warm restart mid-run, chunking,
    JSON output with the tuned field) on the generic CPU engine at toy
    scale."""
    import json

    d, data, _ = small_data
    outp = str(d / "lev.json")
    out = _run("estimate_svol_leverage.py", "--datafile", data,
               "--engine", "generic", "--tuned", "--chains", "2",
               "--particles", "32", "--replicates", "1", "--iters", "8",
               "--burn", "4", "--t-len", "40", "--out", outp,
               timeout=900)
    # --tuned forces chains=64; keep it tiny by overriding AFTER: the
    # preset max()s chains, so pass a larger value check instead
    assert out.returncode == 0, out.stderr[-1500:]
    rec = json.load(open(outp))
    assert rec["tuned"] is True
    assert rec["engine"] == "generic"
    assert rec["iters"] == 8
    assert np.isfinite(rec["accept"])
    assert "rho" in rec["posterior"]


@pytest.mark.parametrize("script,args", [
    ("estimate_univ_svol.py", ["{data}", "{d}/s", "{d}/m", "2", "2",
                               "--particles", "64"]),
    ("estimate_svol_leverage.py", ["--datafile", "{data}", "--iters", "2"]),
    ("swarm_forecast.py", ["{data}", "{post}", "--state-particles", "64"]),
])
def test_kernel_engine_refuses_cpu(small_data, script, args):
    """--engine kernel needs a GPU: on a CPU each CLI exits with a usage
    error and never falls back to another engine."""
    d, data, post = small_data
    argv = [a.format(data=data, d=d, post=post) for a in args]
    out = _run(script, *argv, "--engine", "kernel")
    assert out.returncode == 2, out.stderr[-1500:]
    assert "needs a GPU" in out.stderr
