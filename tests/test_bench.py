"""bench.py contract tests: one valid JSON line on stdout (CPU, tiny), both
schedules measured in one process, and a refusal to run the kernel
implementation without a GPU."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(extra_env):
    env = dict(os.environ)
    env.update({
        "BENCH_PARTICLES": "64",
        "BENCH_REPLICATES": "2",
        "BENCH_CHAINS": "1",
        "BENCH_ITERS": "2",
        "BENCH_PLATFORM": "cpu",
    })
    env.update(extra_env)
    return subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                          env=env, capture_output=True, text=True,
                          timeout=900)


def _payload(out):
    assert out.returncode == 0, out.stderr[-2000:]
    json_lines = [l for l in out.stdout.strip().split("\n")
                  if l.startswith("{")]
    assert len(json_lines) == 1, out.stdout
    return json.loads(json_lines[0])


def test_bench_emits_json_line():
    out = _run_bench({"BENCH_IMPL": "xla"})
    payload = _payload(out)
    assert payload["metric"] == "pmmh_particle_propagations_per_sec_per_chip"
    assert payload["value"] > 0
    assert payload["unit"] == "propagations/s/chip"
    # both schedules, one implementation, the device named
    assert payload["parity"] > 0
    assert payload["adaptive"] == payload["value"]
    assert payload["impl"] == "xla"
    assert payload["device"]["platform"] == "cpu"
    assert payload["device"]["count"] >= 1
    assert "device:" in out.stderr and "card:" in out.stderr


def test_bench_kernel_impl_refuses_cpu():
    """The kernel implementation needs a GPU: on a CPU the bench exits
    nonzero and prints no result, instead of measuring another path."""
    out = _run_bench({"BENCH_IMPL": "kernel", "BENCH_PARTICLES": "128"})
    assert out.returncode != 0
    assert not [l for l in out.stdout.split("\n") if l.startswith("{")]
    assert "needs a GPU" in out.stderr


def test_bench_scaling_mode():
    out = _run_bench({
        "BENCH_MODE": "scaling",
        "BENCH_PARTICLES": "32",
        "BENCH_REPLICATES": "1",
        "BENCH_ITERS": "2",
        "BENCH_T": "16",
        "BENCH_CPU_DEVICES": "4",
    })
    payload = _payload(out)
    assert payload["metric"] == "pmmh_chain_scaling"
    rows = payload["rows"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert all(r["props_per_sec"] > 0 for r in rows)
    assert rows[0]["parallel_efficiency"] == 1.0
