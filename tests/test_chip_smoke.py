"""chip_smoke.py's contract where there is no GPU: argument handling, and
a nonzero exit with no result line on a CPU device or outside the repo."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd=REPO, script=SCRIPT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _result_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def test_parse_args():
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.parse_args([]).four is False
    assert chip_smoke.parse_args(["--four"]).four is True
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--chips", "2"])


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_refuses_cpu(args):
    out = _run(args)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert not _result_lines(out.stdout)


def test_refuses_outside_repo(tmp_path):
    script = str(tmp_path / "chip_smoke.py")
    shutil.copy(SCRIPT, script)
    out = _run([], cwd=str(tmp_path), script=script)
    assert out.returncode != 0
    assert not _result_lines(out.stdout)


TINY = dict(chains=8, replicates=2, particles=32, t_len=30, iters=2,
            ref_reps=16, factor_t=20)


def _phases():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke, chip_smoke.Sizes(**TINY)


def test_kernel_phase_rehearsal():
    """Phase 2 at a tiny size on the CPU, the kernel interpreted: the
    compile step, and each kernel-vs-reference comparison passes."""
    chip_smoke, sizes = _phases()
    chip_smoke.kernel_phase(sizes, interpret=True, run_tests=False)


def test_main_path_phase_rehearsal(capsys):
    chip_smoke, sizes = _phases()
    chip_smoke.main_path_phase(sizes, "no card", interpret=True)
    out = capsys.readouterr().out
    for sched in ("parity", "adaptive"):
        for impl in ("kernel", "xla"):
            assert f"main path {sched} {impl}: C=8" in out


def test_four_card_phase_rehearsal(monkeypatch):
    """Phase 4 on four of the eight virtual CPU devices."""
    import jax

    assert len(jax.devices()) >= 4
    monkeypatch.setenv("SSME_DRYRUN_PLATFORM", "native")
    chip_smoke, sizes = _phases()
    chip_smoke.four_card_phase(sizes, interpret=True)
