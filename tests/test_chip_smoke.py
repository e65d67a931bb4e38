"""chip_smoke.py on the CPU: the device check refuses the CPU, the script
fails alone and on the CPU, and each phase runs at a tiny length against
the same SA-IS / Kasai oracles it uses on the card."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture
def clock():
    return chip_smoke.Clock("cpu test")


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit, match="'cpu', not 'gpu'"):
        chip_smoke.device_check(jax.devices("cpu"), 1)


def test_script_refuses_cpu_platform():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_cpu_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "'cpu', not 'gpu'" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_cpu_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_single_block(clock, tmp_path):
    chip_smoke.phase_single_block(clock, str(tmp_path), 5000, seed=1)


def test_phase_merge_bwa(clock, tmp_path):
    # mem=16K -> 1024-symbol blocks: the merge engine, as chr1 takes it
    chip_smoke.phase_merge_bwa(clock, str(tmp_path), 3000, seed=2,
                               mem="16K")


def test_phase_lcp(clock, tmp_path):
    chip_smoke.phase_lcp(clock, str(tmp_path), 4096, seed=3)


def test_phase_mesh(clock, tmp_path):
    chip_smoke.phase_mesh(clock, str(tmp_path), 4000, seed=4, n_devices=4)
