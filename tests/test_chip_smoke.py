"""chip_smoke.py's contract, rehearsed on the CPU, and its on-card checks.

The CPU tests pin what callers of the script rely on: no result line and a non-zero
exit without a GPU or outside a checkout, a non-zero exit when any phase
fails, the exact result-line format, and the parsing of the card's
``nvidia-smi`` line.  Every phase is also run here at a tiny size, so the
code the card runs is the code these tests exercise.  Tests marked ``gpu``
run the phases on the card and skip here.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from mcqueens.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def _has_result_line(stdout: str) -> bool:
    return any('"ok"' in line for line in stdout.splitlines())


def test_refuses_a_cpu_device():
    proc = _run_script(REPO)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
    assert "needs an NVIDIA GPU" in proc.stderr


def test_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path))
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.final_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count})
    rec = json.loads(line)
    assert rec == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 500.00 W", "NVIDIA H100 80GB HBM3", 500.0),
    ("NVIDIA H100 PCIe, 350.00 W", "NVIDIA H100 PCIe", 350.0),
])
def test_parses_a_recorded_nvidia_smi_line(line, name, watts):
    assert profiling.parse_nvidia_smi(line) == (name, watts)


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        profiling.require_gpu(jax.devices())
    info = profiling.device_summary(jax.devices())
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": 8}


def test_run_phases_keeps_going_and_names_failures():
    seen = []

    def bad():
        seen.append("bad")
        chip_smoke.check(False, "deliberate")

    def good():
        seen.append("good")

    logs = []
    failed = chip_smoke.run_phases([("a", bad), ("b", good)], log=logs.append)
    assert failed == ["a"] and seen == ["bad", "good"]
    assert any(line.startswith("FAIL a") for line in logs)
    assert any(line.startswith("PASS b") for line in logs)


def _fake_gpu(monkeypatch, count=1):
    info = {"platform": "gpu", "kind": "fake", "count": count}
    monkeypatch.setattr(profiling, "require_gpu", lambda devices=None: info)
    monkeypatch.setattr(profiling, "device_summary",
                        lambda devices=None: info)
    monkeypatch.setattr(profiling, "nvidia_smi_lines",
                        lambda: ["NVIDIA H100 80GB HBM3, 700.00 W"])


def test_main_exits_nonzero_when_a_phase_fails(monkeypatch, capsys):
    _fake_gpu(monkeypatch)
    for name in ("phase_competition", "phase_board_throughput",
                 "phase_qmax_push"):
        monkeypatch.setattr(chip_smoke, name, lambda: None)

    def broken(cases=None):
        raise chip_smoke.CheckFailed("trajectories differ")

    monkeypatch.setattr(chip_smoke, "phase_tables_vs_naive", broken)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert not _has_result_line(out)
    assert "FAIL 4 tables vs naive" in out


def test_main_prints_the_result_line_last(monkeypatch, capsys):
    _fake_gpu(monkeypatch)
    for name in ("phase_competition", "phase_board_throughput",
                 "phase_qmax_push", "phase_tables_vs_naive"):
        monkeypatch.setattr(chip_smoke, name, lambda: None)
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "fake", "count": 1}}
    assert any("700.00 W" in line for line in lines[:-1])


def test_four_refuses_a_single_card(monkeypatch, capsys):
    _fake_gpu(monkeypatch, count=1)
    assert chip_smoke.main(["--four"]) == 2
    assert not _has_result_line(capsys.readouterr().out)


def test_oracle_check_catches_a_wrong_energy():
    states = np.zeros((2, 4, 4), np.int64)
    good = np.asarray([_oracle_board(states[0])] * 2)
    chip_smoke.check_against_oracle(good, states, "board", [0, 1], "e")
    with pytest.raises(chip_smoke.CheckFailed, match="oracle says"):
        chip_smoke.check_against_oracle(good + 1, states, "board", [1], "e")


def _oracle_board(heights):
    from tests import _oracle

    return _oracle.board_energy(heights)


def test_ladder_check_catches_a_broken_multiset():
    ladder = np.asarray([0.5, 1.0, 2.0], np.float32)
    chip_smoke._check_ladder(np.asarray([2.0, 0.5, 1.0, 1.0, 2.0, 0.5]),
                             ladder)
    with pytest.raises(chip_smoke.CheckFailed, match="group 1"):
        chip_smoke._check_ladder(np.asarray([2.0, 0.5, 1.0, 1.0, 1.0, 0.5]),
                                 ladder)


# --- every phase at a tiny size: the same code the card runs -------------


def test_phase_competition_small():
    chip_smoke.phase_competition(["--n-steps", "200"])


def test_phase_board_throughput_small():
    chip_smoke.phase_board_throughput(chains=8, n_steps=64, stride=16,
                                      sample=3)


def test_phase_qmax_push_small():
    chip_smoke.phase_qmax_push(chains=16, stride=10, rounds=2, sample=2)


def test_phase_tables_vs_naive_small():
    chip_smoke.phase_tables_vs_naive([("board", 5, None, 4, 60),
                                      ("full_3d", 4, 10, 4, 60)])


def test_phase_four_board_small():
    chip_smoke.phase_four_board(runs=16, n_steps=64, stride=16)


def test_phase_four_tempered_small():
    chip_smoke.phase_four_tempered(chains=32, stride=10, rounds=2)


# --- on the card ---------------------------------------------------------


@pytest.mark.gpu
def test_gpu_tables_vs_naive(gpu_device):
    chip_smoke.phase_tables_vs_naive([("board", 12, None, 64, 500),
                                      ("full_3d", 6, 30, 64, 500)])


@pytest.mark.gpu
def test_gpu_board_throughput_oracle(gpu_device):
    chip_smoke.phase_board_throughput(chains=4096, n_steps=512, stride=128,
                                      sample=32)
