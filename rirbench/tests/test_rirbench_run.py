"""The command's refusals: no card, no program beside it, JAX loaded."""

import shutil
import subprocess
import sys
import types

import pytest

from rirbench import run, spec

ARGS = ["--workload", "fcc_lossy_box.step", "--seed", str(2**33 + 1),
        "--seconds", "1", "--trace", "0"]


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_fails_without_a_card():
    _no_card()
    p = subprocess.run([sys.executable, "-m", "rirbench.run", *ARGS],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_fails_beside_nothing_but_its_own_files(tmp_path):
    """A directory with BENCHMARK.json and rirbench/ alone: the program
    under test is not there, and no result comes."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "rirbench", tmp_path / "rirbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "rirbench.run", *ARGS],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_foreign_modules_compare_whole_names(monkeypatch):
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "pffdtd_tpu_torch_x",
                        types.ModuleType("pffdtd_tpu_torch_x"))
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert run.foreign_modules() == ["jax"]


def test_main_refuses_with_jax_loaded(monkeypatch, capsys):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(run.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"compared": {}})
    monkeypatch.setitem(sys.modules, "pffdtd_tpu",
                        types.ModuleType("pffdtd_tpu"))
    assert run.main(ARGS) == 3
    assert capsys.readouterr().out == ""


def test_warm_up_launches_what_the_window_launches():
    assert run.warm_steps({"route": "step"}, 747) == 2
    assert run.warm_steps({"route": "tb", "tb": 3}, 747) == 6
    assert run.warm_steps({"route": "tb", "tb": 3}, 748) == 7
