"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (`rirbench.run.run_cell`) on a small room on the CPU, with one fault
planted in the program for the run: a step that returns its state
unchanged, the lossy boundary left out, a receiver sample or a point of
the final field altered where it is produced, the receivers' order lost.
(A cell of one card has no exchange between cards to leave out, and a
request is one simulation: no batch to halve.)"""

import numpy as np
import pytest
import torch

from pffdtd_tpu_torch.engine import torch_engine
from pffdtd_tpu_torch.kernels import tb as tb_mod
from rirbench import program, run

CELLS = ["fcc_lossy_box.step", "cart_lossy_box.step", "fcc_lossy_box.tb"]
SEED = 2**32 + 99


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tiny, name):
    return run.run_cell(tiny(name), SEED, 0.0, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny):
    assert _run(tiny, name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(name, tiny, monkeypatch):
    monkeypatch.setattr(torch_engine.TorchEngine, "step",
                        lambda self, state, *a, **k: state)
    monkeypatch.setattr(torch_engine.TorchEngine, "sweep",
                        lambda self, state, *a, **k: state)
    out = _run(tiny, name)
    assert not out["correct"] and out["failed"] == out["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_lossy_boundary_left_out(name, tiny, monkeypatch):
    skip = lambda unew, *a, **k: unew
    monkeypatch.setattr(torch_engine, "boundary_update", skip)
    monkeypatch.setattr(tb_mod, "boundary_update_plain", skip)
    out = _run(tiny, name)
    assert not out["correct"]
    assert out["compared"]["branch_err"]["value"] == 1.0


@pytest.mark.parametrize("name", CELLS)
def test_receiver_sample_altered(name, tiny, monkeypatch):
    """One time sample of the window's simulation, the one of its largest
    tap, 1% of that tap off on every tap."""
    real = torch_engine.TorchEngine.run
    calls = []

    def run_altered(self, *a, **k):
        u = real(self, *a, **k)
        calls.append(1)
        if len(calls) == 3:      # after the two warm-up runs
            n = np.unravel_index(np.abs(u).argmax(), u.shape)[1]
            u[:, n] += 0.01 * np.abs(u).max()
        return u
    monkeypatch.setattr(torch_engine.TorchEngine, "run", run_altered)
    out = _run(tiny, name)
    assert len(calls) == 3
    assert not out["correct"] and out["failed"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_final_field_altered(name, tiny, monkeypatch):
    """One interior point of u^Nt, 1% of the field's largest off."""
    real = torch_engine.TorchEngine.run

    def run_altered(self, *a, **k):
        u = real(self, *a, **k)
        f = self.state[1]
        c = tuple(n // 2 for n in f.shape)
        f[c] += 0.01 * f.abs().max()
        return u
    monkeypatch.setattr(torch_engine.TorchEngine, "run", run_altered)
    out = _run(tiny, name)
    assert not out["correct"]
    assert out["compared"]["field_err"]["value"] > \
        out["compared"]["field_err"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_receivers_out_of_order(name, tiny, monkeypatch):
    """The taps read back in the sorted order, not the request's."""
    def unsorted(sim, u_out):
        nr = sim.comms.out_alpha.shape[0]
        return np.einsum("rk,rkn->rn", sim.comms.out_alpha,
                         u_out.reshape(nr, 8, u_out.shape[1]))
    monkeypatch.setattr(program, "receivers", unsorted)
    assert not _run(tiny, name)["correct"]
