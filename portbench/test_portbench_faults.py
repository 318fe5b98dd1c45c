"""``correct`` comes out false when it should: the float32 control, and
a run whose timed path is broken underneath (a chunk step that returns
its state unchanged, half of each chunk left out, answers altered where
they are produced).  One card holds the whole sweep, so there is no
exchange between chips to leave out."""

import pytest
import torch

from portbench import control, run, small
from repro_torch.core import backend as B

CELLS = [("dosc-ht-grid-1e8", "pareto3"), "grid-1e8.argmin",
         "sessions-1m.default"]
SEED = 2**31 + 11


def _state_unchanged(monkeypatch):
    fold = B.fold_chunk

    def same(spec, carry, partials, aux, start):
        return carry, fold(spec, carry, partials, aux, start)[1]
    monkeypatch.setattr(B, "fold_chunk", same)


def _half_left_out(monkeypatch):
    partials = B.chunk_partials

    def half(spec, F, flat, ingrid, aux):
        lane = torch.arange(flat.shape[0], device=flat.device)
        return partials(spec, F, flat, ingrid & (lane < flat.shape[0] // 2),
                        aux)
    monkeypatch.setattr(B, "chunk_partials", half)


def _answers_altered(monkeypatch):
    partials = B.chunk_partials

    def altered(spec, F, flat, ingrid, aux):
        return partials(spec, F * (1.0 + 1e-6), flat, ingrid, aux)
    monkeypatch.setattr(B, "chunk_partials", altered)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run.run(small.small_cell(name), SEED, 0.0, False, device="cpu")
    assert out["correct"] and out["attempted"] == 1
    assert out["checks"]["value_rel_err"]["value"] == 0.0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answers_altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run.run(small.small_cell(name), SEED, 0.0, False, device="cpu")
    assert not out["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_float32_control_is_not_correct(name):
    cell = small.small_cell(name)
    found = control.control_numbers(cell, SEED, "cpu")
    assert found["value_rel_err"] > 10 * cell.config["limits"][
        "value_rel_err"]
