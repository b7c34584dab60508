"""The comparison that decides ``correct`` at smoke sizes on the CPU: a
sound run passes it, and a run whose timed path is broken underneath
fails it, with the harness's look for a card skipped and the rest of a
run driven as it is. Broken: the control (the program's own int8 AdamW
moments, below the configuration's float32), a step that leaves the state
as it was, and half of the batch left out with the mean over the rest.
Each smoke cell holds the limits of its real cell."""
from __future__ import annotations

import time

import pytest
import torch

from conftest import SMOKE_CELLS, smoke_cell


def _run(root, name, variant=None, seed=11):
    from bench.harness import train
    return train.run(smoke_cell(root, name), seed, 0.2, False,
                     time.perf_counter(), device="cpu", variant=variant)


@pytest.mark.parametrize("name", sorted(SMOKE_CELLS))
def test_sound_run_is_correct(smoke_root, name):
    out = _run(smoke_root, name)
    assert out["correct"], out["checks"]
    from bench.harness.check import ORDER
    limits = smoke_cell(smoke_root, name).spec["limits"]
    assert list(out["checks"]) == [k for k in ORDER if k in limits]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("variant", ["control_int8", "frozen", "half_batch"])
@pytest.mark.parametrize("name", sorted(SMOKE_CELLS))
def test_broken_step_is_not_correct(smoke_root, name, variant):
    out = _run(smoke_root, name, variant)
    assert not out["correct"], out["checks"]
    failed = {k for k, c in out["checks"].items()
              if not c["value"] <= c["limit"]}
    if variant in ("frozen", "half_batch"):
        assert failed & {"loss_gap", "grad_gap", "change_gap"}
    else:
        # int8 moments move a smoke leaf's change by 2e-3, under the real
        # cell's limit; at the cell's size they fail change_gap (PERF.md).
        assert "dtype_faults" in failed


def test_nonfinite_window_is_not_correct(smoke_root, monkeypatch):
    """A loss that turns NaN in the measured window fails ``nonfinite``."""
    from bench.harness import train
    real = train.Program.step
    calls = {"n": 0}

    def step(self, batch):
        calls["n"] += 1
        loss = real(self, batch)
        return loss * float("nan") if calls["n"] > 2 else loss

    monkeypatch.setattr(train.Program, "step", step)
    out = _run(smoke_root, "train.smoke-dense.b4s32")
    assert not out["correct"] and out["checks"]["nonfinite"]["value"] >= 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SMOKE_CELLS))
def test_smoke_cells_on_the_card(smoke_root, card, name):
    """On the card the smoke cells take the flash kernels' route; a sound
    run passes and a frozen step fails."""
    from bench.harness import train
    cell = smoke_cell(smoke_root, name)
    out = train.run(cell, 21, 0.5, False, time.perf_counter(), device=card)
    assert out["correct"], out["checks"]
    out = train.run(cell, 21, 0.5, False, time.perf_counter(), device=card,
                    variant="frozen")
    assert not out["correct"]
