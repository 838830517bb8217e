"""chip_smoke.py's phases on the CPU at a small batch.

The script itself refuses to run without a GPU; these tests call its phase
functions directly so that a change that breaks a phase shows here before
it costs a run on the card.  The four-device phase runs on 4 of the 8
virtual CPU devices from conftest.py.
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_train_and_score_phases():
    rec = chip_smoke.phase_train(batch=32, n_samples=64, exact_steps=2)
    ps = rec.pop("_ps")
    assert rec["fit"]["steps"] == 4 and len(rec["fit"]["loss"]) == 2
    assert np.all(np.isfinite(rec["fit"]["loss"]))
    assert rec["fit"]["bwd_attempts"] > 0 and rec["exact_trace"]["fwd_attempts"] > 0
    out = chip_smoke.phase_score_sample(ps, batch=32)
    assert out["logpdf"]["steps"] > 0 and out["generate"]["steps"] > 0


def test_parity_phase():
    rec = chip_smoke.phase_parity(batch=32)
    names = [c["check"] for c in rec["checks"]]
    assert any(n.startswith("default_grad_rel") for n in names)
    assert any(n.startswith("auto(highest)_train_steps_ratio") for n in names)
    assert all(c["ok"] for c in rec["checks"])


def test_four_card_phase_on_virtual_devices():
    rec = chip_smoke.four_card(jax.devices()[:4], batch=32)
    assert all(c["ok"] for c in rec["checks"])
    devices = {d for d, _ in rec["shards"]["xs(data)"]}
    assert len(devices) == 4
