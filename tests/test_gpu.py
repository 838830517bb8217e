"""Chip tier: the GPU path against the plain float32 reference.

Run on a machine with one GPU (a single process: JAX reserves most of the
card's memory):

    CNF_GPU_TESTS=1 python -m pytest tests/ -m gpu -n 0

Each test skips elsewhere (the `gpu_backend` fixture).  The checks are the
ones phase 4 of chip_smoke.py runs, at the flagship's full width and
B = 4096: TRAIN/TEST log-density and per-leaf gradients at rtol 1e-5, and
step counts under the resolved "auto" stage precision at rtol 1e-3.
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def _assert_checks(checks):
    for c in checks:
        assert c["ok"], c


def test_tight_parity_on_gpu(gpu_backend):
    _assert_checks(chip_smoke.tight_parity())


def test_auto_precision_steps_on_gpu(gpu_backend):
    _assert_checks(chip_smoke.auto_steps_parity())


def test_score_and_sample_on_gpu(gpu_backend):
    ps = chip_smoke.flagship().init(jax.random.PRNGKey(0))
    rec = chip_smoke.phase_score_sample(ps)
    assert rec["logpdf"]["B"] == chip_smoke.B
