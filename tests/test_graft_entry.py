"""Driver entry-point coverage: entry() compiles, dryrun_multichip executes."""

import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, ".")


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out))


@pytest.mark.slow
def test_dryrun_multichip_8():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_self_heals_without_cpu_env():
    """Fresh CPU process with no XLA_FLAGS help: dryrun must grow the CPU
    platform to a forced-count 8-device mesh by itself."""
    import os
    import subprocess

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout


def test_ensure_devices_raises_on_accelerator_with_too_few_devices(monkeypatch):
    """On a GPU with fewer devices than the mesh needs, the dry run raises
    instead of quietly moving the process to the CPU."""
    import __graft_entry__ as ge

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [object()])
    with pytest.raises(RuntimeError, match="'gpu' platform has 1"):
        ge._ensure_devices(4)


def test_ensure_devices_noop_when_enough_devices():
    import __graft_entry__ as ge

    before = jax.devices()
    ge._ensure_devices(len(before))
    assert jax.devices() == before
