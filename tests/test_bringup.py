"""Installation and start-up: compile cache, import surface, checkpoints,
and the GPU smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import continuousnf_tpu as cnf
from continuousnf_tpu.utils import cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _record_config_updates(monkeypatch):
    """Replace jax.config.update by a recorder (restored after the test)."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_follows_env_var(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    calls = _record_config_updates(monkeypatch)
    assert cache.enable_compile_cache() == "/some/where"
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_fixed_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config_updates(monkeypatch)
    assert cache.enable_compile_cache() == os.path.join(_REPO, ".jax_cache")
    assert ("jax_compilation_cache_dir", os.path.join(_REPO, ".jax_cache")) in calls


_IMPORT_PROBE = r"""
import importlib, sys
for blocked in ("flax", "pandas", "torch", "tensorflow"):
    sys.modules[blocked] = None  # any import of these now raises
for dep in ("jax", "jax.numpy", "numpy", "scipy", "optax", "chex", "einops"):
    try:
        importlib.import_module(dep)
    except ImportError:
        pass
before = {m.split(".")[0] for m in sys.modules}
import continuousnf_tpu
new = {m.split(".")[0] for m in sys.modules} - before - {"continuousnf_tpu"}
print("OUTSIDE", sorted(m for m in new if m not in sys.stdlib_module_names))
"""


_NO_FLAX = r"""
import os, sys, tempfile
sys.modules["flax"] = None  # any import of flax now raises
import jax
import continuousnf_tpu as cnf
ps = cnf.MLP((2, 4, 2)).init(jax.random.PRNGKey(0), jax.numpy.float32)
with tempfile.TemporaryDirectory() as d:
    cnf.save_checkpoint(os.path.join(d, "p.npz"), ps)
    cnf.load_checkpoint(os.path.join(d, "p.npz"), ps)
print("OK")
"""


def test_import_and_checkpoints_need_no_flax():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _NO_FLAX], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout


def test_import_pulls_only_jax_numpy_scipy_optax_chex_einops():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OUTSIDE []" in out.stdout, out.stdout


@pytest.mark.parametrize("what", ["params", "params+optimizer"])
def test_checkpoint_round_trip(tmp_path, what):
    icnf = cnf.construct(cnf.RNODE, cnf.MLP((4, 12, 4)), 2, 2)
    ps = icnf.init(jax.random.PRNGKey(0))
    tree = ps
    if what != "params":
        opt = optax.lion(1e-3)
        opt_state = opt.init(ps)
        _, opt_state = opt.update(jax.tree.map(jnp.ones_like, ps), opt_state, ps)
        tree = {"ps": ps, "opt": opt_state, "epoch": 7}
    path = str(tmp_path / "ckpt.npz")
    cnf.save_checkpoint(path, tree)
    assert not os.path.exists(path + ".tmp")
    like = jax.tree.map(jnp.zeros_like, tree)
    back = cnf.load_checkpoint(path, like)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b, t in zip(jax.tree.leaves(back), jax.tree.leaves(tree), jax.tree.leaves(like)):
        assert np.asarray(a).dtype == np.asarray(t).dtype  # the template's dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_rejects_wrong_template(tmp_path):
    ps = cnf.MLP((4, 12, 4)).init(jax.random.PRNGKey(0), jnp.float32)
    path = str(tmp_path / "ckpt.npz")
    cnf.save_checkpoint(path, ps)
    with pytest.raises(ValueError, match="leaves"):
        cnf.load_checkpoint(path, ps[:1])
    other = cnf.MLP((4, 8, 4)).init(jax.random.PRNGKey(0), jnp.float32)
    with pytest.raises(ValueError, match="shape"):
        cnf.load_checkpoint(path, other)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(_REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU backend" in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize(
    "line,name,watts",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
        ("NVIDIA H100 80GB HBM3, 500.00 W\n", "NVIDIA H100 80GB HBM3", 500.0),
        ("Some GPU, with comma, [N/A]", "Some GPU, with comma", None),
    ],
)
def test_parse_card_line(line, name, watts):
    import chip_smoke

    assert chip_smoke.parse_card_line(line) == {"name": name, "power_limit_w": watts}


def test_parse_card_line_rejects_garbage():
    import chip_smoke

    with pytest.raises(ValueError):
        chip_smoke.parse_card_line("no comma here")
