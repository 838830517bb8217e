"""Native loader and toy data tests."""

import numpy as np
import pytest

from continuousnf_tpu.io import load_csv, native_available, shuffled_indices
from continuousnf_tpu import data as toy_data
import jax


def test_load_csv_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(200, 5)).astype(np.float32)
    p = str(tmp_path / "t.csv")
    np.savetxt(p, arr, delimiter=",", fmt="%.6f")
    data, mean, std = load_csv(p)
    ref = np.loadtxt(p, delimiter=",", dtype=np.float32)
    np.testing.assert_array_equal(data, ref)
    assert mean is None and std is None


def test_load_csv_standardize_and_header(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.normal(loc=3.0, scale=2.0, size=(300, 4)).astype(np.float32)
    p = str(tmp_path / "t.csv")
    np.savetxt(p, arr, delimiter=",", fmt="%.5f", header="a,b,c,d", comments="")
    data, mean, std = load_csv(p, has_header=True, standardize=True)
    assert data.shape == (300, 4)
    np.testing.assert_allclose(data.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(data.std(axis=0), 1.0, atol=1e-3)
    np.testing.assert_allclose(mean, arr.mean(axis=0), rtol=1e-3, atol=1e-3)


def test_shuffled_indices_deterministic_permutation():
    a = shuffled_indices(7, 512)
    b = shuffled_indices(7, 512)
    c = shuffled_indices(8, 512)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(np.sort(a), np.arange(512))


def test_toy_datasets_shapes_and_ranges():
    key = jax.random.PRNGKey(0)
    assert toy_data.beta_data(key, 100, 3).shape == (100, 3)
    m = np.asarray(toy_data.two_moons(key, 101))
    assert m.shape == (101, 2) and np.isfinite(m).all()
    c = np.asarray(toy_data.circles(key, 100))
    assert c.shape == (100, 2)
    radii = np.linalg.norm(c, axis=1)
    assert radii.max() < 1.5 and radii.min() > 0.2
    g = np.asarray(toy_data.gaussian_mixture(key, 100, [[0, 0], [5, 5]]))
    assert g.shape == (100, 2)
    t = np.asarray(toy_data.synthetic_tabular(key, 100, 43))
    assert t.shape == (100, 43) and np.isfinite(t).all()


def test_table_frontend_roundtrip():
    """MLJ-frontend parity: dict / DataFrame inputs and the px-table output."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import continuousnf_tpu as cnf
    from continuousnf_tpu.data import matrix_to_table, table_to_matrix

    rows = np.random.default_rng(0).uniform(0.1, 0.9, size=(16, 2)).astype(np.float32)
    m, names = table_to_matrix({"a": rows[:, 0], "b": rows[:, 1]})
    assert m.shape == (16, 2) and names == ["a", "b"]
    np.testing.assert_allclose(np.asarray(m), rows, rtol=1e-6)

    try:
        import pandas as pd
    except Exception:
        pd = None
    if pd is not None:
        m2, names2 = table_to_matrix(pd.DataFrame(rows, columns=["a", "b"]))
        assert names2 == ["a", "b"]
        np.testing.assert_allclose(np.asarray(m2), rows, rtol=1e-6)

    nn = cnf.MLP((2, 8, 2))
    icnf = cnf.construct(cnf.RNODE, nn, 2, 0, tspan=(0.0, 1.0))
    model = cnf.ICNFModel(icnf, n_epochs=1, batch_size=8)
    res = cnf.fit(model, {"a": rows[:, 0], "b": rows[:, 1]}, key=jax.random.PRNGKey(0))
    ps, st = cnf.fitted_params(res)
    assert st == {} and ps is res.ps

    tbl = cnf.transform(res, rows[:4], as_table=True)
    if pd is not None:
        assert list(tbl.columns) == ["px"] and len(tbl) == 4
        px = tbl["px"].to_numpy()
    else:
        px = tbl["px"]
    assert np.isfinite(px).all() and (px > 0).all()


def test_named_table_column_reorder_and_default_table_output():
    """A named table scored with reordered columns must give the same px as
    the fit-time order, and tabular inputs get a table back by default."""
    import jax
    import numpy as np

    import continuousnf_tpu as cnf

    rows = np.random.default_rng(1).uniform(0.1, 0.9, size=(12, 2)).astype(np.float32)
    tbl = {"a": rows[:, 0], "b": rows[:, 1]}
    nn = cnf.MLP((2, 8, 2))
    icnf = cnf.construct(cnf.RNODE, nn, 2, 0, tspan=(0.0, 1.0))
    model = cnf.ICNFModel(icnf, n_epochs=1, batch_size=8)
    res = cnf.fit(model, tbl, key=jax.random.PRNGKey(0))
    assert res.column_names == ["a", "b"]

    out = cnf.transform(res, tbl)  # named input -> table output by default
    px = out["px"].to_numpy() if hasattr(out, "to_numpy") else np.asarray(out["px"])
    out_swapped = cnf.transform(res, {"b": rows[:, 1], "a": rows[:, 0]}, as_table=False)
    np.testing.assert_allclose(np.asarray(out_swapped), px, rtol=1e-5)

    import pytest

    with pytest.raises(ValueError, match="columns"):
        cnf.transform(res, {"a": rows[:, 0], "c": rows[:, 1]})

    # Array inputs keep returning a plain array.
    arr = cnf.transform(res, rows)
    assert not isinstance(arr, dict) and np.asarray(arr).shape == (12,)


def test_icnfdist_from_fit():
    import jax
    import numpy as np

    import continuousnf_tpu as cnf

    rows = np.random.default_rng(2).uniform(0.1, 0.9, size=(8, 1)).astype(np.float32)
    icnf = cnf.construct(cnf.RNODE, cnf.MLP((1, 4, 1)), 1, 0, tspan=(0.0, 1.0))
    model = cnf.ICNFModel(icnf, n_epochs=1, batch_size=8)
    res = cnf.fit(model, rows, key=jax.random.PRNGKey(0))
    d = cnf.ICNFDist.from_fit(res)
    np.testing.assert_allclose(
        np.asarray(d.pdf(rows)), np.asarray(cnf.transform(res, rows)), rtol=1e-6
    )
