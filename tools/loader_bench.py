"""Native CSV loader validation at UCI POWER scale.

Generates a synthetic POWER-shaped CSV (2,049,280 rows x 6 float columns —
the real UCI household-power file's shape; zero-egress environment, so the
bytes are synthetic but the parse volume is real), loads it through the
native mmap parser AND the NumPy fallback, checks equality, and reports
MB/s + rows/s.  The CSV is written to experiments/data/ (not tracked) and
removed afterwards unless --keep-csv names a path.

Usage: python tools/loader_bench.py [--rows 2049280] [--out loader.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_049_280)  # UCI POWER size
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--out", default="")
    ap.add_argument("--keep-csv", default="")
    args = ap.parse_args()

    from continuousnf_tpu.io.native_loader import load_csv, native_available

    rng = np.random.default_rng(0)
    # POWER-like marginals: positive, heavy-ish tails, 3-decimal formatting.
    data = np.abs(rng.normal(1.0, 0.8, size=(args.rows, args.cols))).astype(np.float32)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = args.keep_csv or os.path.join(repo, "experiments", "data", "power_synth.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    with open(path, "w") as f:
        header = ",".join(f"c{i}" for i in range(args.cols))
        f.write(header + "\n")
        np.savetxt(f, data, fmt="%.3f", delimiter=",")
    write_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6

    assert native_available(), "native tabloader failed to build"
    t0 = time.perf_counter()
    native, mean, std = load_csv(path, has_header=True, standardize=True)
    native_s = time.perf_counter() - t0

    # NumPy ground truth on a 200k-row prefix (full np.loadtxt is ~100x
    # slower; the prefix is equality evidence, not a benchmark).
    n_check = min(200_000, args.rows)
    t0 = time.perf_counter()
    ref = np.loadtxt(path, delimiter=",", skiprows=1, max_rows=n_check, dtype=np.float32)
    numpy_s = time.perf_counter() - t0
    ref_std = (ref - mean) / std
    max_err = float(np.max(np.abs(native[:n_check] - ref_std)))

    out = {
        "what": "native mmap CSV loader at UCI POWER scale (synthetic bytes, "
        "real volume; zero-egress environment)",
        "rows": int(native.shape[0]),
        "cols": int(native.shape[1]),
        "file_mb": round(size_mb, 1),
        "native_parse_s": round(native_s, 3),
        "native_mb_per_s": round(size_mb / native_s, 1),
        "native_rows_per_s": round(native.shape[0] / native_s, 0),
        "numpy_loadtxt_mb_per_s_prefix": round(
            (size_mb * n_check / args.rows) / numpy_s, 1
        ),
        "standardized_max_abs_err_vs_numpy_prefix": max_err,
        "standardize": {"mean0": float(mean[0]), "std0": float(std[0])},
    }
    assert native.shape == (args.rows, args.cols)
    assert max_err < 2e-3, max_err  # %.3f quantization + f32 accumulate
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not args.keep_csv:
        os.remove(path)


if __name__ == "__main__":
    main()
