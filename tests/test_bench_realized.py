"""The bench harness's realized-fit row stays runnable.

``bench.bench_fit_realized`` is the product-number row in the driver's
bench artifact (full production ``fit()`` wall clock, not a fori_loop
step rate — BENCH.md "fit() realized end-to-end throughput").  This
guards it from bitrot at toy sizes on the CPU mesh; the real-chip
number comes from ``python bench.py``.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402  (repo-root bench.py)


def test_bench_fit_realized_smoke():
    steps, rate = bench.bench_fit_realized(n=2048, batch=512, epochs=8)
    assert steps == 8 * (2048 // 512)
    assert rate > 0.0


def test_peak_table_knows_the_h100():
    peaks = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_tflops"] == 989.0 and peaks["hbm_tb_s"] == 3.35


def test_peak_table_refuses_unknown_devices():
    import pytest

    with pytest.raises(SystemExit, match="no peak table"):
        bench.peaks_for("cpu")


def test_bench_refuses_the_cpu():
    import pytest

    with pytest.raises(SystemExit):
        bench._provenance()
