"""The examples/ scripts are user-facing artifacts: run each CPU-safe
one end-to-end as a subprocess so API drift breaks CI, not a user.
(multihost_launch spawns its own jax.distributed processes and
bench_int8_serving measures a real device — both are exercised by their
dedicated tests/benches instead.)"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, timeout=600):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
    })
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script)],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=timeout)
    assert r.returncode == 0, f"{script} failed:\n{r.stdout[-3000:]}\n" \
                              f"{r.stderr[-3000:]}"
    return r.stdout


@pytest.mark.parametrize("script,expect", [
    ("production_fit.py", "served int8 accuracy"),
    ("autoencoder_digits.py", "reconstruction loss"),
    ("recurrent_sine.py", "predictions"),
    ("pipeline_parallel.py", "loss"),
    ("plan_and_budget.py", "analytic winner"),
])
def test_example_runs(script, expect):
    out = _run(script)
    assert expect in out, f"{script} output missing {expect!r}:\n" \
                          f"{out[-2000:]}"
