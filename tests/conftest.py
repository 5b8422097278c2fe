"""Test configuration: JAX on a virtual 8-device CPU mesh (the multi-chip
paths without hardware — SURVEY.md §4) with float64 enabled for tight
parity bounds.

``TENSOR_OPS_TEST_GPU=1`` leaves JAX on the GPU instead: ``chip_smoke.py``
sets it to run the tests marked ``gpu`` on the card
(``TENSOR_OPS_TEST_GPU=1 python -m pytest tests -m gpu``).  Every pytest
worker sees the same environment, so every worker collects the same
tests; whether a card is present is decided per test, in a fixture."""

import os

import jax

if os.environ.get("TENSOR_OPS_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

import tensor_ops as T  # noqa: E402


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Tests marked ``gpu`` run only where JAX's backend is a GPU."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: TENSOR_OPS_TEST_GPU=1 python -m pytest "
                    "tests -m gpu on the card")


@pytest.fixture(scope="session")
def nb():
    return T.NumpyBackend()


@pytest.fixture(scope="session")
def jb():
    return T.JaxBackend(dtype=jnp.float64)


@pytest.fixture(scope="session")
def backends(nb, jb):
    return [nb, jb]
