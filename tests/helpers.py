"""Shared test utilities — re-exported from the public
:mod:`tensor_ops.testing` module (single source of truth)."""

from tensor_ops.testing import (  # noqa: F401
    check_grads,
    check_grads_vs_jax,
    fd_grad,
    loop_gmul,
)
