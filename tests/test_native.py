"""C++ native-runtime tests: math kernels cross-checked against the pure
NumPy oracle, the threaded loader's shuffle/batch/epoch semantics, and the
native-backed backend running a full training step."""

import numpy as np
import pytest

from tensor_ops.backend.numpy_backend import NumpyBackend
from tensor_ops.utils.native import (
    NativeLoader,
    get_lib,
    native_gmul,
    native_transpose,
)

needs_native = pytest.mark.skipif(get_lib() is None, reason="no native toolchain")


from tensor_ops.testing import rand as r  # noqa: E402


@needs_native
def test_native_gmul_matches_numpy(nb):
    for ms, os_, ns in [
        ((2,), (3,), ()),
        ((2,), (3, 4), (5,)),
        ((), (3,), ()),
        ((2, 3), (4,), (5, 2)),
        ((), (2, 3, 2), ()),
    ]:
        x = r(1, *(ms + os_))
        y = r(2, *(tuple(reversed(os_)) + ns))
        a = native_gmul(len(ms), len(os_), len(ns), x, y)
        b = nb.gmul(len(ms), len(os_), len(ns), x, y)
        np.testing.assert_allclose(a, b, atol=1e-12)


@needs_native
def test_native_transpose_matches_numpy(nb):
    for shape in [(2, 3), (2, 3, 4), (5,), (2, 1, 3, 2)]:
        x = r(3, *shape)
        np.testing.assert_allclose(native_transpose(x), nb.transp(x), atol=0)


@needs_native
def test_native_backend_training_parity():
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, gen_net, squared_error

    pure = NumpyBackend()
    nat = NumpyBackend(use_native=True)
    rng = Rng(pure, seed=4)
    net = gen_net(pure, 3, 2, [(5, act_logistic())], act_logistic(), rng)
    x, y = r(5, 3), np.array([0.3, 0.8])
    loss = squared_error(2)
    a = net.train(loss, 0.5, pure, x, y)
    b = net.train(loss, 0.5, nat, x, y)
    for p, q in zip(a.params, b.params):
        np.testing.assert_allclose(p, q, atol=1e-12)


@needs_native
def test_loader_covers_epoch_without_repeats():
    X = np.arange(20, dtype=np.float32).reshape(10, 2)
    Y = np.eye(10, dtype=np.float32)
    ld = NativeLoader(X, Y, batch=3, seed=7)
    seen = []
    for _ in range(4):  # 3+3+3+1 = one epoch
        xb, yb = ld.next()
        seen.extend(int(v) for v in xb[:, 0] // 2)
    assert sorted(seen) == list(range(10))
    ld.close()


@needs_native
def test_loader_reshuffles_across_epochs():
    X = np.arange(40, dtype=np.float32).reshape(20, 2)
    Y = np.zeros((20, 1), dtype=np.float32)
    ld = NativeLoader(X, Y, batch=20, seed=1)
    e1 = [int(v) for v in ld.next()[0][:, 0]]
    e2 = [int(v) for v in ld.next()[0][:, 0]]
    assert sorted(e1) == sorted(e2)
    assert e1 != e2  # different order (overwhelmingly likely)
    ld.close()


def test_loader_python_fallback_semantics(monkeypatch):
    import tensor_ops.utils.native as nat

    monkeypatch.setattr(nat, "get_lib", lambda: None)
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    Y = np.zeros((6, 1), dtype=np.float32)
    ld = nat.NativeLoader(X, Y, batch=4, seed=0)
    assert not ld.is_native
    a = ld.next()[0]
    b = ld.next()[0]
    assert a.shape[0] == 4 and b.shape[0] == 2


def test_loader_shards_are_disjoint_and_cover():
    """dp sharding: each rank's loader sees a disjoint slice; the union
    is the whole dataset (works for native and fallback alike)."""
    X = np.arange(22, dtype=np.float32).reshape(11, 2)
    Y = np.zeros((11, 1), dtype=np.float32)
    seen = []
    for rank in range(3):
        ld = NativeLoader(X, Y, batch=4, seed=7, shard=(rank, 3))
        rows = 0
        n_shard = ld.X.shape[0]
        while rows < n_shard:
            xb, _ = ld.next()
            seen.extend(int(v) for v in xb[:, 0] // 2)
            rows += xb.shape[0]
        ld.close()
    assert sorted(seen) == list(range(11))

    with pytest.raises(ValueError):
        NativeLoader(X, Y, batch=4, shard=(3, 3))
