"""Engine/jit-staging tests: compile caches, general VJP, bf16 dtype."""

import numpy as np
import pytest

import tensor_ops as T
from tensor_ops import engine
from tensor_ops import prim as P
from tensor_ops.ops import ir


from tensor_ops.testing import rand as r  # noqa: E402


def test_compile_vjp_general_cotangents(nb, jb):
    op = P.mat_vec(3, 2)
    xs = (r(0, 3, 2), r(1, 2))
    cts = (r(2, 3),)
    want = ir.vjp(op, nb, xs, cts)
    for be in (nb, jb):
        fn = engine.compile_vjp(op, be)
        got = fn(tuple(be.asarray(x) for x in xs), tuple(be.asarray(c) for c in cts))
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)


def test_cache_isolated_per_backend(nb, jb):
    op = P.dot(3)
    f1 = engine.compile_run(op, nb)
    f2 = engine.compile_run(op, jb)
    assert f1 is not f2
    assert engine.compile_run(op, nb) is f1


def test_bf16_backend_runs():
    import jax.numpy as jnp

    be = T.JaxBackend(dtype=jnp.bfloat16)
    op = P.mat_mat(4, 4, 4)
    a = be.asarray(r(3, 4, 4))
    b = be.asarray(r(4, 4, 4))
    out = ir.run(op, be, (a, b))[0]
    assert out.dtype == jnp.bfloat16
    want = np.asarray(a, dtype=np.float32) @ np.asarray(b, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(out, dtype=np.float32), want,
                               rtol=0.05, atol=0.05)


def test_bf16_training_step():
    import jax.numpy as jnp

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, cross_entropy, gen_net
    from tensor_ops.models.training import train_minibatch

    be = T.JaxBackend(dtype=jnp.bfloat16)
    rng = Rng(be, seed=0)
    net = gen_net(be, 8, 4, [(16, act_logistic())], act_softmax(), rng)
    xb = be.asarray(r(5, 8, 8))
    yb = be.asarray(np.eye(4)[np.arange(8) % 4])
    v, net2 = train_minibatch(net, cross_entropy(4), be, 0.1, xb, yb)
    assert np.isfinite(float(v))
    assert net2.params[0].dtype == jnp.bfloat16


def test_act_names_inferred_for_fused():
    import jax.numpy as jnp

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.models.fast import FusedMLP

    be = T.JaxBackend(dtype=jnp.float64)
    rng = Rng(be, seed=0)
    net = gen_net(be, 6, 3, [(4, act_logistic())], act_softmax(), rng)
    assert net.act_names == ("logistic", "softmax")
    fm = FusedMLP.from_network(net)  # acts inferred
    assert fm.acts == ("logistic", "identity") and fm.softmax_out


def test_cache_distinguishes_precision_and_native(nb):
    """Two backends that compile differently must not share jit caches
    (regression: precision/use_native were missing from cache keys)."""
    import jax.numpy as jnp

    import tensor_ops as T
    from tensor_ops import engine
    from tensor_ops import prim as P

    op = P.mat_vec(3, 2)
    jb_def = T.JaxBackend(dtype=jnp.float32)
    jb_hi = T.JaxBackend(dtype=jnp.float32, precision="highest")
    assert engine.compile_run(op, jb_def) is not engine.compile_run(op, jb_hi)

    nb_plain = T.NumpyBackend()
    try:
        nb_native = T.NumpyBackend(use_native=True)
    except RuntimeError:
        pytest.skip("no native toolchain")
    assert engine.compile_run(op, nb_plain) is not engine.compile_run(op, nb_native)


def test_optimizer_cache_distinguishes_hyperparams(jb):
    """Same-name optimizers with different hyperparameters get separate
    jitted steps (regression)."""
    import numpy as np

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, cross_entropy, gen_net
    from tensor_ops.models.optim import momentum
    from tensor_ops.models.trainer import make_opt_step

    rng = Rng(jb, seed=0)
    net = gen_net(jb, 3, 2, [(4, act_logistic())], act_logistic(), rng)
    loss = cross_entropy(2)
    f1 = make_opt_step(net, loss, jb, momentum(0.9))
    f2 = make_opt_step(net, loss, jb, momentum(0.0))
    assert f1 is not f2


def test_trained_network_keeps_act_names(jb):
    """Functional updates preserve act_names so the fused bridge works on
    trained networks (regression)."""
    import numpy as np

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, cross_entropy, gen_net
    from tensor_ops.models.fast import FusedMLP
    from tensor_ops.models.training import train_fold, train_minibatch

    rng = Rng(jb, seed=0)
    net = gen_net(jb, 4, 2, [(3, act_logistic())], act_softmax(), rng)
    loss = cross_entropy(2)
    x = jb.asarray(np.zeros((1, 4)) + 0.5)
    y = jb.asarray(np.eye(2)[[0]])
    n1 = net.train(loss, 0.1, jb, x[0], y[0])
    _, n2 = train_minibatch(n1, loss, jb, 0.1, x, y)
    n3 = train_fold(n2, loss, jb, 0.1, x, y)
    assert n3.act_names == ("logistic", "softmax")
    FusedMLP.from_network(n3)  # must not raise


def test_checkpoint_extensionless_path_roundtrip(tmp_path, nb):
    """save/load work for paths without .npz (regression: np.savez used
    to append the extension)."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, gen_net
    from tensor_ops.utils.checkpoint import load_network, save_network

    rng = Rng(nb, seed=0)
    net = gen_net(nb, 2, 2, [(3, act_logistic())], act_logistic(), rng)
    p = str(tmp_path / "ckpt")  # no extension
    save_network(p, net)
    import os

    assert os.path.exists(p) and not os.path.exists(p + ".npz")
    restored = load_network(p, net, nb)
    import numpy as np

    for a, b in zip(net.params, restored.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
