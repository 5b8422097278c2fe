"""Structural jit-cache keys: reconstructing an identical loss/optimizer
must hit the existing cache entry (no recompile, no unbounded growth), and
two *different* ops must never collide — even when Python recycles object
ids (the round-1 hazard of keying on ``id(loss)``)."""

import gc

import numpy as np

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    adam,
    cross_entropy,
    gen_net,
    sgd,
    squared_error,
)
from tensor_ops.models.trainer import fit, make_opt_step


def _net(be, o=4):
    rng = Rng(be, seed=0)
    return gen_net(be, 6, o, [(8, act_logistic())], act_softmax(), rng)


def test_struct_key_equal_for_reconstructed_loss():
    assert cross_entropy(4).struct_key() == cross_entropy(4).struct_key()
    assert squared_error(3).struct_key() == squared_error(3).struct_key()


def test_struct_key_distinguishes_ops():
    assert cross_entropy(4).struct_key() != cross_entropy(5).struct_key()
    assert cross_entropy(4).struct_key() != squared_error(4).struct_key()


def test_struct_key_distinguishes_captured_values():
    """User lambdas capturing different values must NOT collide even
    though they share a code site."""
    from tensor_ops.ops import prim as P

    def scaled(k):
        return P.map_op((3,), lambda x: x * k)

    assert scaled(2.0).struct_key() != scaled(3.0).struct_key()
    assert scaled(2.0).struct_key() == scaled(2.0).struct_key()


def test_id_reuse_cannot_alias(jb):
    """The round-1 hazard: construct a loss, let it die, construct a
    different loss (often landing at the same address) — the cache keys
    must still differ."""
    net = _net(jb)
    l1 = cross_entropy(4)
    k1 = l1.struct_key()
    addr1 = id(l1)
    del l1
    gc.collect()
    l2 = squared_error(4)
    # regardless of whether the allocator reused the address, the keys differ
    assert l2.struct_key() != k1
    # and composing against the net caches under distinct entries
    net._loss_op(cross_entropy(4))
    n_before = len(net.op._compiled)
    net._loss_op(squared_error(4))
    assert len(net.op._compiled) == n_before + 1
    del addr1


def test_fresh_loss_and_optimizer_hit_cache(jb):
    """fit(net, cross_entropy(o), optimizer=adam()) in a loop must not
    recompile per call: fresh-but-identical objects key identically."""
    net = _net(jb)
    f1 = make_opt_step(net, cross_entropy(4), jb, adam())
    n1 = len(net.op._compiled)
    f2 = make_opt_step(net, cross_entropy(4), jb, adam())
    assert f1 is f2
    assert len(net.op._compiled) == n1


def test_different_hyperparams_do_not_collide(jb):
    net = _net(jb)
    f1 = make_opt_step(net, cross_entropy(4), jb, adam(b1=0.9))
    f2 = make_opt_step(net, cross_entropy(4), jb, adam(b1=0.8))
    assert f1 is not f2


def test_fit_loop_cache_stable(jb):
    """End-to-end: two fit() calls with fresh loss/optimizer objects reuse
    the SAME optstep cache entries — a chained fit compiles exactly one
    chained window step plus one single step (for k==1 boundary windows:
    the always-logged first step and ragged epoch tails), and a second
    identical fit adds nothing."""
    net = _net(jb)
    r = np.random.default_rng(0)
    X = r.uniform(0, 1, size=(16, 6))
    Y = np.eye(4)[r.integers(0, 4, size=16)]
    fit(net, cross_entropy(4), jb, X, Y, epochs=1, batch_size=8,
        optimizer=sgd(), verbose=False)
    keys1 = {k for k in net.op._compiled if isinstance(k, tuple)
             and k and k[0] == "optstep"}
    fit(net, cross_entropy(4), jb, X, Y, epochs=1, batch_size=8,
        optimizer=sgd(), verbose=False)
    keys2 = {k for k in net.op._compiled if isinstance(k, tuple)
             and k and k[0] == "optstep"}
    assert keys1 == keys2 and len(keys1) == 2
    # ... and the pair differs ONLY in the chain flag of the key
    a, b = sorted(keys1, key=repr)
    assert sum(x != y for x, y in zip(a, b)) == 1

    # chaining disabled => the single unchained entry, still stable
    net2 = _net(jb)
    for _ in range(2):
        fit(net2, cross_entropy(4), jb, X, Y, epochs=1, batch_size=8,
            optimizer=sgd(), verbose=False, chain_steps=1)
    keys3 = {k for k in net2.op._compiled if isinstance(k, tuple)
             and k and k[0] == "optstep"}
    assert len(keys3) == 1


def test_accum_steps_divisibility_validated(jb):
    net = _net(jb)
    r = np.random.default_rng(0)
    X = r.uniform(0, 1, size=(12, 6))
    Y = np.eye(4)[r.integers(0, 4, size=12)]
    import pytest

    with pytest.raises(ValueError, match="divisible by accum_steps"):
        fit(net, cross_entropy(4), jb, X, Y, batch_size=10, accum_steps=3,
            verbose=False)


def test_callable_key_bound_methods_never_collide():
    """Bound methods expose a shared __code__ but behavior depends on
    __self__ state — they must key by identity, not structure."""
    from tensor_ops.ops.vfunc import callable_key

    class Act:
        def __init__(self, gain):
            self.gain = gain

        def f(self, x):
            return self.gain * x

    a, b = Act(0.1), Act(0.2)
    assert callable_key(a.f) != callable_key(b.f)


def test_callable_key_distinguishes_global_bindings():
    """Same code text compiled against different global bindings is
    different behavior (exec-built factories)."""
    from tensor_ops.ops.vfunc import callable_key

    def build(gain):
        ns = {"GAIN": gain}
        exec("def f(x):\n    return GAIN * x", ns)
        return ns["f"]

    assert callable_key(build(2)) != callable_key(build(3))


def test_callable_key_same_site_lambdas_still_equal():
    """The structural-cache win must survive the soundness fixes: two
    lambdas from the same code site referencing a module global key
    equal."""
    import jax.numpy as jnp  # noqa: F401

    from tensor_ops.ops.vfunc import callable_key

    def build():
        import jax.numpy as jnp

        return lambda x: 1.0 / (1.0 + jnp.exp(-x))

    assert callable_key(build()) == callable_key(build())


def test_callable_key_recursive_global_terminates():
    from tensor_ops.ops import vfunc as V

    src = "def fact(n):\n    return 1 if n <= 1 else n * fact(n - 1)"
    ns = {}
    exec(src, ns)
    k = V.callable_key(ns["fact"])
    assert k[0] in ("code", "id")


def test_compiled_cache_is_bounded_lru(jb):
    """Cycling 100 sequence lengths through a SequencePredictor must not
    grow the op cache past its LRU bound, and hot keys must stay cached
    (no recompile of recently used entries)."""
    from tensor_ops.models import act_logistic
    from tensor_ops.models.recurrent import fully_connected
    from tensor_ops.models.serve import SequencePredictor
    from tensor_ops.ops.ir import CompiledCache

    rng = Rng(jb, seed=0)
    rnet = fully_connected(act_logistic(), jb, 3, 3, rng)
    pred = SequencePredictor(rnet, jb, buckets=(1,))
    cache = rnet.op._compiled
    assert isinstance(cache, CompiledCache)
    x1 = np.zeros((1, 2, 3), np.float32)
    pred.predict(x1)  # the hot key: length 2
    hot = [k for k in cache if isinstance(k, tuple) and k[0] == "serve_seq"]
    assert len(hot) == 1
    hot_fn = cache.get(hot[0])
    for n in range(3, 103):
        pred.predict(np.zeros((1, n, 3), np.float32))
        cache.get(hot[0])  # a production hot path touches its key
    assert len(cache) <= cache.maxsize
    # the hot key survived 100 distinct insertions because it stayed recent
    assert cache.get(hot[0]) is hot_fn


def test_compiled_cache_evicts_cold_keys():
    from tensor_ops.ops.ir import CompiledCache

    c = CompiledCache(maxsize=4)
    for k in range(4):
        c[k] = k * 10
    c.get(0)  # refresh 0
    c[99] = 990  # evicts 1 (oldest untouched), not 0
    assert 0 in c and 1 not in c and len(c) == 4
