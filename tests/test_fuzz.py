"""Randomized graph fuzzing: build random well-shaped op graphs from the
full combinator/primitive vocabulary, then check (a) NumPy-oracle vs
JAX/XLA parity of forward and gradients, and (b) gradients vs central
finite differences.  This probes interactions (fanout-inside-first,
shuffle feeding gmul, remat around par, ...) that directed tests can't
enumerate."""

import numpy as np
import pytest

from tensor_ops import prim as P
from tensor_ops.ops import ir
from tensor_ops.ops.ir import TOp

from helpers import check_grads_vs_jax, fd_grad

DIMS = (2, 3, 4)


def rand_shape(rng):
    rank = rng.integers(1, 3)
    return tuple(int(rng.choice(DIMS)) for _ in range(rank))


def rand_primitive(rng, in_stack):
    """A random op consuming a prefix of `in_stack`; returns (op, n_used)."""
    import jax.numpy as jnp

    choices = []
    s0 = in_stack[0]
    # unary ops on slot 0
    choices.append((P.map_op(s0, lambda a: jnp.tanh(a)), 1))
    choices.append((P.scale(s0, float(rng.uniform(0.5, 1.5))), 1))
    choices.append((P.transp_op(s0), 1))
    choices.append((P.duplicate(s0), 1))
    choices.append((P.remat(P.map_op(s0, lambda a: a * a + a)), 1))
    if len(s0) >= 1:
        choices.append((P.sum_rows(s0), 1))
    # binary ops when the next slot matches
    if len(in_stack) >= 2:
        s1 = in_stack[1]
        if s1 == s0:
            choices.append((P.add(s0), 2))
            choices.append((P.zip_op(s0, lambda a, b: a * b), 2))
            choices.append((P.swap(s0, s1), 2))
        # gmul: need s1 == reversed(contract of s0) ++ ns; use full
        # contraction when s1 == reversed(s0)
        if s1 == tuple(reversed(s0)):
            choices.append((P.gmul((), s0, ()), 2))
    i = int(rng.integers(0, len(choices)))
    return choices[i]


def rand_graph(rng, in_stack, depth=4):
    """Compose `depth` random layers over the stack."""
    op = P.identity(in_stack)
    stack = tuple(in_stack)
    for _ in range(depth):
        prim, used = rand_primitive(rng, stack)
        rest = stack[used:]
        layer = P.first(prim, rest=rest)
        if rng.uniform() < 0.25 and prim.in_stack == prim.out_stack:
            layer = P.first(P.fanout(prim, P.identity(prim.in_stack))
                            >> P.take(prim.out_stack, prim.in_stack),
                            rest=rest)
        op = op >> layer
        stack = op.out_stack
    return op


def scalarize(op):
    """Reduce all outputs to one scalar: square-contract each slot and sum."""
    out = op
    while len(out.out_stack) > 1 or out.out_stack[0] != ():
        st = out.out_stack
        s0 = st[0]
        if s0 == ():
            if len(st) == 1:
                break
            if st[1] == ():
                out = out >> P.first(P.add(()), rest=st[2:])
            else:
                # rotate the scalar to the back
                out = out >> P.swap_blocks([()], st[1:])
        else:
            red = (P.duplicate(s0)
                   >> P.second(P.transp_op(s0), front=[s0])
                   >> P.gmul((), s0, ()))
            out = out >> P.first(red, rest=st[1:])
    return out


@pytest.mark.parametrize("seed", range(20))
def test_random_graphs_parity_and_fd(seed, nb, jb):
    rng = np.random.default_rng(seed)
    n_in = int(rng.integers(1, 4))
    in_stack = tuple(rand_shape(rng) for _ in range(n_in))
    op = scalarize(rand_graph(rng, in_stack, depth=int(rng.integers(2, 6))))
    assert op.out_stack == ((),)

    xs = tuple(rng.normal(size=s) * 0.5 for s in in_stack)

    v_n, g_n = ir.value_and_grad(op, nb, xs)
    v_j, g_j = ir.value_and_grad(op, jb, tuple(jb.asarray(x) for x in xs))
    # 1e-6: tight enough to catch real defects
    assert abs(float(v_n) - float(v_j)) < 1e-6 * max(1.0, abs(float(v_n)))
    for a, b in zip(g_n, g_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)

    # finite differences on the numpy oracle (slot 0 only, for speed)
    fd = fd_grad(op, nb, xs, slot=0)
    np.testing.assert_allclose(np.asarray(g_n[0]), fd, atol=1e-4, rtol=1e-3)

    # third, INDEPENDENT oracle: jax.grad of the composed forward —
    # catches subtly-wrong-but-FD-close hand transpositions at ~1e-12
    check_grads_vs_jax(op, jb, xs)


@pytest.mark.parametrize("seed", range(6))
def test_random_recurrent_scan_fuzz(seed, nb, jb):
    """Random recurrent cells (random widths/activations/extra params)
    through ScanOp: numpy-vs-jax parity and FD on the initial state."""
    import jax.numpy as jnp

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models.neuralnet import (
        act_logistic,
        act_relu,
        act_tanh,
    )
    from tensor_ops.models.recurrent import RecurrentNetwork, fully_connected
    from tensor_ops.models import squared_error

    rng_np = np.random.default_rng(seed)
    i = int(rng_np.choice(DIMS))
    o = int(rng_np.choice(DIMS))
    act = [act_logistic, act_tanh, act_relu][int(rng_np.integers(0, 3))]()
    net = fully_connected(act, nb, i, o, Rng(nb, seed=seed + 100))
    if rng_np.uniform() < 0.5:
        o2 = int(rng_np.choice(DIMS))
        net = net.then(fully_connected(act_logistic(), nb, o, o2,
                                       Rng(nb, seed=seed + 200)))
        o = o2
    n = int(rng_np.integers(2, 6))
    xs = rng_np.normal(size=(n, i)) * 0.5
    tg = rng_np.normal(size=(n, o)) * 0.5
    loss = squared_error(o)

    v_n = float(np.asarray(net.seq_loss(loss, nb, xs, tg)))
    jnet = RecurrentNetwork(net.op,
                            tuple(jb.asarray(s) for s in net.states),
                            tuple(jb.asarray(p) for p in net.params))
    v_j = float(np.asarray(jnet.seq_loss(loss, jb, jb.asarray(xs), jb.asarray(tg))))
    assert abs(v_n - v_j) < 1e-6 * max(1.0, abs(v_n))

    _, gS, gP = net.seq_grad(loss, nb, xs, tg)
    _, gSj, gPj = jnet.seq_grad(loss, jb, jb.asarray(xs), jb.asarray(tg))
    for a, b in zip(gS + gP, gSj + gPj):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)

    # jax.grad oracle over the WHOLE scan graph (inputs, states, params,
    # targets all validated) — covers ScanOp's checkpointed backward
    seq_graph = jnet._seq_graph(loss, n)
    check_grads_vs_jax(seq_graph, jb,
                       (xs,) + net.states + net.params + (tg,))

    # FD on the first state's first entry
    eps = 1e-6
    sp = [s.copy() for s in net.states]
    sm = [s.copy() for s in net.states]
    sp[0][0] += eps
    sm[0][0] -= eps
    lp = float(np.asarray(RecurrentNetwork(net.op, tuple(sp), net.params)
                          .seq_loss(loss, nb, xs, tg)))
    lm = float(np.asarray(RecurrentNetwork(net.op, tuple(sm), net.params)
                          .seq_loss(loss, nb, xs, tg)))
    assert abs((lp - lm) / (2 * eps) - float(np.asarray(gS[0][0]))) < 1e-4


@pytest.mark.parametrize("seed", range(4))
def test_random_parallel_config_fuzz(seed):
    """Random (S, V, M, layers-per-stage, width, batch) circular/GPipe
    pipeline configurations: forward and one SGD step must exactly match
    the sequential chain.  Probes schedule/FIFO/interleave interactions
    the directed tests fix in place."""
    import jax
    import jax.numpy as jnp

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")

    from tensor_ops.parallel.pipeline import (
        PipelineMLP,
        circular_pipeline_forward,
        make_pipeline_mesh,
        pipeline_forward,
        shard_circular_model,
        shard_pipeline_model,
    )
    from tests.test_pipeline import sequential_forward

    rng = np.random.default_rng(100 + seed)
    S = int(rng.choice([2, 4, 8]))
    V = int(rng.choice([1, 2]))
    L = int(rng.choice([1, 2]))
    h = int(rng.choice([4, 8]))
    i, o = int(rng.choice([3, 5])), int(rng.choice([2, 4]))
    mesh = make_pipeline_mesh(S)
    model = PipelineMLP.init(i, h, o, n_stages=S * V, layers_per_stage=L,
                             key=jax.random.PRNGKey(seed))
    # batch: a multiple of a random M >= S
    M = int(rng.choice([S, 2 * S]))
    B = M * int(rng.choice([1, 2]))
    xb = jax.random.uniform(jax.random.PRNGKey(200 + seed), (B, i))
    want = np.asarray(sequential_forward(model, xb))

    cmodel = shard_circular_model(model, mesh)
    got_c = np.asarray(circular_pipeline_forward(cmodel, mesh, xb,
                                                 n_microbatches=M))
    np.testing.assert_allclose(got_c, want, atol=1e-5,
                               err_msg=f"circular S={S} V={V} M={M}")

    if V == 1:  # plain GPipe path only defined for V=1
        pmodel = shard_pipeline_model(model, mesh)
        got_g = np.asarray(pipeline_forward(pmodel, mesh, xb,
                                            n_microbatches=M))
        np.testing.assert_allclose(got_g, want, atol=1e-5,
                                   err_msg=f"gpipe S={S} M={M}")
