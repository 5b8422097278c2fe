"""Pipeline-parallelism tests on the virtual CPU mesh: the GPipe schedule
must compute exactly what the sequential layer chain computes, and
training through the pipelined scan must converge."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensor_ops.parallel.pipeline import (
    PipelineMLP,
    make_pipeline_mesh,
    pipeline_forward,
    pipeline_train_step,
    shard_pipeline_model,
)

multi = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 devices (see conftest note)"
)


def sequential_forward(model: PipelineMLP, xb):
    """The same network without any pipeline: plain layer chain."""
    h = jax.nn.sigmoid(xb @ model.w_in.T + model.b_in)
    S, L = model.stage_ws.shape[:2]
    for s in range(S):
        for k in range(L):
            h = jax.nn.sigmoid(h @ model.stage_ws[s, k].T + model.stage_bs[s, k])
    z = h @ model.w_out.T + model.b_out
    return jax.nn.softmax(z, axis=-1)


@multi
def test_pipeline_forward_matches_sequential():
    mesh = make_pipeline_mesh(4)
    model = PipelineMLP.init(6, 16, 4, n_stages=4, layers_per_stage=2,
                             key=jax.random.PRNGKey(0))
    model = shard_pipeline_model(model, mesh)
    xb = jax.random.uniform(jax.random.PRNGKey(1), (8, 6))
    got = np.asarray(pipeline_forward(model, mesh, xb, n_microbatches=4))
    want = np.asarray(sequential_forward(model, xb))
    np.testing.assert_allclose(got, want, atol=1e-6)


@multi
def test_pipeline_training_converges():
    mesh = make_pipeline_mesh(4)
    # larger init keeps deep logistic chains out of the vanishing-
    # gradient regime so plain SGD converges in test time
    model = PipelineMLP.init(4, 16, 2, n_stages=4, layers_per_stage=1,
                             key=jax.random.PRNGKey(2), scale=4.0)
    model = shard_pipeline_model(model, mesh)
    step = pipeline_train_step(model, mesh, n_microbatches=4)

    r = np.random.default_rng(0)
    X = r.uniform(-1, 1, size=(64, 4)).astype(np.float32)
    labels = (X[:, 0] > 0).astype(int)
    Y = np.eye(2, dtype=np.float32)[labels]
    xb, yb = jnp.asarray(X), jnp.asarray(Y)

    params = model.params()
    v0, params = step(1.0, xb, yb, *params)
    losses = [float(v0)]
    for _ in range(300):
        v, params = step(1.0, xb, yb, *params)
        losses.append(float(v))
    assert losses[-1] < 0.1 * losses[0], losses[:3] + losses[-3:]


@multi
def test_pipeline_grad_matches_sequential_grad():
    """Gradients through the pipelined scan == gradients of the plain
    chain (the pipeline is just a schedule, not a different function)."""
    mesh = make_pipeline_mesh(4)
    model = PipelineMLP.init(4, 8, 3, n_stages=4, layers_per_stage=1,
                             key=jax.random.PRNGKey(3))
    model = shard_pipeline_model(model, mesh)
    xb = jax.random.uniform(jax.random.PRNGKey(4), (8, 4))
    yb = jnp.asarray(np.eye(3, dtype=np.float32)[np.arange(8) % 3])

    step = pipeline_train_step(model, mesh, n_microbatches=4)
    _, new_params = step(1.0, xb, yb, *model.params())

    def seq_loss(params):
        m = PipelineMLP(*params)
        p = sequential_forward(m, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    grads = jax.grad(seq_loss)(model.params())
    want = [p - 1.0 * g for p, g in zip(model.params(), grads)]
    for a, b in zip(new_params, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@multi
def test_dp_pipeline_combined():
    """2D (data=2, stage=4) mesh: dp x pp in one training step, same
    numbers as the sequential chain."""
    from tensor_ops.parallel.pipeline import make_dp_pipeline_mesh

    mesh = make_dp_pipeline_mesh(2, 4)
    model = PipelineMLP.init(4, 8, 3, n_stages=4, layers_per_stage=1,
                             key=jax.random.PRNGKey(5))
    model = shard_pipeline_model(model, mesh)
    xb = jax.random.uniform(jax.random.PRNGKey(6), (16, 4))
    got = np.asarray(pipeline_forward(model, mesh, xb, n_microbatches=4))
    want = np.asarray(sequential_forward(model, xb))
    np.testing.assert_allclose(got, want, atol=1e-6)

    yb = jnp.asarray(np.eye(3, dtype=np.float32)[np.arange(16) % 3])
    step = pipeline_train_step(model, mesh, n_microbatches=4)
    _, new_params = step(1.0, xb, yb, *model.params())

    def seq_loss(params):
        m = PipelineMLP(*params)
        p = sequential_forward(m, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    grads = jax.grad(seq_loss)(model.params())
    want_p = [p - g for p, g in zip(model.params(), grads)]
    for a, b in zip(new_params, want_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@multi
def test_3d_dp_pp_tp_combined():
    """3D (data=2, stage=2, model=2) mesh: dp x pp x tp in one training
    step — forward and gradients exactly equal the sequential chain."""
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    mesh = make_3d_pipeline_mesh(2, 2, 2)
    model = PipelineMLP.init(4, 8, 3, n_stages=2, layers_per_stage=2,
                             key=jax.random.PRNGKey(7))
    model = shard_pipeline_model(model, mesh)
    xb = jax.random.uniform(jax.random.PRNGKey(8), (8, 4))
    got = np.asarray(pipeline_forward(model, mesh, xb, n_microbatches=2))
    want = np.asarray(sequential_forward(model, xb))
    np.testing.assert_allclose(got, want, atol=1e-6)

    yb = jnp.asarray(np.eye(3, dtype=np.float32)[np.arange(8) % 3])
    step = pipeline_train_step(model, mesh, n_microbatches=2)
    _, new_params = step(1.0, xb, yb, *model.params())

    def seq_loss(params):
        m = PipelineMLP(*params)
        p = sequential_forward(m, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    grads = jax.grad(seq_loss)(model.params())
    want_p = [p - g for p, g in zip(model.params(), grads)]
    for a, b in zip(new_params, want_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@multi
def test_circular_schedule_matches_sequential():
    """Circular (interleaved) pipeline: 8 global stages on 4 devices
    (V=2) computes exactly the sequential chain, forward and gradients."""
    from tensor_ops.parallel.pipeline import (
        circular_pipeline_forward,
        circular_pipeline_train_step,
        shard_circular_model,
    )

    mesh = make_pipeline_mesh(4)
    model = PipelineMLP.init(4, 8, 3, n_stages=8, layers_per_stage=1,
                             key=jax.random.PRNGKey(9))
    cmodel = shard_circular_model(model, mesh)
    xb = jax.random.uniform(jax.random.PRNGKey(10), (8, 4))
    got = np.asarray(circular_pipeline_forward(cmodel, mesh, xb,
                                               n_microbatches=4))
    want = np.asarray(sequential_forward(model, xb))  # unpermuted chunks
    np.testing.assert_allclose(got, want, atol=1e-6)

    yb = jnp.asarray(np.eye(3, dtype=np.float32)[np.arange(8) % 3])
    step = circular_pipeline_train_step(cmodel, mesh, n_microbatches=4)
    _, new_params = step(1.0, xb, yb, *cmodel.params())

    def seq_loss(params):
        m = PipelineMLP(*params)
        p = sequential_forward(m, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    grads = jax.grad(seq_loss)(model.params())
    # compare on the permuted layout: permute the sequential grads too
    from tensor_ops.parallel.pipeline import _interleave_chunks

    want_ws = np.asarray(model.stage_ws) - np.asarray(grads[2])
    want_bs = np.asarray(model.stage_bs) - np.asarray(grads[3])
    np.testing.assert_allclose(
        np.asarray(new_params[2]),
        np.asarray(_interleave_chunks(jnp.asarray(want_ws), 4)), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_params[3]),
        np.asarray(_interleave_chunks(jnp.asarray(want_bs), 4)), atol=1e-5)
    # non-stage params compare directly
    for i in (0, 1, 4, 5):
        np.testing.assert_allclose(
            np.asarray(new_params[i]),
            np.asarray(model.params()[i]) - np.asarray(grads[i]), atol=1e-5)


@multi
def test_circular_schedule_with_tp_3d_mesh():
    """Circular schedule x tensor parallelism on a (data=2, stage=2,
    model=2) mesh: 4 global chunks on 2 stage devices (V=2), each chunk's
    layers row-sharded over the model axis — forward and gradients equal
    the sequential chain (closes the round-1 NotImplementedError)."""
    from tensor_ops.parallel.pipeline import (
        _interleave_chunks,
        circular_pipeline_forward,
        circular_pipeline_train_step,
        make_3d_pipeline_mesh,
        shard_circular_model,
    )

    mesh = make_3d_pipeline_mesh(2, 2, 2)
    model = PipelineMLP.init(4, 8, 3, n_stages=4, layers_per_stage=1,
                             key=jax.random.PRNGKey(13))
    cmodel = shard_circular_model(model, mesh)
    xb = jax.random.uniform(jax.random.PRNGKey(14), (8, 4))
    got = np.asarray(circular_pipeline_forward(cmodel, mesh, xb,
                                               n_microbatches=2))
    want = np.asarray(sequential_forward(model, xb))
    np.testing.assert_allclose(got, want, atol=1e-6)

    yb = jnp.asarray(np.eye(3, dtype=np.float32)[np.arange(8) % 3])
    step = circular_pipeline_train_step(cmodel, mesh, n_microbatches=2)
    _, new_params = step(1.0, xb, yb, *cmodel.params())

    def seq_loss(params):
        m = PipelineMLP(*params)
        p = sequential_forward(m, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    grads = jax.grad(seq_loss)(model.params())
    want_ws = np.asarray(model.stage_ws) - np.asarray(grads[2])
    want_bs = np.asarray(model.stage_bs) - np.asarray(grads[3])
    np.testing.assert_allclose(
        np.asarray(new_params[2]),
        np.asarray(_interleave_chunks(jnp.asarray(want_ws), 2)), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_params[3]),
        np.asarray(_interleave_chunks(jnp.asarray(want_bs), 2)), atol=1e-5)
    for i in (0, 1, 4, 5):
        np.testing.assert_allclose(
            np.asarray(new_params[i]),
            np.asarray(model.params()[i]) - np.asarray(grads[i]), atol=1e-5)


@multi
def test_circular_schedule_microbatch_fifo():
    """M > S: the wrapped activation waits M-S ticks in the ring-buffer
    FIFO; forward and gradients still exactly equal the sequential
    chain (8 microbatches on 4 stage devices, V=2 -> FIFO depth 4)."""
    from tensor_ops.parallel.pipeline import (
        _interleave_chunks,
        circular_pipeline_forward,
        circular_pipeline_train_step,
        shard_circular_model,
    )

    mesh = make_pipeline_mesh(4)
    model = PipelineMLP.init(4, 8, 3, n_stages=8, layers_per_stage=1,
                             key=jax.random.PRNGKey(21))
    cmodel = shard_circular_model(model, mesh)
    xb = jax.random.uniform(jax.random.PRNGKey(22), (16, 4))
    want = np.asarray(sequential_forward(model, xb))
    for M in (8, 16):  # FIFO depths 4 and 12
        got = np.asarray(circular_pipeline_forward(cmodel, mesh, xb,
                                                   n_microbatches=M))
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"M={M}")

    yb = jnp.asarray(np.eye(3, dtype=np.float32)[np.arange(16) % 3])
    step = circular_pipeline_train_step(cmodel, mesh, n_microbatches=8)
    _, new_params = step(1.0, xb, yb, *cmodel.params())

    def seq_loss(params):
        m = PipelineMLP(*params)
        p = sequential_forward(m, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    grads = jax.grad(seq_loss)(model.params())
    want_ws = np.asarray(model.stage_ws) - np.asarray(grads[2])
    want_bs = np.asarray(model.stage_bs) - np.asarray(grads[3])
    np.testing.assert_allclose(
        np.asarray(new_params[2]),
        np.asarray(_interleave_chunks(jnp.asarray(want_ws), 4)), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_params[3]),
        np.asarray(_interleave_chunks(jnp.asarray(want_bs), 4)), atol=1e-5)
    for i in (0, 1, 4, 5):
        np.testing.assert_allclose(
            np.asarray(new_params[i]),
            np.asarray(model.params()[i]) - np.asarray(grads[i]), atol=1e-5)


@multi
def test_circular_schedule_guards():
    from tensor_ops.parallel.pipeline import (
        circular_pipeline_train_step,
        shard_circular_model,
    )

    mesh = make_pipeline_mesh(4)
    model = PipelineMLP.init(4, 8, 2, n_stages=8, layers_per_stage=1,
                             key=jax.random.PRNGKey(11))
    cmodel = shard_circular_model(model, mesh)
    with pytest.raises(ValueError, match="n_microbatches"):
        circular_pipeline_train_step(cmodel, mesh, n_microbatches=2)
    bad = PipelineMLP.init(4, 8, 2, n_stages=6, layers_per_stage=1,
                           key=jax.random.PRNGKey(12))
    with pytest.raises(ValueError, match="divisible"):
        shard_circular_model(bad, mesh)
