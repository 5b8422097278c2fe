"""Pipeline parallelism over the staged IR: gradients from the
shard_map/ppermute GPipe schedule must equal the SEQUENTIAL staged-IR
gradients (framework transposition AD) at 1e-9 — the sub-graphs are
identical; only the schedule differs."""

import numpy as np
import pytest

import jax

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    cross_entropy,
    gen_net,
    squared_error,
)
from tensor_ops.models.training import make_vmapped_grads
from tensor_ops.ops.shapes import ShapeError
from tensor_ops.parallel.ir_pipeline import (
    ir_pipeline_grads,
    ir_pipeline_train_step,
    network_segments,
    split_network,
    unchain,
)
from tensor_ops.parallel.pipeline import (
    make_dp_pipeline_mesh,
    make_pipeline_mesh,
)

multi = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 devices (see conftest note)"
)


def _uniform_chain(jb, h=6, n_layers=4, seed=0):
    """n_layers identical h->h logistic ffLayers — the reference's
    ``~*~`` chain (FeedForward.hs:82-90) with uniform cut points."""
    rng = Rng(jb, seed=seed)
    return gen_net(jb, h, h, [(h, act_logistic())] * (n_layers - 1),
                   act_logistic(), rng)


def _seq_grads(net, loss, be, xb, yb):
    """The sequential staged-IR batch-mean gradient."""
    vm = make_vmapped_grads(net, loss, be)
    vals, grads = vm(xb, yb, *net.params)
    return (np.mean(np.asarray(vals)),
            tuple(np.asarray(g).mean(axis=0) for g in grads))


def test_unchain_recovers_layers(jb):
    net = _uniform_chain(jb, h=5, n_layers=3)
    segs = unchain(net.op)
    assert len(segs) == 3
    for seg in segs:
        assert seg.in_stack == (((5,)), (5, 5), (5,)) or \
            seg.in_stack == ((5,), (5, 5), (5,))
        assert seg.out_stack == ((5,),)
    pairs = network_segments(net)
    assert sum(len(p) for _, p in pairs) == len(net.params)
    # params align: segment k holds params (w_k, b_k) in stack order
    for (seg, p), w, b in zip(pairs, net.params[0::2], net.params[1::2]):
        assert p[0] is w and p[1] is b


def test_split_network_uniform_body(jb):
    net = _uniform_chain(jb, h=4, n_layers=4)
    p = split_network(net, 4)
    assert p.n_body == 4 and not p.pre and not p.post
    assert p.body_params[0].shape == (4, 4, 4)
    assert p.body_params[1].shape == (4, 4)
    np.testing.assert_array_equal(np.asarray(p.to_network_params()[2]),
                                  np.asarray(net.params[2]))


def test_split_network_rejects_short_body(jb):
    net = _uniform_chain(jb, h=4, n_layers=2)
    with pytest.raises(ShapeError, match="structurally identical"):
        split_network(net, 4)


@multi
def test_ir_pipeline_grads_equal_sequential_uniform(jb):
    """The done-criterion: >=4-stage ffLayer chain, pipelined gradient ==
    sequential staged-IR gradient at 1e-9."""
    net = _uniform_chain(jb, h=6, n_layers=4)
    loss = squared_error(6)
    r = np.random.default_rng(0)
    xb = jb.asarray(r.uniform(0, 1, size=(8, 6)))
    yb = jb.asarray(r.uniform(0, 1, size=(8, 6)))

    v_seq, g_seq = _seq_grads(net, loss, jb, xb, yb)

    mesh = make_pipeline_mesh(4)
    gfn = ir_pipeline_grads(net, loss, jb, mesh, n_microbatches=2)
    _, pnet = ir_pipeline_train_step(net, loss, jb, mesh, 2)
    v_pp, flat_g = gfn(xb, yb, *pnet.flat_params())
    g_pp = pnet.unflatten(flat_g).to_network_params()

    assert abs(float(v_pp) - v_seq) < 1e-9
    assert len(g_pp) == len(g_seq)
    for a, b in zip(g_pp, g_seq):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


@multi
def test_ir_pipeline_with_pre_post_segments(jb):
    """Non-uniform ends (embed 8->16, project 16->4 softmax) run
    replicated around the pipelined uniform body; gradients still match
    sequential, cross-entropy loss included."""
    rng = Rng(jb, seed=3)
    net = gen_net(jb, 8, 4, [(16, act_logistic())] * 5, act_softmax(), rng)
    loss = cross_entropy(4)
    r = np.random.default_rng(1)
    xb = jb.asarray(r.uniform(0, 1, size=(8, 8)))
    yb = jb.asarray(np.eye(4)[r.integers(0, 4, size=8)])

    v_seq, g_seq = _seq_grads(net, loss, jb, xb, yb)

    mesh = make_pipeline_mesh(4)  # body = 4 uniform 16->16 segments
    step, pnet = ir_pipeline_train_step(net, loss, jb, mesh, 2)
    assert len(pnet.pre) == 1 and len(pnet.post) == 1 and pnet.n_body == 4
    v_pp, new_flat = step(0.5, xb, yb, *pnet.flat_params())
    assert abs(float(v_pp) - v_seq) < 1e-9

    new_net_params = pnet.unflatten(new_flat).to_network_params()
    for p, g, np_ in zip(net.params, g_seq, new_net_params):
        np.testing.assert_allclose(np.asarray(p) - 0.5 * g,
                                   np.asarray(np_), atol=1e-9)


@multi
def test_ir_pipeline_dp_pp_mesh(jb):
    """Combined dp x pp over the staged IR on a (2, 4) mesh."""
    net = _uniform_chain(jb, h=4, n_layers=4, seed=7)
    loss = squared_error(4)
    r = np.random.default_rng(2)
    xb = jb.asarray(r.uniform(0, 1, size=(8, 4)))
    yb = jb.asarray(r.uniform(0, 1, size=(8, 4)))

    v_seq, g_seq = _seq_grads(net, loss, jb, xb, yb)
    mesh = make_dp_pipeline_mesh(2, 4)
    gfn = ir_pipeline_grads(net, loss, jb, mesh, n_microbatches=2)
    _, pnet = ir_pipeline_train_step(net, loss, jb, mesh, 2)
    v_pp, flat_g = gfn(xb, yb, *pnet.flat_params())
    assert abs(float(v_pp) - v_seq) < 1e-9
    for a, b in zip(pnet.unflatten(flat_g).to_network_params(), g_seq):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


# ---------------------------------------------------------------------------
# heterogeneous stage partitioning (the flagship pipelines)
# ---------------------------------------------------------------------------


def _flagship(jb, seed=0):
    rng = Rng(jb, seed=seed)
    return gen_net(jb, 784, 10,
                   [(300, act_logistic()), (100, act_logistic())],
                   act_softmax(), rng)


def test_balanced_partition_minimizes_max():
    from tensor_ops.parallel.ir_pipeline import _balanced_partition

    assert _balanced_partition([10, 1, 1, 10], 2) == [(0, 2), (2, 4)]
    assert _balanced_partition([5, 5, 5], 3) == [(0, 1), (1, 2), (2, 3)]
    b = _balanced_partition([1, 1, 1, 1, 100], 2)
    assert b == [(0, 4), (4, 5)]


def test_split_network_hetero_flagship(jb):
    from tensor_ops.parallel.ir_pipeline import split_network_hetero

    net = _flagship(jb)
    p = split_network_hetero(net, 3)
    assert p.n_stages == 3 and p.width == 784
    # one layer per stage: the FLOP balance puts the 784x300 layer alone
    assert [len(ops) for ops in p.stage_ops] == [1, 1, 1]
    # round-trip: packed rows -> the exact original param stack
    back = p.to_network_params()
    assert len(back) == len(net.params)
    for a, b in zip(back, net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_partition_network_dispatch(jb):
    from tensor_ops.parallel.ir_pipeline import (
        HeteroPipelinedNetwork, PipelinedNetwork, partition_network)

    assert isinstance(partition_network(_uniform_chain(jb, n_layers=4), 4),
                      PipelinedNetwork)
    assert isinstance(partition_network(_flagship(jb), 3),
                      HeteroPipelinedNetwork)


@multi
def test_hetero_pipeline_flagship_grads_equal_sequential(jb):
    """THE round-2 gap: the REAL 784->300->100->10 flagship
    (`/root/reference/app/MNIST.hs:89-104`) pipelines through the staged
    IR, and one pipelined SGD step lands on exactly the sequential
    staged-IR step's params (1e-9)."""
    from tensor_ops.parallel.ir_pipeline import ir_pipeline_train_step

    net = _flagship(jb)
    loss = cross_entropy(10)
    mesh = make_pipeline_mesh(3)
    r = np.random.default_rng(0)
    B = 12
    xb = jb.asarray(r.uniform(0, 1, size=(B, 784)))
    yb = jb.asarray(np.eye(10)[r.integers(0, 10, size=B)])

    step, pnet = ir_pipeline_train_step(net, loss, jb, mesh,
                                        n_microbatches=4)
    v, new_flat = step(0.1, xb, yb, *pnet.flat_params())
    got = pnet.unflatten(tuple(new_flat)).to_network_params()

    sv, g = _seq_grads(net, loss, jb, np.asarray(xb), np.asarray(yb))
    assert abs(float(v) - sv) < 1e-9
    for p, gg, nn in zip(net.params, g, got):
        np.testing.assert_allclose(np.asarray(p) - 0.1 * gg,
                                   np.asarray(nn), atol=1e-9, rtol=0)


@multi
def test_hetero_fit_pipeline_flagship(jb, tmp_path):
    """fit(mesh=stage mesh) on the flagship (heterogeneous partition):
    loss curve equals single-device fit at 1e-9, checkpoint stays
    servable, crash/resume matches the uninterrupted run."""
    from tensor_ops.models import adam
    from tensor_ops.models.trainer import fit
    from tensor_ops.utils.checkpoint import load_arrays

    r = np.random.default_rng(7)
    X = r.uniform(0, 1, size=(64, 784))
    Y = np.eye(10)[r.integers(0, 10, size=64)]
    loss = cross_entropy(10)
    mesh = make_dp_pipeline_mesh(2, 3)
    kw = dict(batch_size=16, lr=0.01, optimizer=adam(), verbose=False,
              prefetch=0, pipeline_microbatches=4, log_every=1)

    r_pp = fit(_flagship(jb, seed=3), loss, jb, X, Y, epochs=2,
               mesh=mesh, **kw)
    r_sd = fit(_flagship(jb, seed=3), loss, jb, X, Y, epochs=2,
               **{k: v for k, v in kw.items()
                  if k != "pipeline_microbatches"})
    for ra, rb in zip(r_pp.history, r_sd.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_pp.net.params, r_sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)

    ck = str(tmp_path / "hpp.npz")
    fit(_flagship(jb, seed=3), loss, jb, X, Y, epochs=1, mesh=mesh,
        checkpoint_path=ck, checkpoint_every=2, **kw)
    _, meta = load_arrays(ck)
    assert meta["kind"] == "feedforward"
    resumed = fit(_flagship(jb, seed=3), loss, jb, X, Y, epochs=2,
                  mesh=mesh, checkpoint_path=ck, checkpoint_every=2,
                  resume=True, **kw)
    for a, b in zip(resumed.net.params, r_pp.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# tensor parallelism composed with the staged-IR pipeline
# ---------------------------------------------------------------------------


def test_tp_local_segment_pattern_match(jb):
    from tensor_ops.parallel.ir_pipeline import (_tp_local_segment,
                                                     network_segments)

    net = _uniform_chain(jb, h=8, n_layers=3)
    seg_op = network_segments(net)[1][0]
    local = _tp_local_segment(seg_op, 2)
    assert local is not None
    assert local.in_stack == ((8,), (4, 8), (4,))
    assert local.out_stack == ((4,),)
    # softmax tails don't rowshard
    rng = Rng(jb, seed=1)
    smax = gen_net(jb, 8, 8, [], act_softmax(), rng)
    assert _tp_local_segment(network_segments(smax)[0][0], 2) is None
    # non-divisible width doesn't either
    odd = _uniform_chain(jb, h=9, n_layers=3)
    assert _tp_local_segment(network_segments(odd)[1][0], 2) is None


def test_tp_local_segment_matches_full_rowwise(jb):
    """The local segment IS the row-slice of the full segment: applying
    it to the sliced params reproduces the matching output rows."""
    from tensor_ops.ops import ir
    from tensor_ops.parallel.ir_pipeline import (_tp_local_segment,
                                                     network_segments)

    net = _uniform_chain(jb, h=8, n_layers=3, seed=5)
    (seg_op, (w, b)) = network_segments(net)[1]
    local = _tp_local_segment(seg_op, 2)
    x = jb.asarray(np.random.default_rng(2).normal(size=(8,)))
    full = np.asarray(ir.run(seg_op, jb, (x, w, b))[0])
    lo = np.asarray(ir.run(local, jb, (x, w[:4], b[:4]))[0])
    hi = np.asarray(ir.run(local, jb, (x, w[4:], b[4:]))[0])
    np.testing.assert_allclose(np.concatenate([lo, hi]), full, atol=1e-12)


@multi
def test_ir_pipeline_tp_grads_equal_sequential(jb):
    """(stage=2, model=2) + dp: pipelined-and-tensor-parallel staged-IR
    gradients equal the sequential framework gradients at 1e-9."""
    from tensor_ops.parallel.ir_pipeline import ir_pipeline_train_step
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    net = _uniform_chain(jb, h=8, n_layers=5, seed=9)  # 4-segment body
    loss = cross_entropy(8)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    r = np.random.default_rng(3)
    B = 8
    xb = jb.asarray(r.uniform(0, 1, size=(B, 8)))
    yb = jb.asarray(np.eye(8)[r.integers(0, 8, size=B)])

    step, pnet = ir_pipeline_train_step(net, loss, jb, mesh,
                                        n_microbatches=2)
    v, new_flat = step(0.1, xb, yb, *pnet.flat_params())
    got = pnet.unflatten(tuple(new_flat)).to_network_params()
    sv, g = _seq_grads(net, loss, jb, np.asarray(xb), np.asarray(yb))
    assert abs(float(v) - sv) < 1e-9
    for p, gg, nn in zip(net.params, g, got):
        np.testing.assert_allclose(np.asarray(p) - 0.1 * gg,
                                   np.asarray(nn), atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# circular (interleaved) schedule over the staged IR
# ---------------------------------------------------------------------------


def test_interleave_perm_roundtrip(jb):
    from tensor_ops.parallel.ir_pipeline import (
        split_network_circular)

    net = _uniform_chain(jb, h=4, n_layers=9, seed=11)  # 8-segment body
    p = split_network_circular(net, 4, 2)  # S=4, V=2, Lc=1
    assert p.n_stages == 4 and p.n_chunks == 2
    back = p.to_network_params()
    for a, b in zip(back, net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@multi
@pytest.mark.parametrize("M", [4, 6])
def test_ir_circular_grads_equal_sequential(jb, M):
    """Circular staged-IR schedule (V=2 chunks/device, M == S and the
    M > S FIFO case): gradients == sequential transposition AD at
    1e-9."""
    net = _uniform_chain(jb, h=4, n_layers=9, seed=13)  # 8-segment body
    loss = squared_error(4)
    r = np.random.default_rng(4)
    xb = jb.asarray(r.uniform(0, 1, size=(12, 4)))
    yb = jb.asarray(r.uniform(0, 1, size=(12, 4)))

    v_seq, g_seq = _seq_grads(net, loss, jb, xb, yb)
    mesh = make_pipeline_mesh(4)
    gfn = ir_pipeline_grads(net, loss, jb, mesh, n_microbatches=M,
                            schedule="circular", n_chunks=2)
    _, pnet = ir_pipeline_train_step(net, loss, jb, mesh, M,
                                     schedule="circular", n_chunks=2)
    v_pp, flat_g = gfn(xb, yb, *pnet.flat_params())
    assert abs(float(v_pp) - v_seq) < 1e-9
    for a, b in zip(pnet.unflatten(flat_g).to_network_params(), g_seq):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


@multi
def test_ir_circular_with_tp(jb):
    """Circular schedule composed with tensor parallelism on a
    (stage=2, model=2) mesh (+ V=2 chunks): still == sequential."""
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    net = _uniform_chain(jb, h=8, n_layers=5, seed=17)  # 4-segment body
    loss = cross_entropy(8)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    r = np.random.default_rng(5)
    xb = jb.asarray(r.uniform(0, 1, size=(8, 8)))
    yb = jb.asarray(np.eye(8)[r.integers(0, 8, size=8)])

    v_seq, g_seq = _seq_grads(net, loss, jb, np.asarray(xb), np.asarray(yb))
    gfn = ir_pipeline_grads(net, loss, jb, mesh, n_microbatches=2,
                            schedule="circular", n_chunks=2)
    _, pnet = ir_pipeline_train_step(net, loss, jb, mesh, 2,
                                     schedule="circular", n_chunks=2)
    v_pp, flat_g = gfn(xb, yb, *pnet.flat_params())
    assert abs(float(v_pp) - v_seq) < 1e-9
    for a, b in zip(pnet.unflatten(flat_g).to_network_params(), g_seq):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


@multi
def test_fit_circular_ir_pipeline(jb, tmp_path):
    """fit(pipeline_schedule='circular'): same loss curve as the GPipe
    schedule and as single-device (identical math, different overlap),
    with checkpoint/resume intact."""
    from tensor_ops.models import adam
    from tensor_ops.models.trainer import fit

    r = np.random.default_rng(19)
    X = r.uniform(0, 1, size=(64, 12))
    Y = np.eye(2)[r.integers(0, 2, size=64)]
    loss = cross_entropy(2)
    mesh = make_pipeline_mesh(4)
    kw = dict(epochs=2, batch_size=16, lr=0.01, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1,
              pipeline_microbatches=4)

    def net():
        rng = Rng(jb, seed=21)
        return gen_net(jb, 12, 2, [(16, act_logistic())] * 9,
                       act_softmax(), rng)

    r_circ = fit(net(), loss, jb, X, Y, mesh=mesh,
                 pipeline_schedule="circular", pipeline_chunks=2, **kw)
    r_sd = fit(net(), loss, jb, X, Y, **{
        k: v for k, v in kw.items() if k != "pipeline_microbatches"})
    for ra, rb in zip(r_circ.history, r_sd.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_circ.net.params, r_sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)

    ck = str(tmp_path / "circ.npz")
    fit(net(), loss, jb, X, Y, mesh=mesh, pipeline_schedule="circular",
        pipeline_chunks=2, epochs=1, checkpoint_path=ck,
        checkpoint_every=2, **{k: v for k, v in kw.items()
                               if k != "epochs"})
    resumed = fit(net(), loss, jb, X, Y, mesh=mesh,
                  pipeline_schedule="circular", pipeline_chunks=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    for a, b in zip(resumed.net.params, r_circ.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# heterogeneous pipeline x tensor parallelism
# ---------------------------------------------------------------------------


def _pyramid(jb, seed=0):
    """Autoencoder-style all-elementwise chain: 16->8->4->8->16 logistic
    — every segment row-shards (no softmax tail), widths all divide 2."""
    rng = Rng(jb, seed=seed)
    return gen_net(jb, 16, 16,
                   [(8, act_logistic()), (4, act_logistic()),
                    (8, act_logistic())],
                   act_logistic(), rng)


def test_split_hetero_tp_roundtrip(jb):
    from tensor_ops.parallel.ir_pipeline import split_network_hetero_tp

    net = _pyramid(jb)
    p = split_network_hetero_tp(net, 2, 2)
    assert p is not None and p.n_stages == 2 and p.tp == 2
    assert p.packed.shape[0] == 2 and p.packed.shape[1] == 2
    back = p.to_network_params()
    assert len(back) == len(net.params)
    for a, b in zip(back, net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # softmax-tailed flagship DOES hetero-tp (round 3): the affine rows
    # + exp shard; the normalization runs replicated after the gather
    rng = Rng(jb, seed=1)
    smax = gen_net(jb, 16, 4, [(8, act_logistic())], act_softmax(), rng)
    ps = split_network_hetero_tp(smax, 2, 2)
    assert ps is not None and ps.n_stages == 2
    assert ps.local_ops[-1][-1][1] is not None  # replicated softmax suffix
    assert ps.local_ops[0][0][1] is None        # logistic tail stays local
    back = ps.to_network_params()
    for a, b in zip(back, smax.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # odd (non-divisible) widths still fall back
    odd = gen_net(jb, 16, 5, [(8, act_logistic())], act_softmax(), rng)
    assert split_network_hetero_tp(odd, 2, 2) is None


def test_split_hetero_tp_roundtrip_fuzz(jb):
    """Random chains (random tp-divisible widths, mixed activations,
    logistic or softmax head): split at every feasible (S, tp) and the
    packed per-shard row-slices must reassemble the exact Network
    stack; the tp-local segments must be width-consistent with their
    suffixes.  Pure structure — no mesh required."""
    from tensor_ops.models import act_relu, act_tanh
    from tensor_ops.parallel.ir_pipeline import split_network_hetero_tp

    r = np.random.default_rng(0)
    acts = [act_logistic, act_relu, act_tanh]
    for trial in range(12):
        tp = int(r.choice([2, 4]))
        n_layers = int(r.integers(2, 5))
        widths = [int(tp * r.integers(1, 5)) for _ in range(n_layers + 1)]
        hidden = [(w, acts[int(r.integers(0, 3))]())
                  for w in widths[1:-1]]
        head = act_softmax() if trial % 2 else act_logistic()
        net = gen_net(jb, widths[0], widths[-1], hidden, head,
                      Rng(jb, seed=100 + trial))
        S = int(r.integers(2, n_layers + 1))
        p = split_network_hetero_tp(net, S, tp)
        assert p is not None, (widths, S, tp)
        assert p.n_stages == S and p.tp == tp
        if trial % 2:  # softmax head -> final segment has a suffix
            loc, suf = p.local_ops[-1][-1]
            assert suf is not None
            assert suf.in_stack == ((widths[-1],),)
            assert loc.out_stack[0][0] == widths[-1] // tp
        back = p.to_network_params()
        assert len(back) == len(net.params)
        for a, b in zip(back, net.params):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@multi
def test_hetero_tp_grads_equal_sequential(jb):
    """(stage=2, model=2) + dp on the all-elementwise pyramid: the
    tp-sharded heterogeneous pipeline == sequential at 1e-9, with the
    packed params genuinely sharded over BOTH axes."""
    from tensor_ops.parallel.ir_pipeline import (
        HeteroTpPipelinedNetwork, ir_pipeline_train_step, partition_network,
        shard_pipelined_params)
    from tensor_ops.parallel.pipeline import STAGE_AXIS, make_3d_pipeline_mesh
    from tensor_ops.parallel.mesh import MODEL_AXIS

    net = _pyramid(jb, seed=3)
    loss = squared_error(16)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    part = partition_network(net, 2, mesh)
    assert isinstance(part, HeteroTpPipelinedNetwork)
    spnet = shard_pipelined_params(part, mesh)
    spec = tuple(spnet.packed.sharding.spec)
    assert spec[0] == STAGE_AXIS and spec[1] == MODEL_AXIS
    assert not spnet.packed.sharding.is_fully_replicated

    r = np.random.default_rng(4)
    B = 8
    xb = jb.asarray(r.uniform(0, 1, size=(B, 16)))
    yb = jb.asarray(r.uniform(0, 1, size=(B, 16)))
    step, pnet = ir_pipeline_train_step(net, loss, jb, mesh,
                                        n_microbatches=2)
    v, new_flat = step(0.1, xb, yb, *spnet.flat_params())
    got = pnet.unflatten(tuple(new_flat)).to_network_params()
    sv, g = _seq_grads(net, loss, jb, np.asarray(xb), np.asarray(yb))
    assert abs(float(v) - sv) < 1e-9
    for p, gg, nn in zip(net.params, g, got):
        np.testing.assert_allclose(np.asarray(p) - 0.1 * gg,
                                   np.asarray(nn), atol=1e-9, rtol=0)


@multi
def test_hetero_tp_mixed_precision_and_accum(jb, tmp_path):
    """The unified fit surface holds on the hetero-tp partition too:
    bf16 mixed precision trains to finite losses on the (2,2,2) mesh,
    and crash/resume under (hetero-tp x accum) equals the straight
    run."""
    from tensor_ops.models import adam
    from tensor_ops.models.trainer import fit
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    r = np.random.default_rng(31)
    X = r.uniform(0, 1, size=(64, 16))
    Y = r.uniform(0, 1, size=(64, 16))
    loss = squared_error(16)
    mesh = make_3d_pipeline_mesh(2, 2, 2)

    res = fit(_pyramid(jb, seed=32), loss, jb, X, Y, epochs=1,
              batch_size=16, lr=0.05, mixed_precision="bf16",
              pipeline_microbatches=2, mesh=mesh, verbose=False,
              prefetch=0, log_every=1)
    assert all(np.isfinite(h["loss"]) for h in res.history)

    ck = str(tmp_path / "htpacc.npz")
    kw = dict(batch_size=16, lr=0.01, optimizer=adam(), accum_steps=2,
              pipeline_microbatches=2, mesh=mesh, verbose=False,
              prefetch=0)
    fit(_pyramid(jb, seed=33), loss, jb, X, Y, epochs=1,
        checkpoint_path=ck, checkpoint_every=2, **kw)
    resumed = fit(_pyramid(jb, seed=33), loss, jb, X, Y, epochs=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    straight = fit(_pyramid(jb, seed=33), loss, jb, X, Y, epochs=2, **kw)
    assert resumed.steps == straight.steps == 8
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-7, rtol=1e-7)


@multi
def test_hetero_tp_softmax_grads_equal_sequential(jb):
    """(stage=2, model=2) + dp on a flagship-shaped softmax net
    (16->8->4, logistic hidden, softmax head, cross-entropy): the
    sharded-softmax decomposition (tp-local affine+exp, replicated
    normalization after the gather) == sequential at 1e-9."""
    from tensor_ops.parallel.ir_pipeline import (
        HeteroTpPipelinedNetwork, partition_network,
        shard_pipelined_params)
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    rng = Rng(jb, seed=11)
    net = gen_net(jb, 16, 4, [(8, act_logistic())], act_softmax(), rng)
    loss = cross_entropy(4)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    part = partition_network(net, 2, mesh)
    assert isinstance(part, HeteroTpPipelinedNetwork)
    spnet = shard_pipelined_params(part, mesh)

    r = np.random.default_rng(12)
    B = 8
    xb = jb.asarray(r.uniform(0, 1, size=(B, 16)))
    lbl = r.integers(0, 4, size=B)
    yb = jb.asarray(np.eye(4)[lbl])
    step, pnet = ir_pipeline_train_step(net, loss, jb, mesh,
                                        n_microbatches=2)
    v, new_flat = step(0.1, xb, yb, *spnet.flat_params())
    got = pnet.unflatten(tuple(new_flat)).to_network_params()
    sv, g = _seq_grads(net, loss, jb, np.asarray(xb), np.asarray(yb))
    assert abs(float(v) - sv) < 1e-9
    for p, gg, nn in zip(net.params, g, got):
        np.testing.assert_allclose(np.asarray(p) - 0.1 * gg,
                                   np.asarray(nn), atol=1e-9, rtol=0)


@multi
def test_hetero_tp_fit(jb, tmp_path):
    """fit on a (2,2,2) mesh with the pyramid: NO idle-model warning,
    loss curve == single-device at 1e-9, checkpoint/resume intact."""
    import warnings

    from tensor_ops.models import adam
    from tensor_ops.models.trainer import fit
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    r = np.random.default_rng(5)
    X = r.uniform(0, 1, size=(64, 16))
    Y = r.uniform(0, 1, size=(64, 16))
    loss = squared_error(16)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    kw = dict(epochs=2, batch_size=16, lr=0.05, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1,
              pipeline_microbatches=4)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r_tp = fit(_pyramid(jb, seed=6), loss, jb, X, Y, mesh=mesh, **kw)
    assert not any("model axis" in str(x.message) for x in w)
    r_sd = fit(_pyramid(jb, seed=6), loss, jb, X, Y, **{
        k: v for k, v in kw.items() if k != "pipeline_microbatches"})
    for ra, rb in zip(r_tp.history, r_sd.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_tp.net.params, r_sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)

    ck = str(tmp_path / "htp.npz")
    fit(_pyramid(jb, seed=6), loss, jb, X, Y, epochs=1, mesh=mesh,
        checkpoint_path=ck, checkpoint_every=2,
        **{k: v for k, v in kw.items() if k != "epochs"})
    resumed = fit(_pyramid(jb, seed=6), loss, jb, X, Y, mesh=mesh,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    for a, b in zip(resumed.net.params, r_tp.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# partition introspection
# ---------------------------------------------------------------------------


def test_describe_partition(jb):
    """describe_partition renders every partition kind with stage
    loads, widths, and the balance ratio."""
    from tensor_ops.parallel.ir_pipeline import (
        describe_partition, split_network, split_network_circular,
        split_network_hetero, split_network_hetero_tp)

    flag = gen_net(jb, 784, 10,
                   [(300, act_logistic()), (100, act_logistic())],
                   act_softmax(), Rng(jb, seed=0))
    s = describe_partition(split_network_hetero(flag, 3))
    assert "heterogeneous partition: 3 stages" in s
    assert "784->300" in s and "balance:" in s

    s = describe_partition(split_network_hetero_tp(flag, 2, 2))
    assert "tp=2" in s and "(+replicated tail)" in s
    assert "1/2 per shard" in s

    uni = _uniform_chain(jb, h=6, n_layers=4)
    s = describe_partition(split_network(uni, 2))
    assert "uniform partition" in s and "exactly balanced" in s

    s = describe_partition(split_network_circular(uni, 2, 2))
    assert "circular (interleaved)" in s and "2 chunks/device" in s

    with pytest.raises(TypeError, match="not a pipeline partition"):
        describe_partition(uni)


# ---------------------------------------------------------------------------
# heterogeneous circular (interleaved) schedule
# ---------------------------------------------------------------------------


def _deep_pyramid(jb, seed=0):
    """Autoencoder-style pyramid with 8 varied-width segments
    (24->20->16->12->8->12->16->20->24): the uniform circular split
    rejects it (no uniform run), the hetero circular cut takes it."""
    rng = Rng(jb, seed=seed)
    return gen_net(jb, 24, 24,
                   [(w, act_logistic()) for w in (20, 16, 12, 8, 12, 16, 20)],
                   act_logistic(), rng)


def test_split_hetero_circular_roundtrip(jb):
    from tensor_ops.parallel.ir_pipeline import (
        HeteroCircularPipelinedNetwork, partition_network_circular,
        split_network_hetero_circular)

    net = _deep_pyramid(jb)
    p = split_network_hetero_circular(net, 4, 2)
    assert p.S == 4 and p.V == 2 and p.packed.shape[:2] == (4, 2)
    assert p.in_width == 24 and p.out_width == 24 and p.width == 24
    back = p.to_network_params()
    assert len(back) == len(net.params)
    for a, b in zip(back, net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the dispatcher picks hetero circular for non-uniform chains
    assert isinstance(partition_network_circular(net, 4, 2),
                      HeteroCircularPipelinedNetwork)
    # ... and keeps the uniform interleaved cut for uniform ones
    from tensor_ops.parallel.ir_pipeline import CircularPipelinedNetwork

    assert isinstance(
        partition_network_circular(_uniform_chain(jb, h=4, n_layers=9), 4, 2),
        CircularPipelinedNetwork)


@multi
@pytest.mark.parametrize("M", [4, 6])
def test_hetero_circular_grads_equal_sequential(jb, M):
    """Hetero circular schedule (S=4, V=2 chunks/device; M == S and the
    M > S FIFO case): gradients == sequential transposition AD at
    1e-9 on a varied-width pyramid the uniform split rejects."""
    from tensor_ops.parallel.ir_pipeline import (
        HeteroCircularPipelinedNetwork)

    net = _deep_pyramid(jb, seed=23)
    loss = squared_error(24)
    r = np.random.default_rng(6)
    xb = jb.asarray(r.uniform(0, 1, size=(12, 24)))
    yb = jb.asarray(r.uniform(0, 1, size=(12, 24)))

    v_seq, g_seq = _seq_grads(net, loss, jb, xb, yb)
    mesh = make_pipeline_mesh(4)
    gfn = ir_pipeline_grads(net, loss, jb, mesh, n_microbatches=M,
                            schedule="circular", n_chunks=2)
    _, pnet = ir_pipeline_train_step(net, loss, jb, mesh, M,
                                     schedule="circular", n_chunks=2)
    assert isinstance(pnet, HeteroCircularPipelinedNetwork)
    v_pp, flat_g = gfn(xb, yb, *pnet.flat_params())
    assert abs(float(v_pp) - v_seq) < 1e-9
    for a, b in zip(pnet.unflatten(flat_g).to_network_params(), g_seq):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


@multi
def test_fit_hetero_circular_pipeline(jb, tmp_path):
    """fit(pipeline_schedule='circular') on a varied-width pyramid
    (hetero circular partition) on a dp x pp mesh: same loss curve as
    single-device, checkpoint/resume exact."""
    from tensor_ops.models import adam
    from tensor_ops.models.trainer import fit
    from tensor_ops.parallel.pipeline import make_dp_pipeline_mesh

    r = np.random.default_rng(29)
    X = r.uniform(0, 1, size=(64, 24))
    Y = r.uniform(0, 1, size=(64, 24))
    loss = squared_error(24)
    mesh = make_dp_pipeline_mesh(2, 4)
    kw = dict(epochs=2, batch_size=16, lr=0.01, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1,
              pipeline_microbatches=4)

    def net():
        return _deep_pyramid(jb, seed=31)

    r_circ = fit(net(), loss, jb, X, Y, mesh=mesh,
                 pipeline_schedule="circular", pipeline_chunks=2, **kw)
    r_sd = fit(net(), loss, jb, X, Y, **{
        k: v for k, v in kw.items() if k != "pipeline_microbatches"})
    for ra, rb in zip(r_circ.history, r_sd.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_circ.net.params, r_sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)

    ck = str(tmp_path / "hcirc.npz")
    fit(net(), loss, jb, X, Y, mesh=mesh, pipeline_schedule="circular",
        pipeline_chunks=2, epochs=1, checkpoint_path=ck,
        checkpoint_every=2, **{k: v for k, v in kw.items()
                               if k != "epochs"})
    resumed = fit(net(), loss, jb, X, Y, mesh=mesh,
                  pipeline_schedule="circular", pipeline_chunks=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    for a, b in zip(resumed.net.params, r_circ.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


def _odd_pyramid(jb, seed=0):
    """Varied-width pyramid whose hidden widths are ODD
    (24->21->15->9->7->9->15->21->24): no tp=2 row-split exists, so a
    model axis must fall back to the replicated hetero circular cut."""
    rng = Rng(jb, seed=seed)
    return gen_net(jb, 24, 24,
                   [(w, act_logistic()) for w in (21, 15, 9, 7, 9, 15, 21)],
                   act_logistic(), rng)


@multi
def test_hetero_circular_warns_idle_model_axis(jb):
    """A model axis in the mesh sits idle under the hetero circular
    partition when a segment width doesn't divide it (odd widths) —
    loudly, never silently."""
    import warnings

    from tensor_ops.models.trainer import fit
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    net = _odd_pyramid(jb, seed=37)
    r = np.random.default_rng(38)
    X = r.uniform(0, 1, size=(32, 24))
    Y = r.uniform(0, 1, size=(32, 24))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fit(net, squared_error(24), jb, X, Y, epochs=1, batch_size=16,
            verbose=False, prefetch=0, mesh=make_3d_pipeline_mesh(2, 2, 2),
            pipeline_schedule="circular", pipeline_chunks=2,
            pipeline_microbatches=2)
    assert any("model axis" in str(x.message) for x in w)


def test_describe_hetero_circular(jb):
    from tensor_ops.parallel.ir_pipeline import (
        describe_partition, split_network_hetero_circular)

    s = describe_partition(
        split_network_hetero_circular(_deep_pyramid(jb), 4, 2))
    assert "heterogeneous circular partition: 4 stages x 2 chunks" in s
    assert "chunk 7 (device 3, slot 1)" in s and "balance:" in s


# ---------------------------------------------------------------------------
# heterogeneous circular schedule x tensor parallelism
# ---------------------------------------------------------------------------


def test_split_hetero_tp_circular_roundtrip(jb):
    """The (S, V, tp, Lmax) packed per-shard chunk rows reassemble the
    exact Network stack; the dispatcher picks the tp cut only when a
    model axis exists AND every width divides it."""
    from tensor_ops.parallel.ir_pipeline import (
        CircularPipelinedNetwork, HeteroCircularPipelinedNetwork,
        HeteroTpCircularPipelinedNetwork, partition_network_circular,
        split_network_hetero_tp_circular)
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    net = _deep_pyramid(jb)
    p = split_network_hetero_tp_circular(net, 2, 2, 2)
    assert p is not None and p.S == 2 and p.V == 2 and p.tp == 2
    assert p.packed.shape[:3] == (2, 2, 2)
    assert p.in_width == 24 and p.out_width == 24 and p.width == 24
    back = p.to_network_params()
    assert len(back) == len(net.params)
    for a, b in zip(back, net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # softmax-tailed chain: the head's normalization is a replicated
    # suffix after the gather; everything else stays tp-local
    rng = Rng(jb, seed=1)
    smax = gen_net(jb, 16, 4, [(8, act_logistic())] * 3, act_softmax(),
                   rng)
    ps = split_network_hetero_tp_circular(smax, 2, 2, 2)
    assert ps is not None
    assert ps.local_ops[-1][-1][1] is not None  # replicated softmax tail
    assert ps.local_ops[0][0][1] is None
    for a, b in zip(ps.to_network_params(), smax.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # odd widths can't row-split
    assert split_network_hetero_tp_circular(_odd_pyramid(jb), 2, 2, 2) \
        is None

    if len(jax.devices()) >= 8:
        mesh = make_3d_pipeline_mesh(2, 2, 2)
        assert isinstance(
            partition_network_circular(net, 2, 2, mesh),
            HeteroTpCircularPipelinedNetwork)
        assert isinstance(
            partition_network_circular(_odd_pyramid(jb), 2, 2, mesh),
            HeteroCircularPipelinedNetwork)
        assert isinstance(
            partition_network_circular(
                _uniform_chain(jb, h=4, n_layers=8), 2, 2, mesh),
            CircularPipelinedNetwork)


def test_split_hetero_tp_circular_roundtrip_fuzz(jb):
    """Random chains (random tp-divisible widths, logistic or softmax
    head) split at every feasible (S, V, tp): the packed (S, V, tp,
    Lmax) per-shard chunk rows must reassemble the exact Network
    stack.  Pure structure — no mesh required."""
    from tensor_ops.models import act_relu, act_tanh
    from tensor_ops.parallel.ir_pipeline import (
        split_network_hetero_tp_circular)

    r = np.random.default_rng(7)
    acts = [act_logistic, act_relu, act_tanh]
    for trial in range(10):
        tp = int(r.choice([2, 4]))
        n_layers = int(r.integers(4, 9))
        widths = [int(tp * r.integers(1, 5)) for _ in range(n_layers + 1)]
        hidden = [(w, acts[int(r.integers(0, 3))]())
                  for w in widths[1:-1]]
        head = act_softmax() if trial % 2 else act_logistic()
        net = gen_net(jb, widths[0], widths[-1], hidden, head,
                      Rng(jb, seed=200 + trial))
        S = int(r.integers(2, 4))
        V = int(r.integers(1, 3))
        if S * V > n_layers:
            V = 1
        if S * V > n_layers:
            continue
        p = split_network_hetero_tp_circular(net, S, V, tp)
        assert p is not None, (widths, S, V, tp)
        assert p.S == S and p.V == V and p.tp == tp
        assert p.packed.shape[:3] == (S, V, tp)
        back = p.to_network_params()
        assert len(back) == len(net.params)
        for a, b in zip(back, net.params):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@multi
@pytest.mark.parametrize("M", [2, 4])
def test_hetero_tp_circular_grads_equal_sequential(jb, M):
    """Hetero circular x tp on the (2,2,2) dp x pp x tp mesh (M == S
    and the M > S FIFO case): gradients == sequential transposition AD
    at 1e-9, packed params genuinely sharded over (stage, model)."""
    from tensor_ops.parallel.ir_pipeline import (
        HeteroTpCircularPipelinedNetwork, partition_network_circular,
        shard_pipelined_params)
    from tensor_ops.parallel.mesh import MODEL_AXIS
    from tensor_ops.parallel.pipeline import (STAGE_AXIS,
                                                  make_3d_pipeline_mesh)

    net = _deep_pyramid(jb, seed=41)
    loss = squared_error(24)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    part = partition_network_circular(net, 2, 2, mesh)
    assert isinstance(part, HeteroTpCircularPipelinedNetwork)
    spnet = shard_pipelined_params(part, mesh)
    spec = tuple(spnet.packed.sharding.spec)
    assert spec[0] == STAGE_AXIS and spec[2] == MODEL_AXIS
    assert not spnet.packed.sharding.is_fully_replicated

    r = np.random.default_rng(42)
    xb = jb.asarray(r.uniform(0, 1, size=(8, 24)))
    yb = jb.asarray(r.uniform(0, 1, size=(8, 24)))
    v_seq, g_seq = _seq_grads(net, loss, jb, np.asarray(xb),
                              np.asarray(yb))
    gfn = ir_pipeline_grads(net, loss, jb, mesh, n_microbatches=M,
                            schedule="circular", n_chunks=2)
    _, pnet = ir_pipeline_train_step(net, loss, jb, mesh, M,
                                     schedule="circular", n_chunks=2)
    assert isinstance(pnet, HeteroTpCircularPipelinedNetwork)
    v_pp, flat_g = gfn(xb, yb, *spnet.flat_params())
    assert abs(float(v_pp) - v_seq) < 1e-9
    for a, b in zip(pnet.unflatten(tuple(flat_g)).to_network_params(),
                    g_seq):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


@multi
def test_hetero_tp_circular_softmax_grads_equal_sequential(jb):
    """Flagship-shaped softmax chain under the interleaved tp schedule:
    the sharded-softmax decomposition (tp-local affine + exp,
    replicated normalization after the gather) == sequential at 1e-9."""
    from tensor_ops.parallel.ir_pipeline import (
        HeteroTpCircularPipelinedNetwork, partition_network_circular,
        shard_pipelined_params)
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    rng = Rng(jb, seed=43)
    net = gen_net(jb, 16, 4, [(8, act_logistic())] * 3, act_softmax(),
                  rng)
    loss = cross_entropy(4)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    part = partition_network_circular(net, 2, 2, mesh)
    assert isinstance(part, HeteroTpCircularPipelinedNetwork)
    spnet = shard_pipelined_params(part, mesh)

    r = np.random.default_rng(44)
    B = 8
    xb = jb.asarray(r.uniform(0, 1, size=(B, 16)))
    yb = jb.asarray(np.eye(4)[r.integers(0, 4, size=B)])
    v_seq, g_seq = _seq_grads(net, loss, jb, np.asarray(xb),
                              np.asarray(yb))
    gfn = ir_pipeline_grads(net, loss, jb, mesh, n_microbatches=4,
                            schedule="circular", n_chunks=2)
    _, pnet = ir_pipeline_train_step(net, loss, jb, mesh, 4,
                                     schedule="circular", n_chunks=2)
    v_pp, flat_g = gfn(xb, yb, *spnet.flat_params())
    assert abs(float(v_pp) - v_seq) < 1e-9
    for a, b in zip(pnet.unflatten(tuple(flat_g)).to_network_params(),
                    g_seq):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


@multi
def test_fit_hetero_tp_circular(jb, tmp_path):
    """fit(pipeline_schedule='circular') on the (2,2,2) mesh with a
    varied-width pyramid: NO idle-model warning (the tp cut engages),
    loss curve == single-device at 1e-9, checkpoint/resume exact."""
    import warnings

    from tensor_ops.models import adam
    from tensor_ops.models.trainer import fit
    from tensor_ops.parallel.pipeline import make_3d_pipeline_mesh

    r = np.random.default_rng(45)
    X = r.uniform(0, 1, size=(64, 24))
    Y = r.uniform(0, 1, size=(64, 24))
    loss = squared_error(24)
    mesh = make_3d_pipeline_mesh(2, 2, 2)
    kw = dict(epochs=2, batch_size=16, lr=0.01, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1,
              pipeline_microbatches=4)

    def net():
        return _deep_pyramid(jb, seed=46)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r_tp = fit(net(), loss, jb, X, Y, mesh=mesh,
                   pipeline_schedule="circular", pipeline_chunks=2, **kw)
    assert not any("model axis" in str(x.message) for x in w)
    r_sd = fit(net(), loss, jb, X, Y, **{
        k: v for k, v in kw.items() if k != "pipeline_microbatches"})
    for ra, rb in zip(r_tp.history, r_sd.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_tp.net.params, r_sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)

    ck = str(tmp_path / "htpc.npz")
    fit(net(), loss, jb, X, Y, mesh=mesh, pipeline_schedule="circular",
        pipeline_chunks=2, epochs=1, checkpoint_path=ck,
        checkpoint_every=2, **{k: v for k, v in kw.items()
                               if k != "epochs"})
    resumed = fit(net(), loss, jb, X, Y, mesh=mesh,
                  pipeline_schedule="circular", pipeline_chunks=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    for a, b in zip(resumed.net.params, r_tp.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


def test_describe_hetero_tp_circular(jb):
    from tensor_ops.parallel.ir_pipeline import (
        describe_partition, split_network_hetero_tp_circular)

    s = describe_partition(
        split_network_hetero_tp_circular(_deep_pyramid(jb), 2, 2, 2))
    assert "heterogeneous circular x tp partition: 2 stages x 2 chunks" in s
    assert "tp=2" in s and "1/2 per shard" in s and "balance:" in s


def test_describe_circular_balance_is_per_device(jb):
    """The balance line aggregates a device's V chunks, not raw chunk
    values: a pyramid whose chunk FLOPs are skewed across slots but
    even across devices must report the PER-DEVICE ratio."""
    from tensor_ops.parallel.ir_pipeline import (
        _op_flops, describe_partition, split_network_hetero_circular)

    p = split_network_hetero_circular(_deep_pyramid(jb), 2, 2)
    per_chunk = [sum(_op_flops(op) for op in ops) for ops in p.chunk_ops]
    dev = [per_chunk[0] + per_chunk[2], per_chunk[1] + per_chunk[3]]
    want = max(dev) / (sum(dev) / 2)
    s = describe_partition(p)
    assert f"max/mean stage FLOPs = {want:.2f}" in s


@multi
def test_circular_pnet_stage_mismatch_rejected(jb):
    """A prebuilt partition for the wrong stage count must error, not
    silently train a different network (shard_map would split the
    packed rows across whatever stages exist)."""
    from tensor_ops.parallel.ir_pipeline import (
        make_ir_pipeline_loss, split_network_hetero,
        split_network_hetero_circular)

    net = _deep_pyramid(jb)
    mesh2 = make_pipeline_mesh(2)
    p4 = split_network_hetero_circular(net, 4, 2)
    with pytest.raises(ValueError, match="built for 4 stages"):
        make_ir_pipeline_loss(net, squared_error(24), jb, mesh2, 4,
                              pnet=p4, schedule="circular", n_chunks=2)
    h4 = split_network_hetero(net, 4)
    with pytest.raises(ValueError, match="built for 4 stages"):
        make_ir_pipeline_loss(net, squared_error(24), jb, mesh2, 2,
                              pnet=h4)
    uc = gen_net(jb, 8, 8, [(8, act_logistic())] * 7, act_logistic(),
                 Rng(jb, seed=1))
    from tensor_ops.parallel.ir_pipeline import split_network_circular

    c4 = split_network_circular(uc, 4, 2)
    with pytest.raises(ValueError, match="built for 4 stages"):
        make_ir_pipeline_loss(uc, squared_error(8), jb, mesh2, 4,
                              pnet=c4, schedule="circular", n_chunks=2)
