"""Autoencoder tests (``AutoEncoder.hs`` semantics)."""

import numpy as np

from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, gen_net, squared_error
from tensor_ops.models.autoencoder import Encoder


def make_enc(be, seed=5):
    rng = Rng(be, seed=seed)
    e = gen_net(be, 6, 2, [], act_logistic(), rng)
    d = gen_net(be, 2, 6, [], act_logistic(), rng)
    return Encoder(e, d)


def test_encode_decode_shapes(nb):
    enc = make_enc(nb)
    x = np.random.default_rng(0).uniform(0.1, 0.9, size=6)
    z = enc.encode(nb, x)
    assert np.asarray(z).shape == (2,)
    xr = enc.decode(nb, z)
    assert np.asarray(xr).shape == (6,)
    np.testing.assert_allclose(
        np.asarray(enc.encode_decode(nb, x)), np.asarray(xr), atol=1e-12
    )


def test_grad_matches_finite_differences(nb):
    enc = make_enc(nb)
    loss = squared_error(6)
    x = np.random.default_rng(1).uniform(0.1, 0.9, size=6)
    gE, gD = enc.grad(loss, nb, x)
    eps = 1e-6
    # check a few encoder-weight entries
    for idx in [(0, 0), (1, 3)]:
        for k, grads in ((0, gE),):
            pp = [p.copy() for p in enc.encoder.params]
            pm = [p.copy() for p in enc.encoder.params]
            pp[k][idx] += eps
            pm[k][idx] -= eps
            from tensor_ops.models.feedforward import Network

            ep = Encoder(Network(enc.encoder.op, tuple(pp)), enc.decoder)
            em = Encoder(Network(enc.encoder.op, tuple(pm)), enc.decoder)
            fd = (ep.test_loss(loss, nb, x) - em.test_loss(loss, nb, x)) / (2 * eps)
            assert abs(fd - grads[k][idx]) < 1e-5
    # decoder bias entry
    pp = [p.copy() for p in enc.decoder.params]
    pm = [p.copy() for p in enc.decoder.params]
    pp[1][2] += eps
    pm[1][2] -= eps
    from tensor_ops.models.feedforward import Network

    ep = Encoder(enc.encoder, Network(enc.decoder.op, tuple(pp)))
    em = Encoder(enc.encoder, Network(enc.decoder.op, tuple(pm)))
    fd = (ep.test_loss(loss, nb, x) - em.test_loss(loss, nb, x)) / (2 * eps)
    assert abs(fd - gD[1][2]) < 1e-5


def test_training_reduces_reconstruction_loss(nb):
    enc = make_enc(nb, seed=7)
    loss = squared_error(6)
    rng = np.random.default_rng(2)
    # data on a 2D manifold in 6D
    zs = rng.uniform(0.2, 0.8, size=(30, 2))
    proj = rng.normal(size=(2, 6))
    data = 1 / (1 + np.exp(-(zs @ proj)))
    l0 = float(np.mean([enc.test_loss(loss, nb, x) for x in data]))
    e = enc
    for _ in range(30):
        for x in data:
            e = e.train(loss, 0.5, nb, x)
    l1 = float(np.mean([e.test_loss(loss, nb, x) for x in data]))
    assert l1 < 0.5 * l0, (l0, l1)


def test_parity_numpy_jax(nb, jb):
    from tensor_ops.models.feedforward import Network

    enc = make_enc(nb, seed=9)
    jenc = Encoder(
        Network(enc.encoder.op, tuple(jb.asarray(p) for p in enc.encoder.params)),
        Network(enc.decoder.op, tuple(jb.asarray(p) for p in enc.decoder.params)),
    )
    loss = squared_error(6)
    x = np.random.default_rng(3).uniform(0.1, 0.9, size=6)
    a = enc.test_loss(loss, nb, x)
    b = jenc.test_loss(loss, jb, jb.asarray(x))
    assert abs(a - b) < 1e-9
    gE1, gD1 = enc.grad(loss, nb, x)
    gE2, gD2 = jenc.grad(loss, jb, jb.asarray(x))
    for p, q in zip(gE1 + gD1, gE2 + gD2):
        np.testing.assert_allclose(np.asarray(p), np.asarray(q), atol=1e-9)


def test_fused_autoencoder_matches_ir_single_sample(jb):
    """FusedAutoencoder (jax.grad of the plain chain, squared error)
    == the staged-IR Encoder.train joint step at batch 1."""
    import jax.numpy as jnp

    from tensor_ops.models import squared_error
    from tensor_ops.models.fast import FusedAutoencoder

    enc = make_enc(jb)
    loss = squared_error(6)
    x = np.random.default_rng(2).uniform(0.1, 0.9, size=6)

    fae = FusedAutoencoder.from_encoder(enc, precision="highest")
    l0 = enc.test_loss(loss, jb, jb.asarray(x))
    lf, fae2 = fae.train(0.5, jnp.asarray(x, jnp.float32)[None])
    assert np.isclose(lf, l0, atol=1e-5)

    enc2 = enc.train(loss, 0.5, jb, jb.asarray(x))
    enc2f = fae2.to_encoder(enc)
    for a, b in zip(enc2f.encoder.params + enc2f.decoder.params,
                    enc2.encoder.params + enc2.decoder.params):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=1e-5, atol=1e-5)


def test_fused_autoencoder_batch_training_converges(jb):
    """Batched fused AE training drives reconstruction loss down."""
    import jax.numpy as jnp

    from tensor_ops.models.fast import FusedAutoencoder

    enc = make_enc(jb, seed=9)
    fae = FusedAutoencoder.from_encoder(enc)
    r = np.random.default_rng(3)
    # two clusters in [0,1]^6 — compressible through the 2-d bottleneck
    protos = r.uniform(0.2, 0.8, size=(2, 6))
    X = jnp.asarray(
        np.clip(protos[r.integers(0, 2, size=64)]
                + r.normal(0, 0.03, size=(64, 6)), 0, 1), jnp.float32)
    l0, fae = fae.train(1.0, X)
    for _ in range(300):
        l1, fae = fae.train(1.0, X)
    assert l1 < l0 * 0.5, (l0, l1)
    xr = fae.encode_decode(X)
    assert np.asarray(xr).shape == (64, 6)


def test_encoder_fit_production_loop(jb):
    """Encoder.fit: reconstruction training through the full fit surface
    equals the objective of per-sample trainEncoder (loss falls; params
    split back into encoder/decoder correctly)."""
    import numpy as np

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import (Encoder, act_logistic, gen_net,
                                       squared_error)
    from tensor_ops.models.optim import adam

    rng = Rng(jb, seed=0)
    enc = gen_net(jb, 8, 3, [(12, act_logistic())], act_logistic(), rng)
    dec = gen_net(jb, 3, 8, [(12, act_logistic())], act_logistic(), rng)
    ae = Encoder(enc, dec)
    loss = squared_error(8)

    r = np.random.default_rng(1)
    X = r.uniform(0, 1, size=(256, 8))
    l0 = float(np.mean([ae.test_loss(loss, jb, jb.asarray(x))
                        for x in X[:16]]))
    ae2, res = ae.fit(loss, jb, X, epochs=12, batch_size=32, lr=0.01,
                      optimizer=adam(), verbose=False)
    l1 = float(np.mean([ae2.test_loss(loss, jb, jb.asarray(x))
                        for x in X[:16]]))
    assert l1 < l0 * 0.8, (l0, l1)
    assert len(ae2.encoder.params) == len(enc.params)
    assert ae2.decoder.params[0].shape == dec.params[0].shape
    # encoding still produces the bottleneck shape
    z = ae2.encode(jb, jb.asarray(X[0]))
    assert np.asarray(z).shape == (3,)


def test_encoder_fit_preserves_act_names(jb):
    """Regression (review): the trained encoder/decoder keep their
    activation metadata, so FusedMLP.from_network still works on the
    trained artifact; then() concatenates act_names."""
    import numpy as np

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import (Encoder, act_logistic, gen_net,
                                       squared_error)
    from tensor_ops.models.fast import FusedMLP

    rng = Rng(jb, seed=0)
    enc = gen_net(jb, 6, 2, [(8, act_logistic())], act_logistic(), rng)
    dec = gen_net(jb, 2, 6, [(8, act_logistic())], act_logistic(), rng)
    ae = Encoder(enc, dec)
    assert ae.encoder_net().act_names == enc.act_names + dec.act_names

    X = np.random.default_rng(1).uniform(0, 1, size=(64, 6))
    ae2, res = ae.fit(squared_error(6), jb, X, epochs=1, batch_size=32,
                      lr=0.01, verbose=False)
    assert ae2.encoder.act_names == enc.act_names
    assert ae2.decoder.act_names == dec.act_names
    FusedMLP.from_network(ae2.encoder)       # must not raise
    FusedMLP.from_network(res.net)           # the joint net too


def test_graph_altering_composition_drops_metadata(jb):
    """Regression (review): pre_op/post_op invalidate act_names/arch —
    FusedMLP.from_network and the checkpoint->serve rebuild encode only
    the layer stack, so stale metadata would silently drop the composed
    op.  Encoder.train (per-sample path) preserves metadata like fit."""
    import pytest

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import (Encoder, act_logistic, gen_net,
                                       squared_error)
    from tensor_ops.models.fast import FusedMLP
    from tensor_ops.ops import prim as P

    rng = Rng(jb, seed=0)
    net = gen_net(jb, 4, 2, [(6, act_logistic())], act_logistic(), rng)
    assert net.act_names is not None
    doubled = net.post_op(P.scale((2,), 2.0))
    assert doubled.act_names is None
    with pytest.raises(ValueError, match="act"):
        FusedMLP.from_network(doubled)

    from tensor_ops.models.recurrent import gen_net as gen_rnet

    rnet = gen_rnet(jb, 2, 1, [(4, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(jb, seed=1))
    assert rnet.arch is not None
    assert rnet.nmap(lambda x: x * 2).arch is None

    enc = gen_net(jb, 4, 2, [(6, act_logistic())], act_logistic(), rng)
    dec = gen_net(jb, 2, 4, [(6, act_logistic())], act_logistic(), rng)
    ae2 = Encoder(enc, dec).train(squared_error(4), 0.01, jb,
                                  jb.asarray([0.1, 0.2, 0.3, 0.4]))
    assert ae2.encoder.act_names == enc.act_names
    FusedMLP.from_network(ae2.encoder)
