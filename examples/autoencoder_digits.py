#!/usr/bin/env python
"""Autoencoder demo: compress (pseudo-)MNIST digits through a small
bottleneck and report reconstruction loss — the reference's
``AutoEncoder.hs`` workflow (trainEncoder on squared error)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, gen_net, squared_error
from tensor_ops.models.autoencoder import Encoder
from tensor_ops.utils.mnist_data import load_mnist


def main():
    be = T.JaxBackend()
    rng = Rng(be, seed=0)
    enc = Encoder(
        gen_net(be, 784, 32, [(128, act_logistic())], act_logistic(), rng),
        gen_net(be, 32, 784, [(128, act_logistic())], act_logistic(), rng),
    )
    loss = squared_error(784)

    train, _ = load_mnist("data/mnist")
    xs = [be.asarray(d / 255.0) for _, d in train[:200]]

    l0 = float(np.mean([enc.test_loss(loss, be, x) for x in xs[:20]]))
    print(f"initial reconstruction loss: {l0:.3f}")
    for epoch in range(3):
        for x in xs:
            enc = enc.train(loss, 0.05, be, x)
        l = float(np.mean([enc.test_loss(loss, be, x) for x in xs[:20]]))
        print(f"epoch {epoch + 1}: reconstruction loss {l:.3f}")
    assert l < l0


if __name__ == "__main__":
    main()
