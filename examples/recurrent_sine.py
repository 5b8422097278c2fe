#!/usr/bin/env python
"""Recurrent network demo: learn to predict sin(t+dt) from sin(t) with an
Elman-style fully connected recurrent layer trained by scan-based BPTT
(the reference's ``Recurrent.hs`` workflow: fullyConnected + trainNetwork'
with dual state/param learning rates)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, squared_error
from tensor_ops.models.recurrent import gen_net


def main():
    be = T.JaxBackend()
    rng = Rng(be, seed=0)
    net = gen_net(
        be, 1, 1,
        [(8, act_logistic(), act_logistic())],  # recurrent hidden layer
        act_logistic(), None, rng,
    )

    t = np.linspace(0, 4 * np.pi, 81)
    xs = be.asarray((0.5 + 0.5 * np.sin(t[:-1])).reshape(-1, 1))
    tg = be.asarray((0.5 + 0.5 * np.sin(t[1:])).reshape(-1, 1))
    loss = squared_error(1)

    l0 = float(np.asarray(net.seq_loss(loss, be, xs, tg)))
    for step in range(300):
        net = net.train(loss, 0.01, 0.05, be, xs, tg)
        if step % 100 == 99:
            l = float(np.asarray(net.seq_loss(loss, be, xs, tg)))
            print(f"step {step + 1}: sequence loss {l:.4f}")
    l1 = float(np.asarray(net.seq_loss(loss, be, xs, tg)))
    print(f"loss {l0:.4f} -> {l1:.4f}")

    # roll the trained net forward step by step (runNetwork threading state)
    m = net
    preds = []
    for i in range(20):
        y, m = m.run(be, xs[i])
        preds.append(float(np.asarray(y)[0]))
    print("first 10 predictions:", [round(p, 2) for p in preds[:10]])
    print("first 10 targets:    ",
          [round(float(v), 2) for v in np.asarray(tg)[:10, 0]])


if __name__ == "__main__":
    main()
