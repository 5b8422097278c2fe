#!/usr/bin/env python
"""On-card smoke test of the main path, on one NVIDIA GPU.

    python chip_smoke.py           # phases 1-6 on one card
    python chip_smoke.py --four    # only the four-card mesh path (phase 7)

Every phase drives the library through the entry points a user calls
(``fit``, ``fit_sequences``, ``Predictor`` over ``FusedMLP`` and
``QuantizedMLP``) on seeded synthetic data made here, prints what ran, at
which shapes, and each comparison beside its bound, and raises on the
first miss.  The NumPy float64 backend (``NumpyBackend``) is the oracle.

Phase 6 (the tests marked ``gpu``) runs first, in a child process, before
this process opens the card: one process holds the card at a time.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed.  With no GPU the script exits non-zero
before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: Set for the phase-6 child: tests/conftest.py then leaves JAX on the
#: GPU instead of forcing the CPU.
TEST_GPU_ENV = "TENSOR_OPS_TEST_GPU"

FLAGSHIP = (784, 300, 100, 10)      # bench.py make_net, MNIST.hs:89-104
STACK = (4096, 4)                   # int8 serving: 4 x 4096^2 ReLU layers
ELMAN = (32, 512, 32, 64)           # in, hidden, out, timesteps

#: One float32 step against the float64 oracle at precision "highest".
ORACLE_RTOL = 1e-4
#: The same for one sequence step of the Elman net: 64 steps of float32
#: BPTT through a 512-wide recurrence round off more (4.9e-4 on the CPU
#: in float32, same data), so the bound is float32 round-off, not 1e-4.
SEQ_ORACLE_RTOL = 1e-3
#: The same at the default precision: on the H100 XLA runs float32
#: matmuls in TF32 (10-bit mantissa), about 1e-3 per product.
TF32_RTOL = 2e-2
#: Predictor outputs (probabilities) against the oracle forward.
SERVE_ATOL = {"f32": 2e-2, "bf16": 5e-2}
#: int8 against the float32 model: the bound of the repo's int8 tests.
INT8_ATOL = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


def card_info() -> str:
    """The card's name and power limit, read by a child that never
    imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeFailure(f"nvidia-smi found no GPU: {e}") from None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(bool(lines), "nvidia-smi listed no GPU")
    return "; ".join(lines)


# -- phase 6: the on-card tests ---------------------------------------------


def run_gpu_tests() -> str:
    """Run the tests marked ``gpu`` in a child with the card to itself."""
    env = dict(os.environ, **{TEST_GPU_ENV: "1"})
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-rs"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    check(proc.returncode == 0,
          f"gpu tests failed (rc {proc.returncode}):\n{proc.stdout[-4000:]}"
          f"\n{proc.stderr[-2000:]}")
    check("passed" in tail and "skipped" not in tail,
          f"gpu tests did not all run: {tail!r}")
    return tail


# -- synthetic data -----------------------------------------------------------


def teacher_data(n: int, dims, seed: int):
    """Uniform inputs labelled by a random linear teacher, so a few
    hundred steps visibly lower the loss."""
    r = np.random.default_rng(seed)
    X = r.uniform(0, 1, size=(n, dims[0]))
    W = r.normal(size=(dims[0], dims[-1]))
    labels = np.argmax((X - 0.5) @ W, axis=1)
    return X, np.eye(dims[-1])[labels]


def flagship_net(be, dims=FLAGSHIP, seed: int = 0):
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net

    hidden = [(h, act_logistic()) for h in dims[1:-1]]
    return gen_net(be, dims[0], dims[-1], hidden, act_softmax(),
                   Rng(be, seed=seed))


# -- phase 1 ------------------------------------------------------------------


def phase_device(jax) -> dict:
    d = jax.devices()[0]
    check(d.platform == "gpu",
          f"JAX found no GPU: first device is {d} (platform {d.platform!r})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


# -- phase 2 ------------------------------------------------------------------


def _mlp_step_vs_oracle(net, loss, X, Y, precision: str):
    """(loss error, largest gradient error) of one minibatch step of the
    JAX backend at ``precision`` against the float64 oracle."""
    import jax
    import jax.numpy as jnp

    import tensor_ops as T
    from tensor_ops.models import Network
    from tensor_ops.models.training import make_vmapped_grads

    params = [np.asarray(p, np.float64) for p in net.params]
    be = T.JaxBackend(precision=precision)
    netj = Network(net.op, [be.asarray(p) for p in params], net.act_names)
    vals, grads = jax.jit(make_vmapped_grads(netj, loss, be))(
        be.asarray(X), be.asarray(Y), *netj.params)
    jl = float(jnp.mean(vals))
    jg = [np.asarray(jnp.mean(g, axis=0)) for g in grads]

    nb = T.NumpyBackend()
    netn = Network(net.op, params, net.act_names)
    nl = float(np.mean([netn.loss_value(loss, nb, x, y)
                        for x, y in zip(X, Y)]))
    ng = [np.zeros_like(p) for p in params]
    for x, y in zip(X, Y):
        for acc, g in zip(ng, netn.network_gradient(loss, nb, x, y)):
            acc += np.asarray(g) / len(X)
    return (abs(jl - nl) / abs(nl),
            max(rel_err(a, b) for a, b in zip(jg, ng)))


def phase_train_mlp(dims=FLAGSHIP, n_rows: int = 32768, batch: int = 1024,
                    epochs: int = 10, n_check: int = 128):
    """fit() on the flagship with adam; one step against the oracle."""
    import jax

    import tensor_ops as T
    from tensor_ops.models import adam, cross_entropy, fit
    from tensor_ops.models.trainer import make_opt_step

    ph = "2 train mlp"
    be = T.JaxBackend()
    loss = cross_entropy(dims[-1])
    X, Y = teacher_data(n_rows, dims, seed=1)

    net0 = flagship_net(be, dims)
    for prec, bound in (("highest", ORACLE_RTOL), ("default", TF32_RTOL)):
        le, ge = _mlp_step_vs_oracle(net0, loss, X[:n_check], Y[:n_check],
                                     prec)
        say(ph, f"one step vs f64 oracle, precision={prec}, batch "
                f"{n_check}: loss rel err {le:.3e}, grad rel err {ge:.3e} "
                f"(bound {bound:g})")
        check(le <= bound and ge <= bound,
              f"{ph}: precision={prec} step off the oracle "
              f"({le:.3e}, {ge:.3e} > {bound:g})")

    opt = adam()
    step = make_opt_step(net0, loss, be, opt)
    xb, yb = be.asarray(X[:batch]), be.asarray(Y[:batch])
    compiled = step.lower(1e-3, xb, yb, opt.init(net0.params),
                          net0.params).compile()
    say(ph, f"step memory_analysis: {compiled.memory_analysis()}")

    t0 = time.perf_counter()
    res = fit(flagship_net(be, dims), loss, be, X, Y, epochs=epochs,
              batch_size=batch, lr=1e-3, optimizer=adam(),
              log_every=max(1, n_rows // batch), verbose=False)
    jax.block_until_ready(res.net.params)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in res.history]
    say(ph, f"fit {dims} batch {batch}, {res.steps} steps, adam, "
            f"chain_shuffle=host: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({wall:.2f} s wall, compile included)")
    check(all(np.isfinite(losses)), f"{ph}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{ph}: loss did not fall {losses}")
    return res.net


# -- phase 3 ------------------------------------------------------------------


def _seq_step_vs_oracle(rnet, loss, XS, TS, precision: str):
    import tensor_ops as T
    from tensor_ops.models import RecurrentNetwork

    states = [np.asarray(s, np.float64) for s in rnet.states]
    params = [np.asarray(p, np.float64) for p in rnet.params]
    be = T.JaxBackend(precision=precision)
    rj = RecurrentNetwork(rnet.op, [be.asarray(s) for s in states],
                          [be.asarray(p) for p in params], rnet.arch)
    nb = T.NumpyBackend()
    rn = RecurrentNetwork(rnet.op, states, params, rnet.arch)
    le = ge = 0.0
    for xs, ts in zip(XS, TS):
        lj = float(rj.seq_loss(loss, be, be.asarray(xs), be.asarray(ts)))
        ln = float(rn.seq_loss(loss, nb, xs, ts))
        le = max(le, abs(lj - ln) / abs(ln))
        _, gsj, gpj = rj.seq_grad(loss, be, be.asarray(xs), be.asarray(ts))
        _, gsn, gpn = rn.seq_grad(loss, nb, xs, ts)
        ge = max([ge] + [rel_err(a, b) for a, b in
                         zip(gsj + gpj, gsn + gpn)])
    return le, ge


def phase_train_rnn(shape=ELMAN, n_seqs: int = 1024, batch: int = 256,
                    epochs: int = 2, n_check: int = 2,
                    rates=(0.0005, 0.001)):
    """fit_sequences() on the Elman 32->512->32 net with dual-rate SGD
    (``rates`` = state, param; the loss is summed over 64 steps and 32
    outputs, so the defaults 0.01/0.05 overshoot); one step against the
    oracle."""
    import tensor_ops as T
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    ph = "3 train rnn"
    i, h, o, n = shape
    be = T.JaxBackend()
    loss = squared_error(o)
    r = np.random.default_rng(2)
    XS = r.normal(size=(n_seqs, n, i)) * 0.5
    # target: the input one step earlier, squashed into (0, 1)
    TS = 1.0 / (1.0 + np.exp(-np.roll(XS, 1, axis=1)[..., :o]))

    def net():
        return gen_rnet(be, i, o, [(h, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(be, seed=3))

    for prec, bound in (("highest", SEQ_ORACLE_RTOL), ("default", TF32_RTOL)):
        le, ge = _seq_step_vs_oracle(net(), loss, XS[:n_check],
                                     TS[:n_check], prec)
        say(ph, f"sequence loss+grad vs f64 oracle, precision={prec}, "
                f"{n_check} sequences of {n}: loss rel err {le:.3e}, grad "
                f"rel err {ge:.3e} (bound {bound:g})")
        check(le <= bound and ge <= bound,
              f"{ph}: precision={prec} off the oracle ({le:.3e}, {ge:.3e})")

    t0 = time.perf_counter()
    res = fit_sequences(net(), loss, be, XS, TS, epochs=epochs,
                        batch_size=batch, rate_state=rates[0],
                        rate_param=rates[1], log_every=1, verbose=False)
    wall = time.perf_counter() - t0
    losses = [rec["loss"] for rec in res.history]
    say(ph, f"fit_sequences Elman {i}->{h}->{o}, n={n}, batch {batch}: "
            f"{res.steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({wall:.2f} s wall, compile included)")
    check(all(np.isfinite(losses)), f"{ph}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{ph}: loss did not fall {losses}")


# -- phase 4 ------------------------------------------------------------------


def phase_serve_f32(net, sizes=(1, 5, 8, 32, 100, 512)):
    """Predictor(FusedMLP) answers requests of several sizes; f32 and bf16
    storage against the oracle forward."""
    import tensor_ops as T
    from tensor_ops.models import Network, Predictor
    from tensor_ops.models.fast import FusedMLP
    from tensor_ops.models.training import batched_run

    ph = "4 serve f32"
    nb = T.NumpyBackend()
    netn = Network(net.op, [np.asarray(p, np.float64) for p in net.params],
                   net.act_names)
    oracle = batched_run(netn, nb)
    fm = FusedMLP.from_network(net)
    r = np.random.default_rng(4)
    for dtype in ("f32", "bf16"):
        pred = Predictor(fm, dtype=None if dtype == "f32" else dtype)
        pred.warmup()
        worst = 0.0
        for n in sizes:
            x = r.uniform(0, 1, size=(n, net.in_shape[0]))
            got = pred.predict(x)
            check(got.shape == (n, net.out_shape[0]),
                  f"{ph}: shape {got.shape} for a request of {n}")
            worst = max(worst, float(np.max(np.abs(
                got - oracle(x, *netn.params)))))
        say(ph, f"Predictor(FusedMLP {dtype}) requests {list(sizes)}: max "
                f"|p - oracle| {worst:.3e} (bound {SERVE_ATOL[dtype]:g}); "
                f"latency {pred.latency()}")
        check(worst <= SERVE_ATOL[dtype], f"{ph}: {dtype} off the oracle")


# -- phase 5 ------------------------------------------------------------------


def _time_predict(pred, x, n: int) -> float:
    """Median microseconds of ``Predictor.predict`` (which returns a host
    array, so each call ends when the device result has arrived)."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        pred.predict(x)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def phase_serve_int8(flagship, stack=STACK, buckets=(1, 16, 128, 512),
                     reps: int = 50, card: str = ""):
    """Predictor(QuantizedMLP w8a8) on the uniform ReLU stack and the
    flagship against their float32 models; Predictor.predict times of
    both in turns."""
    import jax.numpy as jnp

    from tensor_ops.models import Predictor
    from tensor_ops.models.fast import FusedMLP, QuantizedMLP

    ph = "5 serve int8"
    N, L = stack
    r = np.random.default_rng(5)
    ws = [jnp.asarray(r.normal(size=(N, N)) * (2.0 / N) ** 0.5, jnp.float32)
          for _ in range(L)]
    bs = [jnp.asarray(r.normal(size=N) * 0.01, jnp.float32) for _ in range(L)]
    models = {
        "stack": FusedMLP(ws, bs, ("relu",) * (L - 1) + ("identity",),
                          softmax_out=False),
        "flagship": FusedMLP.from_network(flagship),
    }
    for name, fm in models.items():
        p32 = Predictor(fm, buckets=buckets)
        p8 = Predictor(QuantizedMLP.from_fused(fm), buckets=buckets)
        p32.warmup()
        p8.warmup()
        width = fm.weights[0].shape[1]
        rows = 16 if name == "stack" else 512
        x = r.normal(size=(rows, width)) if name == "stack" else \
            r.uniform(0, 1, size=(rows, width))
        y32, y8 = p32.predict(x), p8.predict(x)
        if fm.softmax_out:
            err, bound = float(np.max(np.abs(y8 - y32))), INT8_ATOL
            what = "max |p8 - p32|"
        else:
            err, bound = rel_err(y8, y32), INT8_ATOL
            what = "max |y8 - y32| / max |y32|"
        say(ph, f"{name} {[w.shape for w in fm.weights]} w8a8 batch {rows}: "
                f"{what} {err:.3e} (bound {bound:g})")
        check(np.isfinite(y8).all() and err <= bound,
              f"{ph}: {name} int8 off the f32 model ({err:.3e})")
        if name != "stack":
            continue
        for b in buckets:
            xb = r.normal(size=(b, width))
            t = {"f32": [], "w8a8": []}
            for arm in ("f32", "w8a8", "w8a8", "f32"):
                t[arm].append(_time_predict(p32 if arm == "f32" else p8,
                                            xb, reps))
            say(ph, f"Predictor.predict {name} batch {b}: median us "
                    f"f32 {t['f32']} w8a8 {t['w8a8']} ({card})")


# -- phase 7 ------------------------------------------------------------------


def phase_four(dims=FLAGSHIP, pipe_dims=(784, 300, 100, 100, 10),
               n_rows: int = 4096, batch: int = 256, epochs: int = 1,
               atol: float = 1e-5):
    """fit() on a (2, 2) data x model mesh with ZeRO-2, and on a 4-stage
    pipeline, each against the one-card fit on the same seed and data.
    A 4-stage cut needs four composition segments; the flagship has
    three, so the pipeline runs it with one more 100-wide layer
    (``pipe_dims``).  The runs are float64: adam divides each gradient
    by its own running magnitude, so in float32 the round-off of a
    different reduction order becomes whole steps on near-zero gradients
    (1.1e-4 apart after 16 steps on four CPU devices)."""
    import jax
    import jax.numpy as jnp

    import tensor_ops as T
    from tensor_ops.models import adam, cross_entropy, fit
    from tensor_ops.parallel.mesh import make_mesh, shard_network
    from tensor_ops.parallel.pipeline import make_pipeline_mesh

    ph = "7 four cards"
    check(len(jax.devices()) >= 4, f"{ph}: {len(jax.devices())} devices")
    jax.config.update("jax_enable_x64", True)
    be = T.JaxBackend(dtype=jnp.float64)
    loss = cross_entropy(dims[-1])
    X, Y = teacher_data(n_rows, dims, seed=6)
    kw = dict(epochs=epochs, batch_size=batch, lr=1e-3, log_every=1,
              verbose=False, seed=0)

    mesh = make_mesh(4, shape=(2, 2))
    placed = shard_network(flagship_net(be, dims), mesh)
    used = {s.device for p in placed.params for s in p.addressable_shards}
    say(ph, f"mesh {dict(mesh.shape)} over {sorted(d.id for d in used)}")
    check(len(used) == 4, f"{ph}: params sit on {len(used)} devices")

    def run(d, **extra):
        t0 = time.perf_counter()
        res = fit(flagship_net(be, d), loss, be, X, Y,
                  optimizer=adam(), **kw, **extra)
        jax.block_until_ready(res.net.params)
        return res, time.perf_counter() - t0

    for name, d, extra in (
            ("dp x tp (2, 2), zero_stage=2", dims,
             dict(mesh=mesh, zero_stage=2)),
            ("pipeline, 4 stages", pipe_dims,
             dict(mesh=make_pipeline_mesh(4), pipeline_microbatches=4))):
        one, t_one = run(d)
        res, t = run(d, **extra)
        dl = max(abs(a["loss"] - b["loss"])
                 for a, b in zip(res.history, one.history))
        dp = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                 for a, b in zip(res.net.params, one.net.params))
        say(ph, f"fit {d} {name}: {res.steps} steps, loss "
                f"{res.history[-1]['loss']:.6f}; vs one card: max |dloss| "
                f"{dl:.3e}, max |dparam| {dp:.3e} (bound {atol:g}); "
                f"{t:.2f} s vs {t_one:.2f} s wall, compile included")
        check(res.steps == one.steps and dl <= atol and dp <= atol,
              f"{ph}: {name} diverged from one card ({dl:.3e}, {dp:.3e})")


# -- main ---------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)
    try:
        card = card_info()
        if not args.four:
            say("6 gpu tests", run_gpu_tests())
        import jax

        from tensor_ops.utils.compile_cache import use_compile_cache

        cache = use_compile_cache()
        device = phase_device(jax)
        say("1 device", f"{device['kind']} x{device['count']}, jax "
                        f"{jax.__version__}, compile cache {cache}; {card}")
        if args.four:
            check(device["count"] >= 4, "--four needs four cards")
            phase_four()
        else:
            net = phase_train_mlp()
            phase_train_rnn()
            phase_serve_f32(net)
            phase_serve_int8(net, card=card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
