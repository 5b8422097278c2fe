"""App-level smoke tests: the dots and MNIST CLIs end-to-end on tiny
workloads (the reference's implicit integration oracle — SURVEY.md §4)."""

import io
import sys
import contextlib

import numpy as np
import pytest

import apps.dots as dots
import apps.mnist as mnist
from tensor_ops.utils.idx import decode_idx, encode_idx, labeled_data
from tensor_ops.utils.mnist_data import load_mnist


def run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_idx_roundtrip():
    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    assert np.array_equal(decode_idx(encode_idx(arr)), arr)
    lbl = np.array([3, 1], dtype=np.uint8)
    pairs = labeled_data(lbl, arr)
    assert pairs[0][0] == 3 and pairs[0][1].shape == (12,)


def test_idx_rejects_garbage():
    with pytest.raises(ValueError):
        decode_idx(b"\x01\x00\x08\x01")
    with pytest.raises(ValueError):
        decode_idx(b"\x00\x00\x08\x01" + b"\x00\x00\x00\x05" + b"ab")  # short body


def test_mnist_loader_synthetic(tmp_path):
    tr, te = load_mnist(str(tmp_path))
    assert len(tr) > 0 and len(te) > 0
    l, px = tr[0]
    assert 0 <= l <= 9 and px.shape == (784,)
    # deterministic across loads
    tr2, _ = load_mnist(str(tmp_path))
    assert tr[0][0] == tr2[0][0] and np.array_equal(tr[0][1], tr2[0][1])


def test_dots_cli_smoke():
    out = run_cli(dots.main, ["-s", "500", "--seed", "1", "np"])
    assert "rate: 1.0" in out
    assert "Network trained" in out
    # 21 lines of 51-char ASCII raster at the end
    lines = out.strip("\n").split("\n")[-21:]
    assert all(len(l) == 51 for l in lines)


def test_dots_cli_rejects_unknown_backend():
    with pytest.raises(SystemExit):
        run_cli(dots.main, ["zz"])


def test_dots_minibatch_path():
    out = run_cli(dots.main, ["-s", "300", "--minibatch", "50", "--seed", "1", "jax"])
    assert "Network trained" in out


def test_mnist_cli_one_batch(tmp_path):
    out = run_cli(
        mnist.main,
        ["--epochs", "1", "--limit", "300", "-b", "300", "--minibatch", "50",
         "-r", "0.2", "-d", str(tmp_path), "--backend", "jax"],
    )
    assert "Training:" in out and "Validation:" in out
    assert "[ 0]" in out  # confusion matrix rendered


def test_mnist_cli_white_and_noconfusion(tmp_path):
    out = run_cli(
        mnist.main,
        ["--epochs", "1", "--limit", "200", "-b", "220", "--minibatch", "50",
         "-r", "0.2", "-d", str(tmp_path), "-w", "-c"],
    )
    assert "white noise class enabled" in out
    assert "[ 0]" not in out  # confusion disabled


def test_mnist_cli_induce_out_of_range(tmp_path):
    with pytest.raises(SystemExit):
        run_cli(mnist.main, ["-i", "11", "-d", str(tmp_path)])


def test_training_error_decreases(tmp_path):
    out = run_cli(
        mnist.main,
        ["--epochs", "1", "--limit", "2000", "-b", "1000", "--minibatch", "100",
         "-r", "0.2", "-d", str(tmp_path), "-c"],
    )
    errs = [float(l.split()[1].rstrip("%")) for l in out.splitlines()
            if l.startswith("Training:")]
    assert len(errs) >= 2 and errs[-1] < errs[0]


def test_dots_cross_backend_consistency():
    """Same --seed on np and jax backends trains the same network on the
    same data — the rasters must agree (the reference's implicit
    cross-backend oracle, Dots.hs:139-146)."""
    out = run_cli(dots.main, ["-s", "400", "--seed", "7", "np", "jax"])
    # two rasters of 21 lines each at the end of each backend section
    lines = out.splitlines()
    starts = [i for i, l in enumerate(lines) if l.startswith("Training ")]
    assert len(starts) == 2
    r1 = [l for l in lines[starts[0]:starts[1]] if len(l) == 51]
    r2 = [l for l in lines[starts[1]:] if len(l) == 51]
    assert len(r1) == 21 and len(r2) == 21
    same = sum(a == b for a, b in zip(r1, r2))
    assert same >= 20, f"only {same}/21 raster rows agree"


def test_mnist_loader_accepts_local_gz(tmp_path):
    """Real-data path for airgapped hosts: drop the .gz files in the data
    dir and the loader decompresses and caches them."""
    import gzip

    from tensor_ops.utils.idx import encode_idx
    from tensor_ops.utils.mnist_data import MNIST_FILES

    rng = np.random.default_rng(0)
    for img_name, lbl_name in MNIST_FILES:
        n = 20
        imgs = rng.integers(0, 255, size=(n, 28, 28)).astype(np.uint8)
        lbls = rng.integers(0, 10, size=n).astype(np.uint8)
        for name, arr in ((img_name, imgs), (lbl_name, lbls)):
            with open(tmp_path / (name + ".gz"), "wb") as f:
                f.write(gzip.compress(encode_idx(arr)))
    tr, te = load_mnist(str(tmp_path), allow_synthetic=False)
    assert len(tr) == 20 and len(te) == 20
    assert tr[0][1].shape == (784,)


def _write_fake_gz_set(tmp_path, n=20):
    import gzip

    from tensor_ops.utils.idx import encode_idx
    from tensor_ops.utils.mnist_data import MNIST_FILES

    rng = np.random.default_rng(0)
    for img_name, lbl_name in MNIST_FILES:
        imgs = rng.integers(0, 255, size=(n, 28, 28)).astype(np.uint8)
        lbls = rng.integers(0, 10, size=n).astype(np.uint8)
        for name, arr in ((img_name, imgs), (lbl_name, lbls)):
            with open(tmp_path / (name + ".gz"), "wb") as f:
                f.write(gzip.compress(encode_idx(arr)))


def test_require_real_data_rejects_wrong_checksums(tmp_path):
    """--require-real-data: .gz files whose md5 is not the canonical
    distribution's are refused with every failure named
    (VERDICT item 7; reference loader ``MNIST.hs:159-192``)."""
    from tensor_ops.utils.mnist_data import RealDataError

    _write_fake_gz_set(tmp_path)
    with pytest.raises(RealDataError, match="md5"):
        load_mnist(str(tmp_path), require_real=True)


def test_require_real_data_rejects_missing_and_synthetic(tmp_path):
    """An empty dir (zero egress) and the synthetic fallback's 6000/1000
    shape signature both fail the gate."""
    from tensor_ops.utils.mnist_data import RealDataError

    with pytest.raises(RealDataError):
        load_mnist(str(tmp_path / "empty"), require_real=True)
    # produce the synthetic cache via the normal fallback, decompressed
    # into raw IDX names — still refused (shape signature mismatch)
    from tensor_ops.utils.idx import encode_idx
    from tensor_ops.utils.mnist_data import MNIST_FILES, _synthesize

    (trl, tri), (tel, tei) = _synthesize()
    d = tmp_path / "synth"
    d.mkdir()
    for (lbl, img), (img_name, lbl_name) in zip(
            [(trl, tri), (tel, tei)], MNIST_FILES):
        (d / img_name).write_bytes(encode_idx(img))
        (d / lbl_name).write_bytes(encode_idx(lbl))
    with pytest.raises(RealDataError, match="shape"):
        load_mnist(str(d), require_real=True)


def test_require_real_data_accepts_canonical_md5(tmp_path, monkeypatch):
    """With md5s matching the pinned table the gate passes and the CLI
    records the accuracy-trajectory JSONL with a provenance header."""
    import hashlib
    import json

    from tensor_ops.utils import mnist_data

    _write_fake_gz_set(tmp_path, n=30)
    fake_md5 = {}
    for name in mnist_data.KNOWN_MD5:
        p = tmp_path / name
        fake_md5[name] = hashlib.md5(p.read_bytes()).hexdigest()
    monkeypatch.setattr(mnist_data, "KNOWN_MD5", fake_md5)

    out = run_cli(
        mnist.main,
        ["--epochs", "1", "-b", "30", "-r", "0.1", "-d", str(tmp_path),
         "-c", "--require-real-data", "--seed", "7"],
    )
    assert "verified train-images-idx3-ubyte" in out
    traj = tmp_path / "accuracy_seed7.jsonl"
    assert traj.exists()
    recs = [json.loads(l) for l in traj.read_text().splitlines()]
    assert recs[0]["kind"] == "header" and recs[0]["seed"] == 7
    assert recs[0]["data"]["train-images-idx3-ubyte"]["source"] == "gz"
    assert any("val_err" in r for r in recs[1:])


def test_dots_seed_determinism():
    """Same --seed twice -> byte-identical output (the reproducibility
    the reference lacks, MNIST.hs:250-251 / Dots.hs:130)."""
    import re

    strip = lambda s: re.sub(r"\(\d+\.\d+s\)", "(Xs)", s)
    a = strip(run_cli(dots.main, ["-s", "300", "--seed", "13", "np"]))
    b = strip(run_cli(dots.main, ["-s", "300", "--seed", "13", "np"]))
    assert a == b
    # (different seeds may still render the same near-blank raster at
    # this tiny sample count, so only the reproducibility claim is tested)


def test_mnist_seed_determinism(tmp_path):
    args = ["--epochs", "1", "--limit", "200", "-b", "200", "--minibatch",
            "50", "-r", "0.2", "-d", str(tmp_path), "-c", "--seed", "3"]
    a = run_cli(mnist.main, args)
    b = run_cli(mnist.main, args)
    # strip the wall-clock timing line before comparing
    import re

    strip = lambda s: re.sub(r"in \d+\.\d+s", "in Xs", s)
    assert strip(a) == strip(b)


def test_require_real_data_rejects_tampered_decoded_cache(tmp_path, monkeypatch):
    """Regression (code review): the loader trains from the DECODED
    cache file; a verified .gz must not certify a tampered raw file."""
    import hashlib

    from tensor_ops.utils import mnist_data
    from tensor_ops.utils.idx import encode_idx
    from tensor_ops.utils.mnist_data import MNIST_FILES, RealDataError

    _write_fake_gz_set(tmp_path, n=10)
    fake_md5 = {}
    for name in mnist_data.KNOWN_MD5:
        fake_md5[name] = hashlib.md5((tmp_path / name).read_bytes()).hexdigest()
    monkeypatch.setattr(mnist_data, "KNOWN_MD5", fake_md5)
    # decoded cache present but TAMPERED (different pixel bytes)
    bad = np.zeros((10, 28, 28), dtype=np.uint8)
    (tmp_path / MNIST_FILES[0][0]).write_bytes(encode_idx(bad))
    with pytest.raises(RealDataError, match="differs from the verified"):
        load_mnist(str(tmp_path), require_real=True)


def test_mnist_induce_range_honors_white_class(tmp_path):
    """-w adds class 10, so -i 10 is valid WITH -w (reference: Finite o
    with o=11) and invalid without it."""
    with pytest.raises(SystemExit):
        run_cli(mnist.main, ["-i", "10", "-d", str(tmp_path)])
    out = run_cli(
        mnist.main,
        ["--epochs", "1", "--limit", "100", "-b", "110", "--minibatch", "50",
         "-r", "0.2", "-d", str(tmp_path), "-w", "-c", "-i", "10"],
    )
    assert "inducing: 10" in out
