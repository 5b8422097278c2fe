"""MNIST data pipeline: fetch-on-miss cache of the four IDX files, with a
deterministic synthetic fallback for offline environments.

Mirrors the reference's loader (``loadData``, ``app/MNIST.hs:159-192``):
look for the uncompressed IDX files in the data dir; on miss, download the
``.gz`` from the MNIST mirror, decompress, and write back to the cache.
The rebuild adds: if the network is unreachable (hermetic machines),
generate a clearly-labeled *synthetic* pseudo-MNIST —
class-conditional noisy prototypes — so the end-to-end app and tests run
anywhere.
"""

from __future__ import annotations

import gzip
import os
from typing import List, Tuple
from urllib.request import urlopen

import numpy as np

from .idx import decode_idx, encode_idx, labeled_data

MNIST_BASE = "https://ossci-datasets.s3.amazonaws.com/mnist"  # lecun mirror
MNIST_FILES = [
    ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
]

# md5 of the canonical .gz distribution files (the values published with
# the dataset and pinned by every major loader).  Used by the
# --require-real-data gate to refuse synthetic or tampered inputs.
KNOWN_MD5 = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}

# structural signature of the real dataset (counts/dims); a decoded IDX
# set that matches this is accepted even without the .gz files
REAL_COUNTS = {
    "train-images-idx3-ubyte": (60000, 28, 28),
    "train-labels-idx1-ubyte": (60000,),
    "t10k-images-idx3-ubyte": (10000, 28, 28),
    "t10k-labels-idx1-ubyte": (10000,),
}

Sample = Tuple[int, np.ndarray]


class RealDataError(RuntimeError):
    """Raised by ``load_mnist(require_real=True)`` when the on-disk data
    cannot be verified as the real MNIST distribution."""


def verify_real_mnist(data_dir: str) -> dict:
    """Verify the four MNIST files in ``data_dir`` are the real dataset.

    Two accepted forms of evidence, checked per file:
    - ``<name>.gz`` present with the canonical md5 (``KNOWN_MD5``);
    - decoded ``<name>`` IDX content with the real dataset's exact
      shape signature (60000/10000 x 28 x 28, labels in 0..9) — the
      synthetic fallback (6000/1000 samples) can never pass this.

    Returns ``{name: {"source": "gz"|"idx", "md5"|"shape": ...}}``;
    raises :class:`RealDataError` listing every failure otherwise.
    """
    import hashlib

    report, failures = {}, []
    for img_name, lbl_name in MNIST_FILES:
        for name in (img_name, lbl_name):
            gz = os.path.join(data_dir, name + ".gz")
            raw_path = os.path.join(data_dir, name)
            if os.path.exists(gz):
                with open(gz, "rb") as f:
                    gz_bytes = f.read()
                digest = hashlib.md5(gz_bytes).hexdigest()
                if digest != KNOWN_MD5[name + ".gz"]:
                    failures.append(
                        f"{name}.gz: md5 {digest} != canonical "
                        f"{KNOWN_MD5[name + '.gz']}")
                    continue
                # the loader trains from the DECODED cache file when one
                # exists — certify those exact bytes, not just the .gz
                if os.path.exists(raw_path):
                    with open(raw_path, "rb") as f:
                        raw = f.read()
                    if raw != gzip.decompress(gz_bytes):
                        failures.append(
                            f"{name}: decoded cache differs from the "
                            f"verified {name}.gz contents (tampered or "
                            f"stale cache — delete {name} to re-extract)")
                        continue
                report[name] = {"source": "gz", "md5": digest}
                continue
            if os.path.exists(raw_path):
                with open(raw_path, "rb") as f:
                    try:
                        arr = decode_idx(f.read())
                    except ValueError as e:
                        failures.append(f"{name}: corrupt IDX ({e})")
                        continue
                if arr.shape != REAL_COUNTS[name]:
                    failures.append(
                        f"{name}: shape {arr.shape} != real "
                        f"{REAL_COUNTS[name]} (synthetic/subsampled data?)")
                    continue
                if arr.ndim == 1 and (arr.min() < 0 or arr.max() > 9):
                    failures.append(f"{name}: labels outside 0..9")
                    continue
                report[name] = {"source": "idx", "shape": arr.shape}
                continue
            failures.append(f"{name}: not found (neither IDX nor .gz)")
    if failures:
        raise RealDataError(
            "real-MNIST verification failed:\n  " + "\n  ".join(failures))
    return report


def _fetch(url: str, timeout: float = 20.0) -> bytes:
    with urlopen(url, timeout=timeout) as r:  # noqa: S310
        return r.read()


def _synthesize(n_train: int = 6000, n_test: int = 1000, seed: int = 1234):
    """Deterministic pseudo-MNIST: per-class smooth random prototypes in
    [0,1]^784 plus noise — linearly separable enough to validate training
    end-to-end, clearly not real digits."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0.0, 1.0, size=(10, 784))
    # smooth the prototypes a little so /255-style stats look image-like
    protos = (protos + np.roll(protos, 1, axis=1) + np.roll(protos, -1, axis=1)) / 3.0

    def make(n, rng):
        labels = rng.integers(0, 10, size=n)
        imgs = np.clip(
            protos[labels] * 0.8 + rng.normal(0, 0.15, size=(n, 784)), 0.0, 1.0
        )
        return labels.astype(np.uint8), (imgs * 255).astype(np.uint8).reshape(n, 28, 28)

    tr = make(n_train, np.random.default_rng(seed + 1))
    te = make(n_test, np.random.default_rng(seed + 2))
    return tr, te


def load_mnist(data_dir: str, allow_synthetic: bool = True,
               require_real: bool = False) -> List[List[Sample]]:
    """Return ``[train_samples, test_samples]`` as ``[(label, pixels)]``
    with uint8 pixel vectors of length 784.

    ``require_real=True`` refuses the synthetic fallback entirely and
    verifies the on-disk files are the canonical MNIST distribution
    (md5 of the .gz files or the exact 60000/10000 shape signature)
    BEFORE training touches them — raises :class:`RealDataError`
    otherwise."""
    os.makedirs(data_dir, exist_ok=True)
    if require_real:
        allow_synthetic = False
        # fetch any missing file as .gz first so the md5 gate applies
        for img_name, lbl_name in MNIST_FILES:
            for name in (img_name, lbl_name):
                have = (os.path.exists(os.path.join(data_dir, name))
                        or os.path.exists(os.path.join(data_dir, name + ".gz")))
                if not have:
                    try:
                        raw = _fetch(f"{MNIST_BASE}/{name}.gz")
                    except Exception as e:
                        raise RealDataError(
                            f"{name} missing and download failed "
                            f"({type(e).__name__}: {e})") from e
                    tmp = os.path.join(data_dir, name + ".gz.tmp")
                    with open(tmp, "wb") as f:
                        f.write(raw)
                    os.replace(tmp, os.path.join(data_dir, name + ".gz"))
        report = verify_real_mnist(data_dir)
        for name, info in sorted(report.items()):
            print(f"verified {name}: {info}")
    print(f"Loading data from {data_dir}")
    out: List[List[Sample]] = []
    try:
        for img_name, lbl_name in MNIST_FILES:
            arrays = []
            for name in (img_name, lbl_name):
                path = os.path.join(data_dir, name)
                raw = None
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        raw = f.read()
                    try:
                        arrays.append(decode_idx(raw))
                        continue
                    except ValueError:
                        # corrupt/truncated cache (e.g. killed mid-write):
                        # discard and fall through to re-acquire
                        print(f"cached '{name}' is corrupt; refetching")
                        os.remove(path)
                        raw = None
                if raw is None and os.path.exists(path + ".gz"):
                    # user-provided compressed files (airgapped hosts)
                    with open(path + ".gz", "rb") as f:
                        raw = gzip.decompress(f.read())
                if raw is None:
                    print(f"'{name}' not found; downloading from {MNIST_BASE} ...")
                    raw = gzip.decompress(_fetch(f"{MNIST_BASE}/{name}.gz"))
                arr = decode_idx(raw)  # validate before caching
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(raw)
                os.replace(tmp, path)  # atomic: no truncated cache files
                arrays.append(arr)
            images, labels = arrays
            out.append(labeled_data(labels, images))
        return out
    except Exception as e:  # zero-egress or corrupt cache
        if not allow_synthetic:
            raise
        print(f"Could not load real MNIST ({type(e).__name__}: {e}).")
        print("Falling back to SYNTHETIC pseudo-MNIST (deterministic, offline).")
        (trl, tri), (tel, tei) = _synthesize()
        # cache the synthetic set in IDX format so reruns are stable
        for (lbl, img), (img_name, lbl_name) in zip(
            [(trl, tri), (tel, tei)], MNIST_FILES
        ):
            with open(os.path.join(data_dir, img_name + ".synthetic"), "wb") as f:
                f.write(encode_idx(img))
            with open(os.path.join(data_dir, lbl_name + ".synthetic"), "wb") as f:
                f.write(encode_idx(lbl))
        return [labeled_data(trl, tri), labeled_data(tel, tei)]
