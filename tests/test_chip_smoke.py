"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
anywhere but on a GPU.  The full-size run is ``python chip_smoke.py`` on
the card."""

import json
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (repo-root chip_smoke.py)

TINY = (16, 12, 8, 4)


def test_phase_device_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.phase_device(jax)


def test_main_refuses_without_nvidia_smi(monkeypatch, capsys):
    monkeypatch.setenv("PATH", "")
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "nvidia-smi" in out.err


def test_main_refuses_cpu_platform(monkeypatch, capsys, tmp_path):
    """Even with a card listed and the gpu tests passed, a JAX that runs
    on the CPU fails phase 1 and prints no result line."""
    monkeypatch.setattr(cs, "card_info", lambda: "Some GPU, 700.00 W")
    monkeypatch.setattr(cs, "run_gpu_tests", lambda: "3 passed")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_phase_train_mlp_tiny():
    net = cs.phase_train_mlp(dims=TINY, n_rows=512, batch=64, epochs=3,
                             n_check=4)
    assert net.out_shape == (TINY[-1],)


def test_phase_train_rnn_tiny():
    cs.phase_train_rnn(shape=(3, 8, 3, 5), n_seqs=32, batch=8, epochs=2,
                       n_check=2, rates=(0.01, 0.05))


def test_phase_serve_tiny(capsys):
    import tensor_ops as T

    net = cs.flagship_net(T.JaxBackend(), TINY)
    cs.phase_serve_f32(net, sizes=(1, 5, 9))
    cs.phase_serve_int8(net, stack=(32, 3), buckets=(1, 16), reps=2,
                        card="cpu")
    out = capsys.readouterr().out
    assert "FusedMLP bf16" in out and "Predictor.predict stack batch 16" in out


def test_phase_four_tiny(capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8-device CPU mesh")
    cs.phase_four(dims=TINY, pipe_dims=(16, 12, 8, 8, 4), n_rows=128,
                  batch=32)
    out = capsys.readouterr().out
    assert "over [0, 1, 2, 3]" in out and "pipeline, 4 stages" in out


def test_result_line_is_the_contract(monkeypatch, capsys, tmp_path):
    """With every phase stubbed to pass, the last two lines are the card
    and the one JSON object the driver reads."""
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(cs, "card_info", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(cs, "run_gpu_tests", lambda: "3 passed")
    monkeypatch.setattr(cs, "phase_device", lambda jax: dev)
    for name in ("phase_train_mlp", "phase_train_rnn", "phase_serve_f32",
                 "phase_serve_int8"):
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "card: NVIDIA H100, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": dev}
