"""chip_smoke.py's contract: it fails without a GPU and prints no result,
and its last line is exactly the `ok` object. The kernel comparisons it
runs on the card are also a `gpu`-marked test here."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_ok_line_shape(monkeypatch, capsys, argv):
    import jax

    class _Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    ran = []
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: (_Dev(), card))
    monkeypatch.setattr(chip_smoke.bench, "make_audio",
                        lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(chip_smoke, "phase_stream",
                        lambda *a: ran.append("stream") or (9.0, 1.0, 1.0, {}))
    for name in ("phase_strict", "phase_surfaces", "phase_kernels",
                 "phase_hlo", "phase_divergence", "phase_timing",
                 "run_multi"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name: ran.append(_n))
    assert chip_smoke.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == card
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": len(jax.devices())}}
    assert ran == (["run_multi"] if argv else [
        "stream", "phase_strict", "phase_surfaces", "phase_kernels",
        "phase_hlo", "phase_divergence", "phase_timing"])


@pytest.mark.gpu
def test_kernels_match_reference_on_card(gpu_device):
    from flacenc_tpu import config

    audio = chip_smoke.bench.make_audio(60.0)
    chip_smoke.phase_kernels(config.Encoder().into_verified(), audio,
                             widths=(64,))
