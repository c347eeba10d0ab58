"""bench.py output-format contract: these tests pin the result line's
shape, the stage-extras derivation and the failure exit."""

import json
import sys

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import bench


def test_emit_line_is_one_parseable_json_object(capsys):
    bench._emit(123.4, {"degraded": True, "trials_done": 1})
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    obj = json.loads(out[0])
    assert obj["metric"] == bench.METRIC
    assert obj["value"] == 123.4
    assert obj["unit"] == "x_realtime"
    assert obj["vs_baseline"] == round(123.4 / bench.BASELINE_X_REALTIME, 4)
    assert obj["extra"]["degraded"] is True


def test_stage_extras_host_ceiling():
    stats = {"wall_s": 10.0, "device_wait_s": 6.0, "read_s": 1.0,
             "pack_s": 2.0, "batches": 4, "link_mbps": 42.0}
    ex = bench._stage_extras(stats, n_samples=441000, rate=44100)
    # 10 s audio over (10 - 6 + 2) s host time: assembly (pack_s) runs on
    # io threads inside the link wait, so the host ceiling charges it back
    assert ex["host_ceiling_x_realtime"] == round(10.0 / 6.0, 1)
    assert ex["wall_s"] == 10.0 and ex["device_wait_s"] == 6.0
    assert ex["batches"] == 4 and ex["link_mbps"] == 42.0
    assert bench._stage_extras({}, 1, 1) == {}


def test_make_audio_deterministic_int16_range():
    a = bench.make_audio(0.1)
    b = bench.make_audio(0.1)
    assert (a == b).all()
    assert a.dtype == __import__("numpy").int32
    assert a.min() >= -32768 and a.max() <= 32767
    assert len(a) == 2 * 4410


def test_bench_exits_nonzero_without_accelerator():
    """bench.py is a direct run: on a CPU-only backend it fails with a
    non-zero exit and prints no result line (no CPU fallback)."""
    import os
    import subprocess

    repo = __file__.rsplit("/tests/", 1)[0]
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_SECONDS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py")], env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"metric"' not in proc.stdout
    assert "no accelerator" in proc.stderr
