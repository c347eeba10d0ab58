"""Multi-host (DCN) corpus execution: two real `jax.distributed` processes.

SURVEY §2.2 maps the reference's par-mode to "shard blocks across the
devices of a host + multi-host corpus sharding". The first half is covered
by the mesh tests (test_parallel.py); this test proves the DCN half end to end with two
OS processes forming a jax.distributed cluster over Gloo:

- `parallel.shard_corpus` deterministically splits the file list with no
  overlap and full coverage;
- each process encodes its shard with `parallel.encode_corpus` on its
  local devices;
- per-host encoded byte counts are combined with a cross-process
  allgather (the DCN collective);
- the merged outputs are byte-identical to a single-process encode of the
  whole corpus.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from flacenc_tpu import config, sigen, source
from flacenc_tpu.parallel import encode_corpus, shard_corpus

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.distributed.initialize(
        {coord!r}, num_processes=2, process_id=int(sys.argv[1])
    )
    import numpy as np
    from flacenc_tpu import config, sigen, source
    from flacenc_tpu.parallel import encode_corpus, shard_corpus

    def make(seed, n):
        x = np.zeros(2 * n, np.int32)
        x[0::2] = (sigen.Sine(90 + seed, 0.4).noise_with_seed(seed, 0.02)
                   .to_vec_quantized(16, n))
        x[1::2] = (sigen.Sine(91 + seed, 0.4).noise_with_seed(seed + 100, 0.02)
                   .to_vec_quantized(16, n))
        return x

    names = [f"f{{i}}" for i in range(5)]
    mine = shard_corpus(names, 2, jax.process_index())
    sources = [
        (nm, source.MemSource(make(int(nm[1:]), 1500 + 700 * int(nm[1:])),
                              2, 16, 44100))
        for nm in mine
    ]
    streams, _ = encode_corpus(
        sources, config.Encoder().into_verified(), 512
    )
    out = {{nm: streams[nm].to_bytes().hex() for nm in mine}}

    # DCN collective: allgather per-host encoded byte totals
    from jax.experimental import multihost_utils
    import jax.numpy as jnp
    local_bytes = jnp.asarray(
        [sum(len(bytes.fromhex(h)) for h in out.values())], jnp.int64
    )
    all_bytes = multihost_utils.process_allgather(local_bytes)
    out["__allgather_total__"] = int(np.asarray(all_bytes).sum())
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
    """
)


def _make(seed, n):
    x = np.zeros(2 * n, np.int32)
    x[0::2] = (
        sigen.Sine(90 + seed, 0.4).noise_with_seed(seed, 0.02)
        .to_vec_quantized(16, n)
    )
    x[1::2] = (
        sigen.Sine(91 + seed, 0.4).noise_with_seed(seed + 100, 0.02)
        .to_vec_quantized(16, n)
    )
    return x


def test_shard_corpus_partition_properties():
    names = [f"f{i}" for i in range(11)]
    shards = [shard_corpus(names, 3, h) for h in range(3)]
    merged = sorted(n for s in shards for n in s)
    assert merged == sorted(names)  # full coverage, no overlap
    # deterministic
    assert shards == [shard_corpus(names, 3, h) for h in range(3)]


def _run_dcn_pair(tmp_path, attempt: int):
    """Spawn the two-process cluster once. Returns (ok, logs, outs).

    The coordinator port is probed-then-released, so a loaded box can
    steal it between the probe and the child bind; distributed init can
    also time out when both cold processes fight one busy core. Those
    are infra failures (nonzero child rc), NOT encoder failures — the
    caller retries them with a fresh port. Byte-comparison assertions
    never retry."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    child_src = _CHILD.format(repo=_REPO, coord=coord)
    script = tmp_path / f"child{attempt}.py"
    script.write_text(child_src)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    outs = [tmp_path / f"out0_{attempt}.json", tmp_path / f"out1_{attempt}.json"]
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(outs[pid])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    try:
        logs = [p.communicate(timeout=560)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        return False, ["child timed out (loaded box)"], outs
    ok = all(p.returncode == 0 for p in procs)
    return ok, logs, outs


# log signatures of INFRA failures (port steal between probe and bind,
# distributed-init timeout on a loaded box, coordinator unreachable);
# only these are retried with a fresh port — any other nonzero child
# exit is a real encoder/cluster bug and must fail immediately, not be
# masked by a lucky retry (advisor r4)
_INFRA_SIGNATURES = (
    "child timed out",            # _run_dcn_pair's own timeout marker
    "address already in use",
    "failed to bind",
    "bind failed",
    "deadline_exceeded",
    "deadline exceeded",
    "connection refused",
    "failed to connect",
    "unavailable: ",
    "timed out waiting",
    "barrier timed out",
    "coordination service",
)


def _is_infra_failure(logs) -> bool:
    text = "\n".join(logs).lower()
    return any(sig in text for sig in _INFRA_SIGNATURES)


def test_two_process_dcn_corpus_matches_single_process(tmp_path):
    for attempt in range(3):
        ok, logs, outs = _run_dcn_pair(tmp_path, attempt)
        if ok or not _is_infra_failure(logs):
            break
    assert ok, "\n---\n".join(log[-2000:] for log in logs)

    import json

    merged = {}
    totals = []
    for out in outs:
        d = json.loads(out.read_text())
        totals.append(d.pop("__allgather_total__"))
        for k, v in d.items():
            assert k not in merged, "shard overlap"
            merged[k] = bytes.fromhex(v)
    assert sorted(merged) == [f"f{i}" for i in range(5)]  # full coverage

    # single-process reference encode of the whole corpus
    sources = [
        (f"f{i}", source.MemSource(_make(i, 1500 + 700 * i), 2, 16, 44100))
        for i in range(5)
    ]
    streams, _ = encode_corpus(sources, config.Encoder().into_verified(), 512)
    for i in range(5):
        assert merged[f"f{i}"] == streams[f"f{i}"].to_bytes(), f"f{i}"

    # both hosts agreed on the allgathered global byte total
    expect_total = sum(len(v) for v in merged.values())
    assert totals == [expect_total, expect_total]
