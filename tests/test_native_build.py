"""native/build.py rebuild rule: a library is keyed by its source, the
compile flags and the host CPU, so an edited source or another machine's
checkout builds afresh instead of loading a stale library."""

from flacenc_tpu.native import build


def test_rebuild_keyed_on_source_and_host(monkeypatch, tmp_path):
    src = tmp_path / "k.cpp"
    src.write_text("int f() { return 1; }\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "host_cpu_flags", lambda: "flags : avx2")
    compiles = []

    def fake_run(cmd, check):
        compiles.append(cmd)
        with open(cmd[-1], "w") as f:
            f.write("lib")

    monkeypatch.setattr(build.subprocess, "run", fake_run)
    first = build._compile(str(src), "libk.so", force=False)
    assert build._compile(str(src), "libk.so", force=False) == first
    assert len(compiles) == 1  # same source, same host: reused
    assert first.startswith(str(tmp_path / "_build"))

    src.write_text("int f() { return 2; }\n")  # edited source
    second = build._compile(str(src), "libk.so", force=False)
    assert second != first and len(compiles) == 2

    monkeypatch.setattr(build, "host_cpu_flags", lambda: "flags : avx512f")
    third = build._compile(str(src), "libk.so", force=False)  # other host
    assert third not in (first, second) and len(compiles) == 3
    assert build._compile(str(src), "libk.so", force=True) == third
    assert len(compiles) == 4
