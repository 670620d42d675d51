"""The kernel build's bookkeeping, with a stand-in nvcc: one compiler call
per source, started together, and one link of their objects; no rebuild
while the sources are unchanged, a rebuild when one changes.  (The real
nvcc build runs on the card: chip_smoke.py.)"""

import os
import stat

import pytest

pytest.importorskip("torch")

from cooper_mapper_torch import build  # noqa: E402

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi
  shift
done
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc_calls.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    return log, csrc


def test_one_nvcc_call_then_cached_until_a_source_changes(fake_toolkit):
    # one nvcc build: a compile per source (in parallel), then one link
    log, csrc = fake_toolkit
    path = build.build()
    assert os.path.isfile(path) and path.endswith(build.LIB_NAME)
    calls = log.read_text().splitlines()
    assert len(calls) == 3
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    compiles, link = calls[:2], calls[2]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == ["a.cu", "b.cu"]
    assert all(" -c " in c and c.count(".cu") == 2 for c in compiles)   # the source, its .cu.o
    assert "-shared" in link and link.count(".cu.o") == 2
    build.build()
    assert len(log.read_text().splitlines()) == 3
    (csrc / "b.cu").write_text("// changed\n")
    build.build()
    assert len(log.read_text().splitlines()) == 6


def test_a_header_change_rebuilds_and_headers_are_not_compiled(fake_toolkit):
    # csrc/*.cuh are included by the sources: they enter the hash, not the
    # compiler's file list
    log, csrc = fake_toolkit
    (csrc / "shared.cuh").write_text("// shared\n")
    build.build()
    assert ".cuh" not in log.read_text()
    build.build()
    assert len(log.read_text().splitlines()) == 3
    (csrc / "shared.cuh").write_text("// changed\n")
    build.build()
    assert len(log.read_text().splitlines()) == 6
