"""How the port's CUDA kernels are built (``repro_torch.kernels._build``),
on the CPU: no ``nvcc`` is needed, since the target name is only a hash and
the compiler is replaced by a stand-in that records its command line."""
import shutil
import types

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

KERNELS = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead of the real one."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return copy


def test_every_kernel_shares_a_header():
    assert len(KERNELS) == 5
    assert (_build.CSRC / "tensor_core.cuh").exists()


@pytest.mark.parametrize("name", KERNELS)
def test_target_name_changes_when_a_header_changes(csrc, name):
    before = _build._target(name)
    assert _build._target(name) == before           # a hash, nothing else
    header = csrc / "tensor_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build._target(name)
    assert edited != before and edited.name.startswith(f"{name}-")
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert _build._target(name) != edited            # a new header counts


@pytest.mark.parametrize("name", KERNELS)
def test_target_name_changes_only_with_its_own_source(csrc, name):
    before = {n: _build._target(n) for n in KERNELS}
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in KERNELS}
    assert [n for n in KERNELS if after[n] != before[n]] == [name]


def test_build_passes_the_header_directory(csrc, monkeypatch):
    """Each nvcc command names ``-I csrc``, so a source finds the shared
    header wherever the checkout lies."""
    cmds = []

    def fake_popen(cmd, **kw):
        cmds.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return types.SimpleNamespace(communicate=lambda: ("ptxas info", None),
                                     returncode=0)

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", fake_popen)
    built = _build.build(KERNELS)
    assert sorted(built) == KERNELS and all(p.exists() for p in built.values())
    for cmd in cmds:
        i = cmd.index("-I")
        assert cmd[i + 1] == str(csrc)
    assert _build.build_log(KERNELS[0]) == "ptxas info"
