"""The port's kernel build plumbing (``repro_torch.kernels._build``), on the CPU.

The library key must cover every header a source includes, so an edited
header is rebuilt rather than loaded stale; and the shared grad guard must
refuse exactly the inputs a kernel without backward would lose gradients on.
No test here needs ``nvcc`` or a card.
"""
import os

import pytest
import torch

from repro_torch.kernels import _build
from torch_threads import one_thread

one_thread()


def write(path, text):
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture
def csrc(tmp_path):
    write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    write(tmp_path / "a.cuh", '#pragma once\n  #  include "b.cuh"\nint a;\n')
    write(tmp_path / "b.cuh", "#pragma once\nint b;\n")
    write(tmp_path / "unused.cuh", "int u;\n")
    return tmp_path


def test_sources_follow_quoted_includes_transitively(csrc):
    names = [os.path.basename(p) for p in _build.sources("k", str(csrc))]
    assert names == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_digest_changes_when_the_source_or_an_included_header_changes(csrc, edited):
    before = _build.digest("k", str(csrc))
    assert _build.digest("k", str(csrc)) == before
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert _build.digest("k", str(csrc)) != before


def test_digest_ignores_headers_the_source_does_not_include(csrc):
    before = _build.digest("k", str(csrc))
    write(csrc / "unused.cuh", "int u2;\n")
    assert _build.digest("k", str(csrc)) == before


def test_digest_covers_the_compiler_flags(csrc, monkeypatch):
    before = _build.digest("k", str(csrc))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.digest("k", str(csrc)) != before


def test_the_flash_library_key_covers_the_hopper_header():
    names = [os.path.basename(p) for p in _build.sources("flash_attention")]
    assert names[0] == "flash_attention.cu" and "hopper.cuh" in names


def test_build_names_the_library_by_the_digest(csrc, tmp_path, monkeypatch):
    """An up-to-date library is found by its digest and not rebuilt."""
    monkeypatch.setattr(_build, "SRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(tmp_path / "build")
    lib = tmp_path / "build" / f"libk-{_build.digest('k', str(csrc))[:16]}.so"
    write(lib, "")
    assert _build.build("k") == str(lib)


def test_refuse_grad_raises_naming_the_inputs_that_require_grad():
    x, y = torch.ones(2, requires_grad=True), torch.ones(2)
    with pytest.raises(RuntimeError, match=r"op: x requires grad.*no backward"):
        _build.refuse_grad("op", x=x, y=y)


def test_refuse_grad_passes_without_grad_or_without_grad_inputs():
    x = torch.ones(2, requires_grad=True)
    _build.refuse_grad("op", y=torch.ones(2))
    with torch.no_grad():
        _build.refuse_grad("op", x=x)
    with torch.inference_mode():
        _build.refuse_grad("op", x=torch.ones(2))


@pytest.mark.parametrize("name,kernel", [("envy", "pd_segment_kernel"),
                                         ("envy", "envy_gaps_kernel"),
                                         ("waterfill", "waterfill_solve_kernel"),
                                         ("waterfill", "waterfill_masses_kernel"),
                                         ("slstm", "slstm_forward_kernel"),
                                         ("slstm", "slstm_backward_kernel")])
def test_the_library_key_covers_each_kernel_of_a_source(tmp_path, name, kernel):
    """The fused solver kernels share a source (and so a library) with the
    standalone kernels, and the sLSTM scan with its backward: an edit to
    either kernel's body changes the key."""
    with open(os.path.join(_build.SRC_DIR, name + ".cu")) as f:
        src = f.read()
    write(tmp_path / f"{name}.cu", src)
    before = _build.digest(name, str(tmp_path))
    body = src.index("{", src.index(f"{kernel}("))
    write(tmp_path / f"{name}.cu", src[:body + 1] + "\n  // edited" + src[body + 1:])
    assert _build.digest(name, str(tmp_path)) != before
    assert [os.path.basename(p) for p in _build.sources(name)] == [f"{name}.cu"]
