"""`repro_torch.kernels._build` names each library by a hash of its source,
of the `csrc/` headers the source includes and of the flags, so that an
edited header never loads a library built from the old one.  Checked on a
temporary copy of `csrc/`; nothing is compiled."""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_the_attention_sources_include_the_shared_header(csrc):
    for name in ("flash_attention", "flash_attention_bwd"):
        assert [p.name for p in _build.sources(name, csrc)] == [
            f"{name}.cu", "hopper.cuh"]
    assert [p.name for p in _build.sources("segment_combine", csrc)] == [
        "segment_combine.cu"]


@pytest.mark.parametrize("edited", ["hopper.cuh", "flash_attention_bwd.cu"])
def test_an_edited_header_or_source_changes_the_library_path(csrc, edited):
    names = ("flash_attention", "flash_attention_bwd", "segment_combine")
    before = {n: _build.library_path(n, csrc) for n in names}
    assert before == {n: _build.library_path(n, csrc) for n in names}
    path = csrc / edited
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n, csrc) for n in names}
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert (after["flash_attention"] != before["flash_attention"]) == (
        edited == "hopper.cuh")
    assert after["segment_combine"] == before["segment_combine"]


def test_a_header_included_by_a_header_counts(csrc):
    (csrc / "inner.cuh").write_text("// inner\n")
    hopper = csrc / "hopper.cuh"
    hopper.write_text('#include "inner.cuh"\n' + hopper.read_text())
    before = _build.library_path("flash_attention_bwd", csrc)
    assert "inner.cuh" in [p.name for p in _build.sources(
        "flash_attention_bwd", csrc)]
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    assert _build.library_path("flash_attention_bwd", csrc) != before
