"""The port's kernel build (``repro_torch.kernels.build``) on the CPU: a
library is named by a hash of its source, of the ``csrc/`` headers the
source includes and of the flags, so an edited header rebuilds every source
that includes it and leaves the others as they are."""
from repro_torch.kernels import build


def test_library_name_follows_the_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "common.cuh").write_text("// v1\n")
    (tmp_path / "a.cu").write_text('#include <cstdint>\n\n#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cstdint>\nint b;\n")
    a1, b1 = build._target("a")[1], build._target("b")[1]
    assert a1.parent == build.BUILD_DIR and a1.name.startswith("a-") and a1.suffix == ".so"
    assert build._target("a")[1] == a1                  # the same inputs, the same library
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build._target("a")[1] != a1                  # the header changed: rebuilt
    assert build._target("b")[1] == b1                  # b does not include it
    (tmp_path / "b.cu").write_text("#include <cstdint>\nint b2;\n")
    assert build._target("b")[1] != b1
