"""The kernel build's library names (``cuda_build.library_path``), checked
without nvcc: a library is named by a hash of its source and of every
shared ``csrc/*.cuh`` header, so that editing a header a kernel includes
gives a new name (a rebuild) instead of loading a stale library."""

from distributed_llms_example_tpu_torch.ops import cuda_build


def test_header_edit_changes_the_library_path(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nextern "C" int k() { return 0; }\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")
    (tmp_path / "h.cuh").write_text("#pragma once\n// edited\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("#pragma once\n")
    assert cuda_build.library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nextern "C" int k() { return 1; }\n')
    assert cuda_build.library_path("k").parent == cuda_build.BUILD_DIR
    assert cuda_build.library_path("k").name.startswith("libk-")


def test_every_tensor_core_source_includes_the_shared_header():
    for name in ("flash_fwd_tc", "flash_bwd_tc"):
        assert '#include "hopper.cuh"' in (cuda_build.CSRC / f"{name}.cu").read_text()
    assert (cuda_build.CSRC / "hopper.cuh").exists()
