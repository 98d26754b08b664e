"""The kernel build, checked without nvcc: a library is named by a hash of
its source and of every shared ``csrc/*.cuh`` header, so that editing a
header a kernel includes gives a new name (a rebuild) instead of loading a
stale library; ``build`` compiles only what is out of date; chip_smoke.py
builds every source under ``csrc/`` and reads each tensor-core kernel's
HGMMA count and stack frame from the built library, cached or not, and
kernels 7 and 8's registers and stack frames too; kernels 5 and 6 are the
two instances of one template in a shared header, and chip_smoke.py reads
each library's instances of it."""

import importlib.util
import os
import stat
import sys

import pytest

from distributed_llms_example_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    for name in ("flash_fwd_tc", "flash_bwd_tc", "flash_bwd_dlbias_tc"):
        assert '#include "hopper.cuh"' in (cuda_build.CSRC / f"{name}.cu").read_text()
    assert (cuda_build.CSRC / "hopper.cuh").exists()


def fake_tool(path, body: str):
    """An executable Python script at ``path``: a stand-in for nvcc or
    cuobjdump."""
    path.write_text(f"#!{sys.executable}\nimport sys\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


def fake_sources(tmp_path, monkeypatch, names):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in names:
        (csrc / f"{name}.cu").write_text(f'extern "C" int {name}() {{ return 0; }}\n')
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")


def test_build_compiles_only_what_is_out_of_date(tmp_path, monkeypatch, capsys):
    """A stand-in for nvcc that writes the library and prints a ptxas-like
    line: ``build`` compiles each named source once, prints the compiler's
    report when verbose, and compiles nothing whose library is up to
    date."""
    fake = fake_tool(tmp_path / "nvcc",
                     "out = sys.argv[sys.argv.index('-o') + 1]\n"
                     "open(out, 'wb').close()\n"
                     "print('ptxas info    : Used 42 registers', sys.argv[-1].rsplit('/', 1)[-1])\n")
    fake_sources(tmp_path, monkeypatch, ("a", "b"))
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(fake))
    assert set(cuda_build.build(["a", "b"], verbose=True)) == {"a", "b"}
    printed = capsys.readouterr().out
    assert "Used 42 registers a.cu" in printed and "Used 42 registers b.cu" in printed
    assert cuda_build.library_path("a").exists() and cuda_build.library_path("b").exists()
    assert cuda_build.build(["a", "b"], verbose=True) == {}
    assert capsys.readouterr().out == ""


def test_chip_smoke_builds_every_source():
    """chip_smoke.py's build list is every csrc/*.cu, ten of them: kernel
    1's, 2-3's and 4's two routes each, kernels 5, 6, 7 and 8."""
    mod = load_chip_smoke()
    sources = {p.stem for p in cuda_build.CSRC.glob("*.cu")}
    assert sorted(mod.KERNELS) == sorted(sources)
    assert len(sources) == 10 and "flash_bwd_dlbias_tc" in sources
    assert {lib for lib, _, _ in mod.TC_KERNELS} == {"flash_fwd_tc", "flash_bwd_tc",
                                                     "flash_bwd_dlbias_tc"}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DLBIAS = "_ZN12_GLOBAL__N_126flash_bwd_dlbias_tc_kernelI{}EEvNS_4ArgsE"
OTHER = "_ZN12_GLOBAL__N_113other_kernelILi64EEEvNS_4ArgsE"


def dlbias_name(args) -> str:
    """The mangled name of the kernel-4 instance of these int template
    arguments."""
    return DLBIAS.format("".join(f"Li{a}E" for a in args))


def res_usage(stacks: dict) -> str:
    """cuobjdump -res-usage's report of a library holding the kernel-4
    instances (d, lbias_bytes) -> stack bytes, and one other kernel."""
    lines = ["Fatbin elf code:", "================", "arch = sm_90a", "", "Resource usage:",
             " Common:", "  GLOBAL:0"]
    rows = [(dlbias_name(k), 180 + k[0] % 7, v) for k, v in stacks.items()]
    for name, regs, stack in rows + [(OTHER, 255, 64)]:
        lines += [f" Function {name}:",
                  f"  REG:{regs} STACK:{stack} SHARED:0 LOCAL:0 CONSTANT[0]:640 TEXTURE:0 "
                  "SURFACE:0 SAMPLER:0"]
    return "\n".join(lines) + "\n"


def sass(instances) -> str:
    """cuobjdump -sass's listing: each kernel-4 instance with two HGMMA
    instructions, and one other kernel with one."""
    lines = ["\tcode for sm_90a"]
    for name, n in [(dlbias_name(k), 2) for k in instances] + [(OTHER, 1)]:
        lines += [f"\t\tFunction : {name}",
                  "        /*0000*/                   MOV R1, c[0x0][0x28] ;"]
        lines += ["        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], "
                  "R24 ;"] * n
    return "\n".join(lines) + "\n"


def test_chip_smoke_reads_registers_and_stack_from_the_library(tmp_path, monkeypatch):
    """chip_smoke.py's reading of a built library: per kernel-4 instance,
    named by its int template arguments, its HGMMA count (cuobjdump -sass)
    and its registers, stack frame and local memory (cuobjdump
    -res-usage); another kernel's lines are not counted."""
    mod = load_chip_smoke()
    stacks = {(64, 2): 0, (128, 4): 24}
    fake_tool(tmp_path / "cuobjdump",
              f"print({sass(stacks)!r} if sys.argv[1] == '-sass' else {res_usage(stacks)!r})\n")
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    fake_sources(tmp_path, monkeypatch, ("flash_bwd_dlbias_tc",))
    args = (cuda_build, "flash_bwd_dlbias_tc", "flash_bwd_dlbias_tc_kernel",
            ("d", "lbias_bytes"))
    assert mod.hgmma_counts(*args) == {"d=64 lbias_bytes=2": 2, "d=128 lbias_bytes=4": 2}
    assert mod.resource_usage(*args) == {
        "d=64 lbias_bytes=2": {"registers": 181, "stack_bytes": 0, "local_bytes": 0},
        "d=128 lbias_bytes=4": {"registers": 182, "stack_bytes": 24, "local_bytes": 0}}
    assert "flash_bwd_dlbias_tc_kernel" in mod.NO_SPILL


@pytest.mark.parametrize("stack", (0, 8))
def test_chip_smoke_spill_gate_reads_a_cached_library(tmp_path, monkeypatch, stack):
    """The spill gate on a library that an earlier run built, so that
    ``build`` compiles nothing this time: it passes when every kernel-4
    instance (head dim, learned-bias bytes, probs dropout) has no stack
    frame and fails the run when one has a frame (where a spill would go),
    a dropout instance's included."""
    mod = load_chip_smoke()
    stacks = {(d, lb, drop): 0 for d in (16, 32, 64, 128) for lb in (2, 4) for drop in (0, 1)}
    assert len(stacks) == mod.TC_INSTANCES["flash_bwd_dlbias_tc_kernel"]
    stacks[(64, 2, 1)] = stack
    fake_tool(tmp_path / "cuobjdump",
              f"print({sass(stacks)!r} if sys.argv[1] == '-sass' else {res_usage(stacks)!r})\n")
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    fake_sources(tmp_path, monkeypatch, ("flash_bwd_dlbias_tc",))
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "/nonexistent/nvcc")
    cuda_build.library_path("flash_bwd_dlbias_tc").parent.mkdir(parents=True)
    cuda_build.library_path("flash_bwd_dlbias_tc").write_bytes(b"")  # built by an earlier run
    assert cuda_build.build(["flash_bwd_dlbias_tc"], verbose=True) == {}
    kernels = [k for k in mod.TC_KERNELS if k[0] == "flash_bwd_dlbias_tc"]
    if stack == 0:
        mod.sass_phase(cuda_build, kernels)
    else:
        with pytest.raises(SystemExit):
            mod.sass_phase(cuda_build, kernels)


# names as nvcc mangles kernels of an anonymous namespace: the namespace's
# name ends in hex digits, and the prep kernel is no template
STREAM_NAMES = {
    ("fused_dropout", "bf16=1 residual=0"):
        "_ZN49_GLOBAL__N__cd8948e6_16_fused_dropout_cu_cfe94f5620fused_dropout_kernelILi1ELi0EEEvPKvS2_PvxxxNS_4ArgsE",
    ("fused_dropout", "bf16=0 residual=1"):
        "_ZN49_GLOBAL__N__cd8948e6_16_fused_dropout_cu_cfe94f5620fused_dropout_kernelILi0ELi1EEEvPKvS2_PvxxxNS_4ArgsE",
    ("fused_adamw", "clip=1"):
        "_ZN47_GLOBAL__N__1785cb6c_14_fused_adamw_cu_57b34e9b18fused_adamw_kernelILi1EEEvNS_5TableEPKfPdNS_5HyperE",
    ("fused_adamw", "fused_grad_prep_kernel"):
        "_ZN47_GLOBAL__N__1785cb6c_14_fused_adamw_cu_57b34e9b22fused_grad_prep_kernelENS_5TableEPKfPdPfS3_ii",
    ("fused_adamw", "grad_norm_finish_kernel"):
        "_ZN47_GLOBAL__N__1785cb6c_14_fused_adamw_cu_57b34e9b23grad_norm_finish_kernelEPKdPf",
}


@pytest.mark.parametrize("stack", (0, 8))
def test_chip_smoke_resource_gate_reads_kernels_7_and_8(tmp_path, monkeypatch, stack):
    """chip_smoke.py's register and stack reading of kernels 7 and 8, from
    each library's cuobjdump -res-usage: every instance found by its
    template arguments (or, for the gradient pass and the norm's finish, its
    name), and the run failed when one has a stack frame."""
    mod = load_chip_smoke()
    reports = {}
    for (lib, inst), name in STREAM_NAMES.items():
        frame = stack if inst == "fused_grad_prep_kernel" else 0
        reports.setdefault(lib, []).extend([
            f" Function {name}:",
            f"  REG:{40 + len(inst)} STACK:{frame} SHARED:0 LOCAL:0 CONSTANT[0]:900"])
    libs = {lib: "Resource usage:\n" + "\n".join(lines) + "\n" for lib, lines in reports.items()}
    fake_tool(tmp_path / "cuobjdump",
              f"reports = {libs!r}\n"
              "print(next(v for k, v in reports.items() if '/lib' + k + '-' in sys.argv[2]))\n")
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    fake_sources(tmp_path, monkeypatch, ("fused_dropout", "fused_adamw"))
    kernels = mod.STREAM_KERNELS
    got = {(lib, name) for lib, kernel, params in kernels
           for name in mod.resource_usage(cuda_build, lib, kernel, params)}
    assert got == set(STREAM_NAMES)
    if stack == 0:
        mod.resource_phase(cuda_build, kernels)
    else:
        with pytest.raises(SystemExit):
            mod.resource_phase(cuda_build, kernels)


def test_decode_entries_instantiate_the_shared_template(tmp_path, monkeypatch):
    """Kernels 5 and 6 are the flat and the paged instance of the one
    kernel template in csrc/flash_decode.cuh: neither C entry holds a
    kernel body of its own, each instantiates the template with its PAGED
    value, and an edit of the header renames (rebuilds) both libraries."""
    header = (cuda_build.CSRC / "flash_decode.cuh").read_text()
    assert header.count("__global__") == 1
    assert "template <int PAGED, int BF16, int INT8, int D, int QM>" in header
    for name, paged in (("flash_decode", 0), ("flash_decode_paged", 1)):
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert '#include "flash_decode.cuh"' in src
        assert "__global__" not in src and "<<<" not in src
        assert f"flash_decode_launch<{paged}>(" in src
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in cuda_build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = [cuda_build.library_path(n) for n in ("flash_decode", "flash_decode_paged")]
    (csrc / "flash_decode.cuh").write_text(header + "// edited\n")
    after = [cuda_build.library_path(n) for n in ("flash_decode", "flash_decode_paged")]
    assert all(a != b for a, b in zip(after, before))


def decode_names(lib: str, paged: int) -> list:
    """The mangled names of every instance of the decode template in
    ``lib``, as nvcc names kernels of an anonymous namespace."""
    ns = f"_ZN52_GLOBAL__N__0badc0de_{len(lib) + 4}_{lib}_cu_89abcdef"
    return [f"{ns}19flash_decode_kernelILi{paged}ELi{bf16}ELi{int8}ELi{d}ELi{qm}EEEvPKvS2_S2_"
            "PKfS4_S4_xxxxPKiS6_Pviiiiiiif"
            for bf16 in (0, 1) for int8 in (0, 1) for d in (16, 32, 64, 128) for qm in (1, 8)]


@pytest.mark.parametrize("fault", [None, "stack", "missing", "paged"])
def test_chip_smoke_decode_gate_reads_both_entries(tmp_path, monkeypatch, fault):
    """chip_smoke.py's reading of kernels 5 and 6 from each library's
    cuobjdump -res-usage: 32 instances of the one template each, named by
    their template arguments, the flat library's all paged=0 and the paged
    one's all paged=1, none with a stack frame.  The run fails on a stack
    frame, on a missing instance, or on an instance of the other entry."""
    mod = load_chip_smoke()
    reports = {}
    for lib, paged in (("flash_decode", 0), ("flash_decode_paged", 1)):
        names = decode_names(lib, paged)
        if lib == "flash_decode" and fault == "missing":
            names = names[1:]
        if lib == "flash_decode" and fault == "paged":
            names[0] = names[0].replace("kernelILi0E", "kernelILi1E")
        lines = []
        for i, name in enumerate(names):
            frame = 16 if fault == "stack" and lib == "flash_decode_paged" and i == 5 else 0
            lines += [f" Function {name}:",
                      f"  REG:{60 + i} STACK:{frame} SHARED:0 LOCAL:0 CONSTANT[0]:520"]
        reports[lib] = "Resource usage:\n" + "\n".join(lines) + "\n"
    fake_tool(tmp_path / "cuobjdump",
              f"reports = {reports!r}\n"
              "print(next(v for k, v in reports.items() if '/lib' + k + '-' in sys.argv[2]))\n")
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    fake_sources(tmp_path, monkeypatch, ("flash_decode", "flash_decode_paged"))
    usage = mod.resource_usage(cuda_build, *mod.DECODE_KERNELS[0])
    if fault is None:
        assert len(usage) == mod.DECODE_INSTANCES == 32
        assert usage["paged=0 bf16=1 int8=0 d=128 q_rows=1"] == {
            "registers": 60 + 16 + 3 * 2, "stack_bytes": 0, "local_bytes": 0}
        mod.decode_resource_phase(cuda_build)
    else:
        with pytest.raises(SystemExit):
            mod.decode_resource_phase(cuda_build)


DROPOUT_SOURCES = ("fused_dropout", "flash_fwd_tc", "flash_fwd", "flash_bwd_tc", "flash_bwd",
                   "flash_bwd_dlbias_tc", "flash_bwd_dlbias")


@pytest.mark.parametrize("name", DROPOUT_SOURCES)
def test_dropout_sources_share_the_hash_header(name):
    """Kernel 7 and kernels 1-4 draw their masks from one copy of the
    counter hash, csrc/dropout_hash.cuh (whose edits rebuild them all);
    none keeps its own mix32."""
    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    assert '#include "dropout_hash.cuh"' in text
    assert "uint32_t mix32(" not in text
    assert "uint32_t mix32(" in (cuda_build.CSRC / "dropout_hash.cuh").read_text()


def test_chip_smoke_planted_hash_swap_finds_its_line():
    """chip_smoke.py's planted fault swaps the dk/dv kernel's hash
    multipliers in a copy of csrc/flash_bwd_tc.cu: the line it rewrites is
    there once, and the swap exchanges the two multipliers."""
    mod = load_chip_smoke()
    text = (cuda_build.CSRC / "flash_bwd_tc.cu").read_text()
    assert text.count(mod.DKV_MULS) == 1 and mod.DKV_MULS_SWAPPED not in text
    swap = mod.DKV_MULS.replace("ROW", "@").replace("COL", "ROW").replace("@", "COL")
    assert swap == mod.DKV_MULS_SWAPPED


def test_chip_smoke_planted_hash_swap_build_is_cached(tmp_path, monkeypatch):
    """The planted fault's library is named after the real flash_bwd_tc
    library (the hash of the source and csrc's headers): once it is there,
    no nvcc starts; a header edit names another library."""
    mod = load_chip_smoke()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(mod.subprocess, "Popen", lambda *a, **k: pytest.fail("nvcc started"))
    real = cuda_build.library_path("flash_bwd_tc")
    lib = real.with_name(real.name.replace("flash_bwd_tc", "flash_bwd_tc_swapped_hash", 1))
    assert lib != real and lib.parent == cuda_build.BUILD_DIR
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")  # built by an earlier run
    assert mod.start_swapped_dkv_build(cuda_build)() == str(lib)
