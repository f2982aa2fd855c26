"""The port's kernel build (k8s_operator_libs_tpu_torch/_build.py) on the
CPU: the source digest that names a library, the ``ptxas -v`` and SASS
parsers, and the build's plumbing through stand-ins for ``nvcc`` and
``cuobjdump``.  No jax import, no card, no CUDA toolkit.
"""

import sys

import pytest

from k8s_operator_libs_tpu_torch import _build

FWD = "_ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiif"
DQ32 = "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi128EEEvPKT_S4_S4_S4_PKfS6_PS2_iiif"

#: ptxas -v as nvcc prints it for sm_90a (one entry without static shared
#: memory and with a coded note, one with spills, and a non-entry function
#: in between)
PTXAS = f"""\
ptxas info    : 11 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls in the function '{FWD}'
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '{DQ32}' for 'sm_90a'
ptxas info    : Function properties for {DQ32}
    824 bytes stack frame, 820 bytes spill stores, 3176 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16384 bytes smem, 400 bytes cmem[0]
"""

#: cuobjdump --dump-sass, cut to a few instructions per function
SASS = f"""\

Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : {FWD}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a70*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0a80*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0b00*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\t..........

\t\tFunction : {DQ32}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   FFMA R2, R3, R4, R2 ;
"""


@pytest.mark.parametrize(
    "symbol,name",
    [
        (FWD, "flash_fwd_tc_kernel<64>"),
        (DQ32, "flash_bwd_dq_kernel<float, 128>"),
        ("_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li16EEEvPKT_", "flash_bwd_dkv_kernel<__nv_bfloat16, 16>"),
        ("_ZN12_GLOBAL__N_123flash_bwd_dkv_tc_kernelILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiif", "flash_bwd_dkv_tc_kernel<64>"),
        ("_Z7kernel2ILin3ELb1EEvv", "kernel2<-3, 1>"),
        ("_Z3addPfS_", "add"),
        ("flash_fwd", "flash_fwd"),
    ],
)
def test_demangle_names_kernel_templates(symbol, name):
    assert _build.demangle(symbol) == name


def test_parse_ptxas_reads_registers_shared_memory_spills_and_notes_per_entry():
    report = _build.parse_ptxas(PTXAS)
    assert report == {
        "flash_fwd_tc_kernel<64>": {
            "registers": 120, "smem_bytes": 0, "stack_bytes": 0,
            "spill_stores": 0, "spill_loads": 0,
            "notes": [
                "C7515 Potential Performance Loss: wgmma.mma_async instructions are "
                "serialized due to the presence of Extern calls"
            ],
        },
        "flash_bwd_dq_kernel<float, 128>": {
            "registers": 255, "smem_bytes": 16384, "stack_bytes": 824,
            "spill_stores": 820, "spill_loads": 3176,
        },
    }


def test_parse_sass_counts_tensor_core_instructions_per_function():
    counts = _build.parse_sass(SASS)
    assert counts == {
        "flash_fwd_tc_kernel<64>": {"HGMMA": 2, "HMMA": 0},
        "flash_bwd_dq_kernel<float, 128>": {"HGMMA": 0, "HMMA": 1},
    }


def _sources(tmp_path):
    csrc = tmp_path / "csrc"
    (csrc / "detail").mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "a.cuh"\n')
    (csrc / "a.cuh").write_text("// a\n")
    (csrc / "detail" / "b.h").write_text("// b\n")
    return csrc


def test_digest_follows_every_header_under_csrc(tmp_path):
    csrc = _sources(tmp_path)
    first = _build.source_digest("k", csrc)
    assert _build.source_digest("k", csrc) == first
    (csrc / "a.cuh").write_text("// a, edited\n")
    second = _build.source_digest("k", csrc)
    assert second != first
    (csrc / "detail" / "b.h").write_text("// b, edited\n")
    third = _build.source_digest("k", csrc)
    assert third not in (first, second)
    (csrc / "c.cuh").write_text("// a new header\n")
    assert _build.source_digest("k", csrc) != third


def test_digest_ignores_what_the_build_does_not_read(tmp_path):
    csrc = _sources(tmp_path)
    digest = _build.source_digest("k", csrc)
    (csrc / "notes.txt").write_text("not a source\n")
    (csrc / "other.cu").write_text("// another library's source\n")
    assert _build.source_digest("k", csrc) == digest


def test_digest_follows_the_flags(tmp_path, monkeypatch):
    csrc = _sources(tmp_path)
    digest = _build.source_digest("k", csrc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.source_digest("k", csrc) != digest


def test_the_shipped_library_name_carries_the_digest():
    digest = _build.source_digest("flash_attention")
    assert len(digest) == 16
    assert _build.library_path("flash_attention").name == f"libflash_attention-{digest}.so"


def _fake_toolkit(tmp_path, monkeypatch):
    """A CUDA_HOME whose nvcc writes its -o target and prints PTXAS, and
    whose cuobjdump prints SASS."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'not a real library')\n"
        f"sys.stderr.write({PTXAS!r})\n"
    )
    cuobjdump = bin_dir / "cuobjdump"
    cuobjdump.write_text(f"#!{sys.executable}\nimport sys\nsys.stdout.write({SASS!r})\n")
    for tool in (nvcc, cuobjdump):
        tool.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


def test_build_keeps_the_ptxas_report_and_reuses_the_library(tmp_path, monkeypatch):
    _fake_toolkit(tmp_path, monkeypatch)
    assert _build.ptxas_report("flash_attention") == {}  # nothing built yet
    lib = _build.build("flash_attention")
    assert lib == _build.library_path("flash_attention") and lib.exists()
    assert _build.build_seconds["flash_attention"] > 0.0
    assert _build.ptxas_report("flash_attention") == _build.parse_ptxas(PTXAS)
    assert _build.build("flash_attention") == lib  # cached: not rebuilt
    assert _build.build_seconds["flash_attention"] == 0.0
    assert _build.sass_counts("flash_attention") == _build.parse_sass(SASS)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    _fake_toolkit(tmp_path, monkeypatch)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nsys.stderr.write('bad asm')\nsys.exit(2)\n")
    with pytest.raises(RuntimeError, match="bad asm"):
        _build.build("flash_attention")
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_each_shipped_library_name_carries_its_own_digest(name):
    digest = _build.source_digest(name)
    assert _build.library_path(name).name == f"lib{name}-{digest}.so"
    assert (_build.CSRC / f"{name}.cu").exists()


def test_the_int8_entry_point_takes_five_pointers_four_ints_and_the_stream():
    """x, q, s, bias, y; M, K, N, is_bf16; then the bf16 launch plan
    (int8_plan's k_warps and cluster), two more ints; the stream."""
    P, I = _build.P, _build.I
    assert _build.SIGNATURES["int8_matmul"] == {
        "int8_linear": (P, P, P, P, P, I, I, I, I, I, I, P)
    }
    assert _build.source_digest("int8_matmul") != _build.source_digest("flash_attention")


def test_editing_one_source_leaves_the_other_s_digest(tmp_path):
    csrc = _sources(tmp_path)
    (csrc / "other.cu").write_text("// another library\n")
    k, other = _build.source_digest("k", csrc), _build.source_digest("other", csrc)
    assert k != other
    (csrc / "other.cu").write_text("// another library, edited\n")
    assert _build.source_digest("k", csrc) == k
    assert _build.source_digest("other", csrc) != other


def test_build_all_builds_every_library_side_by_side(tmp_path, monkeypatch):
    _fake_toolkit(tmp_path, monkeypatch)
    built = _build.build_all()
    assert set(built) == set(_build.SIGNATURES)
    for name, lib in built.items():
        assert lib == _build.library_path(name) and lib.exists()
        assert _build.build_seconds[name] > 0.0
    assert _build.build_all() == built  # cached
    assert set(_build.build_seconds.values()) == {0.0}


def test_build_all_raises_a_failed_build(tmp_path, monkeypatch):
    _fake_toolkit(tmp_path, monkeypatch)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nsys.stderr.write('bad int8')\nsys.exit(2)\n")
    with pytest.raises(RuntimeError, match="bad int8"):
        _build.build_all(["int8_matmul"])
