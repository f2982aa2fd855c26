"""Rules of the PyTorch port, enforced.

* The port (k8s_operator_libs_tpu_torch/) and chip_smoke.py import no jax,
  flax, optax or orbax and nothing of the JAX package — by an AST scan and
  in a fresh interpreter.
* Its entry points default to the card and raise without one; the kernel
  loader raises without nvcc; a CUDA tensor never falls back to a plain
  version.
* Its measurement surface (tpu/smoke.py and the hack runners) turns no
  failure into a record entry.
"""

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from k8s_operator_libs_tpu_torch import _build, graft_entry
from k8s_operator_libs_tpu_torch.examples import generate as gen_example
from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
from k8s_operator_libs_tpu_torch.tpu import smoke
from k8s_operator_libs_tpu_torch.tpu import workload as wl

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_operator_libs_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "k8s_operator_libs_tpu")


def _forbidden(name: str) -> bool:
    # k8s_operator_libs_tpu_torch starts with k8s_operator_libs_tpu: match
    # the name or a dotted child, never a prefix
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_name_match_respects_the_prefix():
    assert _forbidden("k8s_operator_libs_tpu") and _forbidden("k8s_operator_libs_tpu.tpu")
    assert _forbidden("jax.numpy") and _forbidden("orbax.checkpoint")
    assert not _forbidden("k8s_operator_libs_tpu_torch") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_whole_port_loads_neither_jax_nor_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
        "print(len(bad), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []"


def test_flash_attention_module_has_no_try_to_fall_back_on():
    tree = ast.parse((PORT / "tpu" / "flash_attention.py").read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = wl.ModelConfig(n_layers=1, d_model=32, d_ff=64, max_seq_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        wl.CheckpointingTrainer(cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        wl.create_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.run_smoke(str(tmp_path), config=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.run_stage("touch")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        gen_example.main(["--steps", "0"])


def test_tinylm_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = wl.ModelConfig(n_layers=1, d_model=32, d_ff=64, max_seq_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wl.TinyLM(cfg)
    assert sum(p.numel() for p in wl.TinyLM(cfg, device="cpu").parameters()) > 0


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)  # nothing built there
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("flash_attention")
    # the CUDA wrapper itself raises: it never runs the plain version
    qf = torch.zeros(2, 16, 16)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa._flash_forward_cuda(qf, qf, qf, 1, True)


class _FakeCuda:
    """Stands in for a CUDA tensor: only ``is_cuda`` is read by the router."""

    is_cuda = True


def test_a_cuda_tensor_never_reaches_the_plain_version():
    calls = []

    def kernel(*args):
        calls.append("kernel")
        raise RuntimeError("launch refused")

    def plain(*args):
        calls.append("plain")

    with pytest.raises(RuntimeError, match="launch refused"):
        fa._route(kernel, plain, _FakeCuda(), 1, True)
    assert calls == ["kernel"]  # the error propagates; no fallback ran
    with pytest.raises(ValueError, match="no kernel"):
        fa._route(kernel, plain, torch.zeros(1, device="meta"), 1, True)


def test_kernel_input_checks_reject_what_the_kernels_do_not_take():
    q = torch.zeros(4, 16, 48)  # head_dim 48 is not compiled
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_kernel_inputs("t", q, q, q, 1)
    q = torch.zeros(4, 16, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa._check_kernel_inputs("t", q, q, q, 1)
    q = torch.zeros(4, 16, 64)
    with pytest.raises(ValueError, match="k/v"):
        fa._check_kernel_inputs("t", q, torch.zeros(3, 16, 64), torch.zeros(3, 16, 64), 2)
    with pytest.raises(ValueError, match="share a dtype"):
        fa._check_kernel_inputs("t", q, q, q.bfloat16(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_kernel_inputs("t", q, q, q.transpose(0, 1).contiguous().transpose(0, 1), 1)
    fa._check_kernel_inputs("t", q, q, q, 1, q, torch.zeros(4, 16), torch.zeros(4, 16))
    # the bf16 tensor-core kernels copy 16-byte chunks: a q starting 2 bytes
    # into its storage is refused
    flat = torch.zeros(4 * 16 * 64 + 1, dtype=torch.bfloat16)
    shifted, aligned = flat[1:].view(4, 16, 64), flat[:-1].view(4, 16, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_kernel_inputs("t", shifted, aligned, aligned, 1)
    fa._check_kernel_inputs("t", aligned, aligned, aligned, 1)


CU_SOURCE = PORT / "csrc" / "flash_attention.cu"


def _cu_function(name: str) -> str:
    """The text of C++ function *name* in the kernels' source: from its
    name to the closing brace at the start of a line."""
    source = CU_SOURCE.read_text()
    m = re.search(rf"\b{name}\((?:.|\n)*?\n\}}\n", source)
    assert m is not None, f"{name} not in {CU_SOURCE.name}"
    return m.group()


def test_bf16_routes_to_tensor_core_kernels_and_fp32_to_scalar_ones():
    for entry, kernels in fa.DEVICE_KERNELS.items():
        assert "_tc_" in kernels[torch.bfloat16], entry
        assert "_tc_" not in kernels[torch.float32], entry
    assert fa.DEVICE_KERNELS["flash_bwd_dkv"] == {
        torch.bfloat16: "flash_bwd_dkv_tc_kernel", torch.float32: "flash_bwd_dkv_kernel",
    }


def test_every_device_kernel_is_a_global_function_of_the_source():
    source = CU_SOURCE.read_text()
    defined = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", source
    ))
    named = {k for kernels in fa.DEVICE_KERNELS.values() for k in kernels.values()}
    assert named <= defined, named - defined
    assert "flash_bwd_dkv_tc_kernel" in defined


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("entry", sorted(fa.DEVICE_KERNELS))
def test_the_c_entry_point_launches_the_device_kernel_named_for_its_dtype(entry, dtype):
    """C entry point -> FLASH_DISPATCH(route_*) -> the route's bf16 or fp32
    branch -> launch_* -> the kernel it launches, read from the source."""
    route = re.search(r"FLASH_DISPATCH\((\w+)", _cu_function(entry)).group(1)
    bf16_branch, fp32_branch = _cu_function(route).split("} else {")
    branch = bf16_branch if dtype == torch.bfloat16 else fp32_branch
    launcher = re.search(r"(launch_\w+)<", branch).group(1)
    kernel = re.search(r"(\w+)<[^<>;]*>\s*<<<", _cu_function(launcher)).group(1)
    assert kernel == fa.DEVICE_KERNELS[entry][dtype]


def test_launch_counts_start_at_zero_and_reset():
    fa.launch_counts["flash_fwd"] += 3
    fa.reset_launch_counts()
    assert fa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    # the plain versions on the CPU never count
    q = torch.randn(1, 32, 2, 16)
    fa.flash_attention(q, q, q, True, 32, 32)
    assert set(fa.launch_counts.values()) == {0}


def test_the_scans_see_the_serving_modules():
    scanned = {p.relative_to(PORT).as_posix() for p in _sources() if PORT in p.parents}
    assert {"tpu/quantize.py", "tpu/workload.py", "convert.py"} <= scanned
    assert {
        "obs/tracing.py", "graft_entry.py", "examples/generate.py",
        "hack/gpu_smoke.py", "hack/gpu_stage.py",
    } <= scanned


#: The one exception handler the measurement surface keeps: gpu_stage
#: reports a stage's timeout as that stage's outcome, and then exits
#: non-zero (tests/test_torch_entry_points.py).
MEASUREMENT_HANDLERS = {"hack/gpu_stage.py": ["subprocess.TimeoutExpired"]}


@pytest.mark.parametrize("rel", ["tpu/smoke.py", "hack/gpu_smoke.py", "hack/gpu_stage.py"])
def test_the_measurement_surface_turns_no_failure_into_a_record_entry(rel):
    """Unlike the JAX smoke module's per-section ``{"error": ...}``
    entries, a failing section raises: a run on the card cannot exit 0
    around a caught failure."""
    tree = ast.parse((PORT / rel).read_text())
    handlers = [
        ast.unparse(node.type) if node.type is not None else "bare"
        for node in ast.walk(tree) if isinstance(node, ast.ExceptHandler)
    ]
    assert handlers == MEASUREMENT_HANDLERS.get(rel, [])


def test_quantize_module_has_no_try_to_fall_back_on():
    tree = ast.parse((PORT / "tpu" / "quantize.py").read_text())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_a_cuda_tensor_never_reaches_the_int8_plain_version(monkeypatch):
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    calls = []

    def kernel(*args):
        calls.append("kernel")
        raise RuntimeError("launch refused")

    monkeypatch.setattr(qz, "_int8_linear_cuda", kernel)
    monkeypatch.setattr(qz, "int8_linear_plain", lambda *a: calls.append("plain"))
    with pytest.raises(RuntimeError, match="launch refused"):
        qz.int8_linear(_FakeCuda(), None, None)
    assert calls == ["kernel"]
    with pytest.raises(ValueError, match="no kernel"):
        qz.int8_linear(torch.zeros(1, device="meta"), None, None)


def test_the_int8_wrapper_raises_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present")
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    x, q, s = torch.zeros(2, 16), torch.zeros(4, 16, dtype=torch.int8), torch.ones(4)
    with pytest.raises(RuntimeError, match="nvcc"):
        qz._int8_linear_cuda(x, q, s)


def test_the_int8_entry_point_launches_its_kernel_for_both_types():
    """fp32 on the CUDA-core kernel, bf16 on the tensor-core kernel,
    launched in clusters; either launch's error is returned."""
    source = (PORT / "csrc" / "int8_matmul.cu").read_text()
    for kernel in ("int8_linear_kernel", "int8_linear_tc_kernel"):
        assert re.search(rf"__global__\s+void\s+__launch_bounds__\([^)]*\)\s+{kernel}\(", source)
    entry = re.search(r"int int8_linear\((?:.|\n)*?\n\}\n", source).group()
    assert re.findall(r"(\w+)<(\w+)><<<", entry) == [("int8_linear_kernel", "float")]
    assert re.findall(r"cudaLaunchKernelEx\(\s*&config,\s*(\w+)", entry) == ["int8_linear_tc_kernel"]
    assert "cudaLaunchAttributeClusterDimension" in entry
    assert entry.count("cudaGetLastError") == 2


def test_generate_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = wl.ModelConfig(n_layers=1, d_model=32, d_ff=64, max_seq_len=16)
    model = wl.TinyLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        wl.generate(cfg, model, torch.zeros(1, 2, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        wl.quantized_model(cfg, {})
