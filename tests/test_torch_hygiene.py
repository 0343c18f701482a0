"""The port stands alone: no JAX and nothing of the JAX package in
src/repro_torch/ or chip_smoke.py, and no library attention call in the port."""
import ast
import os
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
ALL_FILES = PORT_FILES + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py"))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_found():
    assert len(PORT_FILES) >= 10
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", ALL_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imports(tree) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_sdpa_in_port(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {a.name.split(".")[-1] for n in ast.walk(tree)
              if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
    assert "scaled_dot_product_attention" not in names, path


def test_forbidden_rule_catches_jax_and_repro():
    tree = ast.parse("import jax\nfrom repro.models import x\n"
                     "import repro_torch.models\nfrom jax.numpy import y\n")
    assert [n for n in _imports(tree) if _forbidden(n)] == \
        ["jax", "repro.models", "jax.numpy"]


def test_flash_attention_bf16_path_is_hopper_only():
    """K1's bf16 path loads through TMA into an mbarrier ring and multiplies
    with wgmma in warpgroups given registers by setmaxnreg; no mma.sync
    (pre-Hopper tensor-core) code is left in the source or in the header
    its PTX helpers come from."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    assert '#include "hopper.cuh"' in src
    src += (csrc / "hopper.cuh").read_text()
    assert "mma.sync" not in src
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "setmaxnreg.inc", "setmaxnreg.dec", "flash_fwd_bf16_kernel"):
        assert needle in src, needle


def test_flash_attention_bwd_bf16_path_is_hopper_only():
    """K1's backward multiplies in bf16 with wgmma on tiles that TMA brings
    into an mbarrier ring, in warpgroups given registers by setmaxnreg, for
    every head dim; no mma.sync is left in the source; its PTX helpers come
    from the header it shares with the forward."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "flash_attention_bwd.cu").read_text()
    assert "mma.sync" not in src and "mma.sync" not in (csrc / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for needle in ("wgmma_rs<HD>", "wgmma_ss_n64<", "tma_load_3d(", "mbar_wait(",
                   "setmaxnreg.inc", "setmaxnreg.dec", "flash_bwd_dkdv_bf16_kernel",
                   "flash_bwd_dq_bf16_kernel", "flash_bwd_reduce_kernel"):
        assert needle in src, needle
    header = (csrc / "hopper.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait"):
        assert needle in header, needle
    # every head dim the wrapper takes reaches the bf16 path
    for hd in (16, 32, 64, 128, 256):
        assert f"case {hd}:" in src and f"launch_hd<{hd}>" in src
    assert "return launch_bf16<HD>(" in src
    # no float atomics: every call gives the same bits
    assert "atomicAdd" not in src and "red." not in src


def test_ssd_products_are_3xtf32_on_tensor_cores():
    """K2 multiplies on the tensor cores (mma.sync TF32) with each operand
    split into two TF32 values rounded by cvt (3xTF32), and computes C B^T in
    a kernel of its own, once per (b, chunk): its grid has no head axis. No
    scalar f32 FMA product is left. The product lives in ssd_common.cuh,
    which ssd.cu and its backward include."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "ssd.cu").read_text()
    common = (csrc / "ssd_common.cuh").read_text()
    assert '#include "ssd_common.cuh"' in src
    src += common
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rn.tf32.f32" in src
    assert "fmaf(" not in src
    launch = src[src.index("ssd_cb_kernel<<<"):]
    grid = launch[:launch.index(">>>")]
    assert "d.nc" in grid and "d.b" in grid and "d.h" not in grid


def test_ssd_backward_is_3xtf32_without_atomics():
    """K2's backward multiplies with the forward's 3xTF32 product (mma3 of
    ssd_common.cuh), no scalar FMA product, no float atomics (every call
    gives the same bits), and names every kernel ssd_bwd_ (the profiler's
    bucket): eight kernels, none of which sums per-head shares of dB or
    dC."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    src = re.sub(r"//[^\n]*", "", (csrc / "ssd_bwd.cu").read_text())
    assert '#include "ssd_common.cuh"' in src and "mma3(" in src
    assert "fmaf(" not in src and "atomic" not in src and "red." not in src
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert names == ["ssd_bwd_dstate_kernel", "ssd_bwd_state_pass_kernel", "ssd_bwd_dx_kernel",
                     "ssd_bwd_dc_kernel", "ssd_bwd_sum_groups_kernel", "ssd_bwd_dbdc_kernel",
                     "ssd_bwd_dt_kernel", "ssd_bwd_da_kernel"], names
    # no kernel sums the heads' shares of dB and dC any more: P is summed
    # over the heads before it meets B and C
    assert "sum_heads" not in src and "dBh" not in src and "dCh" not in src


def test_rglru_is_one_chained_kernel():
    """K3 is one CUDA kernel and one memset a call: tiles taken from an
    atomic counter (never from blockIdx), the carry handed on through one
    64-bit word with an acquire load and a release store, and every kernel
    named rglru_ (the profiler's bucket)."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "rglru.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)                   # the code, not its notes
    assert src.count("<<<") == 1 and src.count("cudaMemsetAsync(") == 1
    assert "atomicAdd(counter" in src and "blockIdx" not in src
    assert "load(cuda::memory_order_acquire)" in src
    assert "cuda::memory_order_release" in src and "memory_order_relaxed" not in src
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert names and all(name.startswith("rglru_") for name in names), names


def test_rglru_backward_is_one_chained_kernel_without_atomics():
    """K3's backward, in its own source, is one CUDA kernel and one memset a
    call: tiles taken from an atomic counter (never from blockIdx), the
    carry handed on through one 64-bit word with an acquire load and a
    release store, no float atomics (the counter's increment is the only
    atomic read-modify-write), and every kernel named rglru_ (the
    profiler's bucket)."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "rglru_bwd.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)                   # the code, not its notes
    assert src.count("<<<") == 1 and src.count("cudaMemsetAsync(") == 1
    assert src.count("atomicAdd(") == 1 and "atomicAdd(counter, 1u)" in src
    assert not re.search(r"atomic(Sub|Exch|Min|Max|Inc|Dec|CAS|And|Or|Xor)|red\.|fetch_add", src)
    assert "blockIdx" not in src
    assert "load(cuda::memory_order_acquire)" in src
    assert "cuda::memory_order_release" in src and "memory_order_relaxed" not in src
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert names and all(name.startswith("rglru_") for name in names), names


def _device_defaults(tree):
    """(where, default) of every ``device`` parameter with a default and
    every ``--device`` flag of a file."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args.posonlyargs + node.args.args
            pairs = list(zip(args[len(args) - len(node.args.defaults):], node.args.defaults))
            pairs += [(a, d) for a, d in zip(node.args.kwonlyargs, node.args.kw_defaults) if d]
            for arg, default in pairs:
                if arg.arg == "device":
                    yield f"{node.name}(device=)", ast.literal_eval(default)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
              and node.args and getattr(node.args[0], "value", None) == "--device"):
            for kw in node.keywords:
                if kw.arg == "default":
                    yield "--device", ast.literal_eval(kw.value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_device_defaults_are_the_card(path):
    """Every ``device`` parameter and ``--device`` flag of the port defaults
    to ``None`` (resolved to cuda) or to ``cuda``: the CPU only when asked."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(w, d) for w, d in _device_defaults(tree) if d not in (None, "cuda")]
    assert not bad, f"{path}: {bad}"


def test_device_default_rule_catches_cpu():
    tree = ast.parse("def f(x, device='cpu'):\n    pass\n"
                     "def g(*, device=None):\n    pass\n"
                     "ap.add_argument('--device', default='cpu')\n")
    assert sorted(_device_defaults(tree)) == [("--device", "cpu"), ("f(device=)", "cpu"),
                                              ("g(device=)", None)]


TRAIN_MODULES = ("repro_torch.train.optimizer", "repro_torch.train.data",
                 "repro_torch.train.train_step", "repro_torch.train.checkpoint",
                 "repro_torch.train.fault", "repro_torch.launch.train",
                 "repro_torch.kernels.ops", "repro_torch.configs.base")


@pytest.mark.parametrize("module", TRAIN_MODULES)
def test_training_modules_import_without_a_gpu_or_nvcc(module, tmp_path):
    """Kernel sources build only at first use, so each module of the training
    path imports on a machine with no GPU and no nvcc, and imports neither
    JAX nor the JAX package while doing so."""
    import subprocess
    import sys
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
