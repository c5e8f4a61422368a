"""Package-level rules of the PyTorch port: it imports neither JAX nor
the JAX package (nor grpc, protobuf or PyYAML), its entry points default
to the card, and its CPU paths need no CUDA toolkit."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from k8s_dra_driver_gpu_tpu_torch import ops
from k8s_dra_driver_gpu_tpu_torch.models import llama
from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "k8s_dra_driver_gpu_tpu_torch"
# Nor grpc, protobuf ("google") or PyYAML: the chip machine has none of
# them, and the port's kubelet plugin needs only the standard library.
FORBIDDEN = ("jax", "jaxlib", "k8s_dra_driver_gpu_tpu", "grpc", "google",
             "yaml")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {module}"


def test_resolve_device_defaults_to_card():
    if torch.cuda.is_available():
        assert ops.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.resolve_device("cuda:0")
        assert not ops.is_cuda_backend()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            llama.init(llama.LlamaConfig.tiny(), torch.Generator())
    assert ops.resolve_device("cpu") == torch.device("cpu")


def test_cpu_flash_launches_nothing():
    before = pt_flash.flash_attention.launches
    q = torch.randn(1, 16, 4, 16)
    k = v = torch.randn(1, 16, 2, 16)
    out, lse = pt_flash.flash_attention(q, k, v, with_lse=True)
    assert out.shape == q.shape and lse.shape == (1, 4, 16)
    assert pt_flash.flash_attention.launches == before


def test_import_needs_no_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)  # no nvcc on it
    env["PYTHONPATH"] = str(ROOT)
    code = ("import k8s_dra_driver_gpu_tpu_torch.convert, "
            "k8s_dra_driver_gpu_tpu_torch.models.decode, "
            "k8s_dra_driver_gpu_tpu_torch.ops.flash_attention as f, sys; "
            "sys.exit(f._build._loaded != {})")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
