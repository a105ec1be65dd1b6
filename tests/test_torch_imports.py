"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
loads jax or the reference package; its entry points run on CUDA unless
asked for the CPU, and raise without a card."""

import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.serving import ContinuousEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert {"repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.kernels.prepared",
            "repro_torch.kernels.decompose",
            "repro_torch.kernels.flash_attn",
            "repro_torch.kernels.matmul_int8"} <= set(mods) and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_without_jax_or_repro():
    code = (
        "import runpy, sys\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    arch = configs.get_smoke_config("olmo-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(arch.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(arch, max_seq=16)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1", "--gen", "1"])
    from repro_torch.launch import steps, train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.init_state(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    toks = serve.main(["--smoke", "--requests", "2", "--prompt-len", "5",
                       "--gen", "2", "--gemm", "ozaki1-p4",
                       "--device", "cpu"])
    assert len(toks) == 2 and all(len(x) == 2 for x in toks)
