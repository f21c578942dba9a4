"""The port stands alone: importing every module of cockroach_tpu_torch,
and chip_smoke.py, loads neither JAX, nor pyarrow, nor the JAX package
(chip_smoke.py imports the rest in main()); and an entry point
given no device raises when there is no CUDA device."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_pyarrow_or_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import cockroach_tpu_torch
        names = ["cockroach_tpu_torch"]
        for m in pkgutil.walk_packages(cockroach_tpu_torch.__path__,
                                       "cockroach_tpu_torch."):
            names.append(m.name)
        for n in names + ["chip_smoke"]:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                            "cockroach_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 15, r.stdout


def test_collect_without_cuda_or_device_raises(monkeypatch):
    from cockroach_tpu_torch.exec import collect
    from cockroach_tpu_torch.workload.tpch import TPCH
    from cockroach_tpu_torch.workload.tpch_queries import q1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flow = q1(TPCH(sf=0.001), 1 << 12)
    with pytest.raises(RuntimeError, match="CUDA"):
        collect(flow)


def test_numpy_to_batch_without_cuda_or_device_raises(monkeypatch):
    import numpy as np

    from cockroach_tpu_torch.coldata.batch import INT, Field, Schema
    from cockroach_tpu_torch.coldata.arrow import numpy_to_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        numpy_to_batch({"a": np.arange(3)}, Schema([Field("a", INT)]))


def test_tf32_is_off():
    import cockroach_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
