"""The four examples on the port's surface (``examples/*_torch.py``) on the
CPU at smoke size: each runs, and the numbers it prints agree with the
reference's functions on the same inputs (the effective bits of
``quickstart_torch`` within 0.1 bit of ``repro.einsum``'s, the planner's
choices equal).
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
from _torch_util import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_bits_equal_reference(one_torch_thread):
    n = 64
    out = _example("quickstart_torch").main(["--n", str(n), "--device",
                                             "cpu"])
    rng = np.random.default_rng(0)
    a = ((rng.random((n, n)) - 0.5) * np.exp(4 * rng.standard_normal((n, n)))
         ).astype(np.float32)
    b = ((rng.random((n, n)) - 0.5) * np.exp(4 * rng.standard_normal((n, n)))
         ).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)

    def bits(c):
        return -np.log2(np.abs(np.asarray(c, np.float64) - ref).max()
                        / np.abs(ref).max())

    for spec in ("ozaki1-p2", "ozaki1-p3", "ozaki1-p4", "ozaki2-m8",
                 "ozaki2-m12"):
        want = bits(repro.einsum("ij,jk->ik", jnp.asarray(a), jnp.asarray(b),
                                 precision=spec))
        assert abs(out[spec] - want) <= 0.1, (spec, out[spec], want)
    assert abs(out["ozaki1-p4@cuda"] - out["ozaki1-p4"]) <= 0.1
    for target in (16, 22, 40):
        assert out[f"bits={target}"] == repro.precision(
            f"bits={target}:k{n}").to_spec()
    assert out["scores"] > 20 and out["native"] > 20


def test_scientific_dgemm_bits(one_torch_thread):
    """float64 operands on the port's Scheme-II route: more moduli, more
    bits, within 0.5 bit of the reference's scheme2.matmul (float64 in
    jax.enable_x64), and the card's figures in the text."""
    from repro.core import scheme2
    from repro.core.precision import EmulationConfig
    mod = _example("scientific_dgemm_torch")
    out = mod.main(["--n", "64", "--device", "cpu"])
    assert out["native f64"] > 50
    assert out["Ozaki-II p=9"] < out["Ozaki-II p=12"] < out["Ozaki-II p=15"]
    rng = np.random.default_rng(7)
    a = (rng.random((64, 64)) - 0.5) * np.exp(4.0 * rng.standard_normal(
        (64, 64)))
    b = (rng.random((64, 64)) - 0.5) * np.exp(4.0 * rng.standard_normal(
        (64, 64)))
    ref = a.astype(np.longdouble) @ b.astype(np.longdouble)
    with jax.enable_x64(True):
        for p in (9, 12, 15):
            c = np.asarray(scheme2.matmul(
                jnp.asarray(a), jnp.asarray(b),
                EmulationConfig(scheme="ozaki2", p=p), jnp.float64))
            want = float(-np.log2(np.abs(c.astype(np.longdouble) - ref).max()
                                  / np.abs(ref).max()))
            assert abs(out[f"Ozaki-II p={p}"] - want) <= 0.5, (p, want)
    text = Path(mod.__file__).read_text()
    assert "H100" in text and "TPU" not in text


@pytest.mark.parametrize("int8_cache", [False, True])
def test_serve_lm_example(one_torch_thread, int8_cache):
    argv = ["--arch", "olmo-1b", "--requests", "2", "--prompt-len", "8",
            "--gen", "4", "--gemm", "ozaki1-p4", "--device", "cpu"]
    toks = _example("serve_lm_torch").main(
        argv + (["--int8-cache"] if int8_cache else []))
    assert toks.shape == (2, 4) and toks.dtype.kind == "i"
    assert ((0 <= toks) & (toks < 500)).all()


def test_train_example_runs_and_resumes(one_torch_thread, tmp_path):
    """Three steps under ozaki1-p3 in a temporary checkpoint directory by
    default; with --ckpt-dir a second run resumes where the first
    stopped (``--steps`` counts the steps of this run) and its step
    matches the uninterrupted run's."""
    mod = _example("train_emulated_lm_torch")
    argv = ["--small", "--batch", "2", "--seq", "16", "--device", "cpu"]
    log = mod.main(argv + ["--steps", "3"])
    assert len(log) == 3 and all(math.isfinite(float(r["loss"]))
                                 for r in log)
    first = mod.main(argv + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert len(first) == 2 and any(tmp_path.iterdir())
    resumed = mod.main(argv + ["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in resumed] == [2]
    assert float(resumed[0]["loss"]) == pytest.approx(float(log[2]["loss"]),
                                                      rel=1e-4)
