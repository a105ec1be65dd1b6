"""The port's traffic models (``repro_torch.core.traffic``) against the
reference's (``repro.core.traffic``): every function, over the shape
grids of ``tests/test_traffic.py``, equal exactly (integers, and floats
from the same arithmetic); the peak table's deviations apart.
"""

import dataclasses

import pytest

from repro.core import traffic as R
from repro_torch.core import traffic as T
from repro_torch.kernels import backends

SHAPES = [(4096, 4096, 4096), (256, 256, 128), (1, 2048, 8192),
          (4096, 2048, 8192), (100, 77, 1000)]
P = [3, 4, 6]


def _both(name, *args, **kw):
    """fn(*args) in both modules, GemmShape tuples turned into each
    module's own GemmShape."""
    def conv(mod, x):
        return mod.GemmShape(*x) if isinstance(x, tuple) and len(x) == 3 \
            and all(isinstance(v, int) for v in x) else x
    got = getattr(T, name)(*(conv(T, a) for a in args),
                           **{k: conv(T, v) for k, v in kw.items()})
    ref = getattr(R, name)(*(conv(R, a) for a in args),
                           **{k: conv(R, v) for k, v in kw.items()})
    return got, ref


SHAPE_P_FNS = ["scheme1_naive_bytes", "scheme1_fused_bytes", "scheme1_flops",
               "scheme1_workspace_bytes", "scheme2_workspace_bytes"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", SHAPE_P_FNS)
def test_shape_p_models_equal_reference(name, shape):
    for p in P:
        got, ref = _both(name, shape, p)
        assert got == ref and type(got) is type(ref), (name, shape, p)
    if name in ("scheme1_naive_bytes", "scheme1_fused_bytes"):
        assert _both(name, shape, 4, out_bytes=4)[0] == \
            _both(name, shape, 4, out_bytes=4)[1]
    if name == "scheme2_workspace_bytes":
        got, ref = _both(name, shape, 6, complex_inputs=True)
        assert got == ref


@pytest.mark.parametrize("shape", SHAPES)
def test_shape_models_equal_reference(shape):
    for name in ("scheme2_naive_bytes_per_modulus",
                 "scheme2_fused_bytes_per_modulus",
                 "scheme2_3m_naive_bytes_per_modulus",
                 "scheme2_3m_fused_bytes_per_modulus", "int8_gemm_flops",
                 "guard_verify_bytes_fused", "guard_verify_bytes_unfused",
                 "guard_verify_flops"):
        got, ref = _both(name, shape)
        assert got == ref, name
    for p in (4, 6, 16):
        for c3 in (False, True):
            got, ref = _both("scheme2_flops", shape, p, complex_3m=c3)
            assert got == ref
    for probes in (1, 4):
        for name in ("guard_verify_bytes_fused", "guard_verify_flops"):
            assert _both(name, shape, probes)[0] == \
                _both(name, shape, probes)[1]
        got, ref = _both("guard_verify_bytes_unfused", shape, probes, 8)
        assert got == ref


@pytest.mark.parametrize("p", P)
def test_decomposition_models_equal_reference(p):
    for elems in (1, 4096 * 4096, 12345):
        for uses in (1, 3):
            for name in ("scheme1_decomp_xla_bytes",
                         "scheme1_decomp_prologue_bytes",
                         "scheme1_decomp_prepared_bytes"):
                got, ref = _both(name, elems, p, uses)
                assert got == ref, name
    for uses in (1, 3, 5):
        assert _both("scheme1_decomp_reduction", p, uses)[0] == \
            _both("scheme1_decomp_reduction", p, uses)[1]
    for shape in SHAPES:
        for c3 in (False, True):
            for uses in (1, 3):
                for name in ("scheme2_decomp_xla_bytes",
                             "scheme2_decomp_prologue_bytes"):
                    got, ref = _both(name, shape, p, uses, c3)
                    assert got == ref, name
                got, ref = _both("scheme2_decomp_prepared_bytes", shape, p,
                                 uses, 2, c3)
                assert got == ref
        got, ref = _both("scheme2_decomp_reduction", shape, p, 3)
        assert got == ref


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 8192), (4096, 49664)])
def test_decode_models_equal_reference(k, n):
    for p in P:
        for batch in (1, 4, 64):
            for path in ("prepared", "prologue", "xla"):
                for fn in ("scheme1_decode_step_bytes",
                           "scheme1_decode_per_token_bytes"):
                    got, ref = _both(fn, k, n, batch, p, path, 2)
                    assert got == ref
                got, ref = _both("decode_batch_amortization", k, n, p, batch,
                                 path)
                assert got == ref
    with pytest.raises(ValueError, match="unknown decode weight path"):
        T.scheme1_decode_step_bytes(k, n, 1, 4, "bogus")


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_models_equal_reference(shape):
    for p in P:
        for batch in (1, 8, 64):
            for fn in ("scheme1_batched_bytes", "scheme2_batched_bytes"):
                got, ref = _both(fn, shape, p, batch, 8)
                assert got == ref
            for scheme in ("ozaki1", "ozaki2"):
                got, ref = _both("batched_decomp_reduction", shape, p, batch,
                                 scheme)
                assert got == ref


@pytest.mark.parametrize("mesh", [None, {"data": 4, "model": 4},
                                  (("pod", 2), ("data", 8), ("model", 4)),
                                  {"model": 1}])
@pytest.mark.parametrize("partition", ["column", "row", "batch"])
def test_sharded_traffic_equals_reference(mesh, partition):
    for shape in [(4096, 4096, 4096), (256, 256, 128)]:
        for scheme, p in (("ozaki1", 4), ("ozaki2", 6)):
            for c3 in (False, True):
                got, ref = _both("sharded_gemm_traffic", shape, p, mesh,
                                 partition, scheme=scheme, out_bytes=4,
                                 complex_3m=c3)
                assert got == ref
    for n_dev in (1, 2, 8):
        for fn in ("ring_all_reduce_bytes", "all_gather_bytes",
                   "reduce_scatter_bytes"):
            assert _both(fn, 1 << 20, n_dev)[0] == _both(fn, 1 << 20,
                                                         n_dev)[1]
    with pytest.raises(ValueError, match="unknown partition"):
        T.sharded_gemm_traffic(T.GemmShape(8, 8, 8), 4, mesh, "diagonal")
    with pytest.raises(ValueError, match="no sharded traffic model"):
        T.sharded_gemm_traffic(T.GemmShape(8, 8, 8), 4, mesh, partition,
                               scheme="native")


@pytest.mark.parametrize("scheme,p", [("ozaki1", 4), ("ozaki2", 6)])
def test_overhead_models_equal_reference(scheme, p):
    """Against the same peak (the reference's default is a TPU part, the
    port's the H100: each is handed the H100 here)."""
    tp, rp = T.BACKEND_PEAKS["gpu"]["h100"], R.BACKEND_PEAKS["gpu"]["h100"]
    for shape in SHAPES:
        for fn, kw in (("guard_overhead_model", {"probes": 2}),
                       ("telemetry_overhead_model", {})):
            got = getattr(T, fn)(T.GemmShape(*shape), p, scheme, peak=tp,
                                 **kw)
            ref = getattr(R, fn)(R.GemmShape(*shape), p, scheme, peak=rp,
                                 **kw)
            assert got == ref
    assert T.guard_overhead_model(T.GemmShape(64, 64, 64), p, scheme) == \
        T.guard_overhead_model(T.GemmShape(64, 64, 64), p, scheme, peak=tp)
    assert T.telemetry_counter_bytes() == R.telemetry_counter_bytes()
    assert T.telemetry_counter_bytes(3, 2, 8) == R.telemetry_counter_bytes(
        3, 2, 8)


def test_intensity_helpers_equal_reference():
    for p in range(1, 17):
        assert T.scheme1_intensity_gain(p) == R.scheme1_intensity_gain(p)
    for flops, nbytes in ((10, 3), (0, 0), (1 << 40, 12345)):
        assert T.arithmetic_intensity(flops, nbytes) == \
            R.arithmetic_intensity(flops, nbytes)


def test_peak_table_is_the_reference_gpu_table_without_a_tpu():
    """The 'gpu' entries are the reference's (H100 SXM and B200, NVIDIA's
    dense data-sheet rates); the port's backend names and both backends'
    peak_key resolve to them; no TPU entry, and an unknown backend raises
    instead of falling back to one."""
    assert {k: dataclasses.asdict(v) for k, v in T.BACKEND_PEAKS["gpu"]
            .items()} == {k: dataclasses.asdict(v)
                          for k, v in R.BACKEND_PEAKS["gpu"].items()}
    h100 = T.BACKEND_PEAKS["gpu"]["h100"]
    assert (h100.int8_ops, h100.flops, h100.hbm_bw, h100.fp64_flops) == (
        1979e12, 989e12, 3350e9, 67e12)
    assert "tpu" not in T.BACKEND_PEAKS and "xla" not in T.BACKEND_PEAKS
    for name in ("gpu", "cuda", "torch", "gpu-h100"):
        assert T.backend_peaks(name) is T.BACKEND_PEAKS["gpu"]
    for name in backends.available_backends():
        key = backends.get_backend(name).capabilities.peak_key
        assert key == "gpu" and T.backend_peaks(key) is T.BACKEND_PEAKS["gpu"]
    with pytest.raises(KeyError, match="no peak table"):
        T.backend_peaks("tpu")
