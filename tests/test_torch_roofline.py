"""The port's measurement layer against the reference's: the roofline
projections (``repro_torch.utils.roofline``), the abstract state on the
meta device (``launch.steps.abstract_*``), the model-FLOP counts,
``analyze_step`` (one eager step counted) against ``analyze_hlo`` (the
reference's compiled HLO walked), ``utils.perf_probe``'s attribution of a
profiled step and ``utils.render_tables``.

The projections read the H100's peaks where the reference reads a TPU's:
the reference module's constants are patched to the port's values for
the comparisons (nothing under ``src/repro`` changes).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import one_torch_thread  # noqa: F401
from repro import configs as rconfigs
from repro.launch import steps as RS
from repro.models import model as RM
from repro.utils import render_tables as RT
from repro.utils import roofline as RR
from repro_torch import api, configs as tconfigs, telemetry
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models.common import GemmPolicy
from repro_torch.telemetry import record as trecord
from repro_torch.utils import perf_probe as TP
from repro_torch.utils import render_tables as TT
from repro_torch.utils import roofline as TR
from repro_torch.utils.tree import tree_flatten, tree_leaves


@pytest.fixture
def port_peaks(monkeypatch):
    """The reference's roofline constants set to the port's (H100, NVLink)."""
    monkeypatch.setattr(RR, "PEAK_FLOPS", TR.PEAK_FLOPS)
    monkeypatch.setattr(RR, "PEAK_INT8_OPS", TR.PEAK_INT8_OPS)
    monkeypatch.setattr(RR, "HBM_BW", TR.HBM_BW)
    monkeypatch.setattr(RR, "ICI_BW", TR.NVLINK_BW)


def test_constants_are_the_h100s():
    """989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s HBM (the port's peak
    table) and NVLink 4 at 450 GB/s each way; no TPU figure anywhere."""
    assert (TR.PEAK_FLOPS, TR.PEAK_INT8_OPS, TR.HBM_BW, TR.NVLINK_BW) == (
        989e12, 1979e12, 3350e9, 450e9)
    assert not hasattr(TR, "ICI_BW")


@pytest.mark.parametrize("terms", [(1e12, 1e9, 0.0), (1e9, 1e12, 1e6),
                                   (0.0, 0.0, 1e9), (0.0, 0.0, 0.0)])
def test_roofline_terms_equal_reference(port_peaks, terms):
    assert TR.roofline_terms(*terms) == RR.roofline_terms(*terms)


@pytest.mark.parametrize("mkn", [(4096, 4096, 4096), (64, 2048, 8192),
                                 (1, 2048, 50304), (300, 1000, 77)])
def test_projections_equal_reference(port_peaks, mkn):
    m, k, n = mkn
    for p in (3, 4, 6):
        for out_bytes in (4, 8):
            assert TR.projected_throughput(m, k, n, p, "ozaki1", "gpu",
                                           out_bytes) == \
                RR.projected_throughput(m, k, n, p, "ozaki1", "gpu",
                                        out_bytes)
        for c3 in (False, True):
            assert TR.projected_throughput(m, k, n, p + 6, "ozaki2", "gpu",
                                           8, c3) == \
                RR.projected_throughput(m, k, n, p + 6, "ozaki2", "gpu", 8,
                                        c3)
        for scheme in ("ozaki1", "ozaki2"):
            for batch in (1, 16):
                assert TR.batched_projected_throughput(
                    m, k, n, batch, p, scheme, "gpu") == \
                    RR.batched_projected_throughput(m, k, n, batch, p,
                                                    scheme, "gpu")
            for part in ("column", "row", "batch"):
                mesh = {"data": 2, "model": 1 if m % 4 or n % 4 or k % 4
                        else 4}
                assert TR.sharded_projected_throughput(
                    m, k, n, p, mesh, part, scheme, "gpu") == \
                    RR.sharded_projected_throughput(m, k, n, p, mesh, part,
                                                    scheme, "gpu")
        for uses in (1, 3):
            assert TR.scheme1_decomposition_terms(m, k, n, p, uses) == \
                RR.scheme1_decomposition_terms(m, k, n, p, uses)
            for c3 in (False, True):
                assert TR.scheme2_decomposition_terms(m, k, n, p, uses,
                                                      c3) == \
                    RR.scheme2_decomposition_terms(m, k, n, p, uses, c3)
    with pytest.raises(ValueError, match="no projection"):
        TR.projected_throughput(m, k, n, 4, "native")


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _torch_leaves(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree_flatten(tree).items()}


@pytest.mark.parametrize("arch_id", tconfigs.ARCH_IDS)
def test_abstract_state_equals_reference(arch_id):
    """Meta tensors of the reference's jax.eval_shape trees, leaf for
    leaf (shape and dtype), at full size: nothing is drawn or allocated."""
    ra, ta = rconfigs.get_config(arch_id), tconfigs.get_config(arch_id)
    rp, tp = RS.abstract_params(ra), TS.abstract_params(ta)
    assert all(x.is_meta for x in tree_leaves(tp))
    assert _torch_leaves(tp) == _jax_leaves(rp)
    assert _torch_leaves(TS.abstract_opt(ta, tp)) == _jax_leaves(
        RS.abstract_opt(ra, rp))
    for batch, max_seq in ((2, 64), (128, 32768)):
        assert _torch_leaves(TS.abstract_cache(ta, batch, max_seq)) == \
            _jax_leaves(RS.abstract_cache(ra, batch, max_seq))


@pytest.mark.parametrize("arch_id", tconfigs.ARCH_IDS)
def test_model_flops_equal_reference(arch_id):
    """model_flops and routed_param_count over the abstract trees, for
    every shape of the arch."""
    ra, ta = rconfigs.get_config(arch_id), tconfigs.get_config(arch_id)
    rp, tp = RS.abstract_params(ra), TS.abstract_params(ta)
    r_total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(rp))
    t_total = sum(x.numel() for x in tree_leaves(tp))
    assert t_total == r_total
    routed = TR.routed_param_count(tp)
    assert routed == RR.routed_param_count(rp)
    assert (routed > 0) == (ta.model.moe is not None)
    for rs, ts in zip(ra.shapes(), ta.shapes()):
        assert ts.name == rs.name
        assert TR.model_flops(ta, ts, t_total, routed) == \
            RR.model_flops(ra, rs, r_total, routed)


def test_analyze_step_flops_equal_analyze_hlo(one_torch_thread):
    """A native smoke olmo-1b forward: the FLOPs of one eager step
    counted op by op equal those of the reference's compiled HLO within
    1 %; no collectives."""
    ra, ta = rconfigs.get_smoke_config("olmo-1b"), \
        tconfigs.get_smoke_config("olmo-1b")
    toks = np.random.default_rng(0).integers(
        0, ra.model.vocab, (2, 32)).astype(np.int32)
    rp = RM.init_params(jax.random.PRNGKey(0), ra.model)
    fwd = jax.jit(lambda p, t: RM.forward_train(p, ra.model,
                                                {"tokens": t})[0])
    ref = RR.analyze_hlo(fwd.lower(rp, jnp.asarray(toks)).compile()
                         .as_text())
    tp = TM.init_params(ta.model, 0, "cpu")
    with torch.no_grad():
        got = TR.analyze_step(TM.forward_train, tp, ta.model,
                              {"tokens": torch.as_tensor(toks)})
    assert abs(got["flops"] - ref["flops"]) <= 0.01 * ref["flops"]
    assert got["coll_bytes"] == ref["coll_bytes"] == 0.0
    assert got["mem_bytes"] > 0


def test_analyze_step_counts_a_toy_by_hand():
    """(a @ b).relu() + c with a (8, 16), b (16, 4), c (8, 4) float32:
    mm reads a and b and writes 32 floats, relu reads and writes 32,
    add reads 64 and writes 32: 2 * 8 * 16 * 4 flops, (128 + 64 + 32 +
    64 + 96) * 4 bytes. A transpose view of b adds no bytes."""
    a, b, c = torch.ones(8, 16), torch.ones(4, 16), torch.ones(8, 4)
    got = TR.analyze_step(lambda: (a @ b.t()).relu() + c)
    assert got == {"flops": 2 * 8 * 16 * 4,
                   "mem_bytes": 4 * (128 + 64 + 32 + 32 + 32 + 64 + 32),
                   "coll_bytes": 0.0}


def test_kernel_work_models():
    """The work analyze_step adds for a launched kernel: an emulated GEMM's
    int8 ops and telemetry's modeled bytes, and K10's flops and bytes."""
    from repro_torch.core import traffic
    s = traffic.GemmShape(64, 32, 128)
    call = {"scheme": "ozaki1", "count": 4, "m": 64, "k": 128, "n": 32,
            "batch": 3, "modeled_bytes": 999}
    assert TR.gemm_work(call) == (3 * traffic.scheme1_flops(s, 4), 999)
    call.update(scheme="ozaki1-4m", batch=None)
    assert TR.gemm_work(call)[0] == 4 * traffic.scheme1_flops(s, 4)
    call.update(scheme="ozaki2-3m", count=6)
    assert TR.gemm_work(call)[0] == traffic.scheme2_flops(s, 6, True)
    attn = {"b": 2, "h": 16, "kvh": 4, "sq": 128, "sk": 256, "d": 72,
            "causal": True, "window": None, "dtype": torch.bfloat16}
    assert TR.attention_work(attn) == (
        4 * 2 * 16 * 128 * 256 * 72 // 2,
        2 * 72 * (2 * 2 * 16 * 128 + 2 * 2 * 4 * 256))


@pytest.mark.parametrize("shape,spec", [("train_4k", "ozaki1-p4+cached"),
                                        ("decode_32k", "ozaki1-p4")])
def test_perf_probe_rows_match_telemetry(one_torch_thread, shape, spec):
    """A CPU-profiled smoke step: one row per (tag, site), its calls equal
    to telemetry's calls of that site, every range paired with its call;
    modeled bytes equal telemetry's; the bound the larger of its int8
    ops at the int8 peak and its bytes at the HBM rate; no device time
    and no mfu on the CPU."""
    telemetry.REGISTRY.clear(trecord.EMULATED_CALLS)
    res = TP.probe("olmo-1b", shape, spec, batch=2, device="cpu",
                   smoke=True, seq=32)
    s = TP.summary(res)
    assert res["mfu"] is None and res["device"] == "cpu"
    rows = {(r["tag"], r["site"]): r for r in s["rows"]}
    tele = {}
    for labels, v in telemetry.REGISTRY.series(trecord.EMULATED_CALLS):
        tag = trecord.gemm_tag(labels["scheme"], 4, labels["backend"],
                               labels["impl"])
        tele[tag, labels["site"]] = tele.get((tag, labels["site"]), 0) + v
    assert {k: r["calls"] for k, r in rows.items()} == tele
    assert all(r["paired"] for r in rows.values())
    assert sum(r["modeled_gb"] for r in rows.values()) == pytest.approx(
        sum(c["modeled_bytes"] for c in res["calls"]) / 1e9)
    for r in rows.values():
        assert r["bound_ms"] == pytest.approx(1e3 * max(
            r["int8_ops"] / TR.PEAK_INT8_OPS, r["bound_bytes"] / TR.HBM_BW),
            rel=0.5) and r["device_ms"] == 0.0 and r["share"] is None
    assert s["coverage"] is None and res["model_flops"] > 0


def test_normalize_tag_keeps_emulation_digits():
    """The reference's normalization, copied verbatim: layer digits and
    shape suffixes fold, the digits of an emugemm tag stay."""
    assert TP.normalize_tag("layers_3/attn[128]/emugemm/ozaki1-p4/cuda/"
                            "kernel/mm_12") == \
        "layers_/attn/emugemm/ozaki1-p4/cuda/kernel/mm_"
    assert TP.normalize_tag("aten::mm 12") == "aten::mm "


def test_render_tables_equal_reference(tmp_path):
    rows = [{"arch": a, "shape": "train_4k", "mesh": m,
             "roofline": {"compute_s": c, "memory_s": 0.5,
                          "collective_s": 0.1, "bottleneck": "compute"},
             "memory": {"argument_bytes": 3e9 if a == "x" else None},
             "useful_flops_ratio": 0.7}
            for a, m, c in (("x", "single", 1.0), ("a", "multi", 0.25))]
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(rows))
    for mesh in (None, "single"):
        assert TT.render(str(path), mesh) == RT.render(str(path), mesh)


def test_probe_policy_defaults_to_the_arch_table():
    """No --gemm: the arch's gemm_sites decide (olmo-1b-emu's table)."""
    arch, shape = TP.cell("olmo-1b-emu", "decode_32k", batch=4, layers=2)
    assert (shape.global_batch, shape.seq_len, arch.model.n_layers) == (
        4, 32768, 2)
    assert arch.gemm_policy() != GemmPolicy()
    assert api.precision("ozaki1-p4").p == 4
    with pytest.raises(ValueError, match="has no shape"):
        TP.cell("hubert-xlarge", "decode_32k")
