"""Serve and train one card with two checkouts of this repository in turns.

    python3 compare_checkouts.py OTHER_CHECKOUT
    python3 compare_checkouts.py OTHER_CHECKOUT --scheme2
    python3 compare_checkouts.py OTHER_CHECKOUT --residues
    python3 compare_checkouts.py OTHER_CHECKOUT --scheme1
    python3 compare_checkouts.py OTHER_CHECKOUT --library

Builds both checkouts' kernels, then measures each checkout through its
own ``chip_smoke.py`` in separate processes, in the order other, this,
this, other, so that both are measured on the same card: olmo-1b served
under ozaki1-p4 (the trace's tokens/s and TTFT), the wall of a mixed and
a decode step under ozaki1-p4 and native (5 synchronised steps each),
three timed train steps under ozaki1-p4+cached, all before the
process's first torch.profiler session; then the profiled phases
(device-busy time of the steps), after which the step walls are taken
again, to show how far walls taken later in a profiled process move.
Each run prints one ``COMPARE {...}`` line. With ``--scheme2`` each run
instead times EmuGEMM-II's float-rhs form (``ozaki2.fused_matmul_scheme2``,
bf16, m = 6, whatever route the checkout gives it) at olmo-1b-emu's
attn_qk shapes per serve, train and 2 x 2048 step (K6), at olmo-1b's
dense shapes at 1024 tokens (K5g) and on dB = X^T dC of every weight in
a hoisted ozaki2-m6+cached step (K5g), then runs that checkout's hoisted
train phase (step walls before its profiler session, device time, idle
share, peak memory), and prints one ``COMPARE_S2 {...}`` line. With
``--residues`` each run times EmuGEMM-II's residue forms, whatever
kernels the checkout gives them, on full-range int8 residues: K5
(``ozaki2.fused_residue_matmul``) and K7
(``ozaki3m.fused_3m_residue_matmul``) at 4096^3, m = 16, K5 at olmo-1b's
dense shapes at 1024 tokens, m = 6 (summed), the ops routes that drive
them (``ops.fused_scheme2_matmul``, ``ops.fused_3m_matmul``) at 4096^3,
m = 16, and the float64 plane route at that shape with its plane GEMM
apart, and prints one ``COMPARE_RES {...}`` line. With ``--scheme1`` each
run times EmuGEMM-I's batched form (``ozaki1.fused_matmul_scheme1`` on
(B, M, K) @ (B, K, N), bf16, p = 4) at the batched shapes of a mixed and a
decode serve step of olmo-1b (attn_qk and attn_av, summed with their
launch counts) and its interleaved form (``ozaki1.fused_matmul_interleaved``
on the lhs and rhs decompositions' layouts) at olmo-1b's dense shapes at
1024 tokens (one call each, summed), whatever kernels the checkout gives
them, K4 also per call at training's attention chunks, at one batch
element and at p = 1 and 8, the plane route's encode at four shapes, and
K4 and the encode by their kernels' device time from torch.profiler (CUDA
events over back-to-back calls measure the host's wrapper at those
shapes), and prints one ``COMPARE_S1 {...}`` line. With ``--library`` each
run times the library kernels that no model path reaches, whatever kernels
the checkout gives them: the int8 GEMM (K9, ``matmul_int8.int8_matmul``)
at 4096^3 and 8192^3 beside ``torch._int_mm`` in the same process, the
naive Fig. 4 structure (p(p+1)/2 K9 calls) beside one EmuGEMM-I call (K1)
at 4096^3, float32, p = 4, and the decompositions K2, K2r and K11 (bf16,
p = 4) at olmo-1b's three dense shapes at 1024 tokens (one call each,
summed), each by CUDA events and by its kernels' device time from
torch.profiler, and prints one ``COMPARE_LIB {...}`` line. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import math
import os
import runpy
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def step_walls(g, dev, arch, params, view_tokens, pols) -> dict:
    """Wall ms of 5 synchronised mixed and decode steps (after one
    warm-up) under each policy of ``pols``, as chip_smoke's profile
    phase builds them."""
    import time
    import torch
    from repro_torch.models import model as M
    start = torch.tensor([0, 16, 32, 47], device=dev, dtype=torch.int32)
    out = {}
    for kind, c, n_new in (("mixed", g["CHUNK"], [16, 16, 5, 1]),
                           ("decode", 1, [1, 1, 1, 1])):
        tokens = torch.ones((g["LANES"], c), device=dev, dtype=torch.int32)
        nn = torch.tensor(n_new, device=dev, dtype=torch.int32)
        cache = M.init_cache(arch.model, g["LANES"], view_tokens, dev)
        for name, pol in pols.items():
            walls = []
            for _ in range(6):
                t0 = time.perf_counter()
                with torch.inference_mode():
                    M.forward_step(params, arch.model, tokens, start, nn,
                                   cache, pol)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"{kind}/{name}"] = walls[1:]
    return out


def measure(root: str) -> dict:
    """The end-to-end numbers of the checkout at ``root``, through its
    own chip_smoke.py (run in a fresh process: it imports that
    checkout's package)."""
    g = runpy.run_path(os.path.join(root, "chip_smoke.py"),
                       run_name="chip_smoke")["main"].__globals__
    import torch
    from repro_torch import api, configs
    from repro_torch.models.common import GemmPolicy
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    arch = configs.get_config("olmo-1b")
    view_tokens = g["PAGE"] * math.ceil(
        (g["PROMPT"] + g["GEN"] - 1 + g["CHUNK"]) / g["PAGE"])
    pols = {"ozaki1-p4": GemmPolicy(default=api.precision("ozaki1-p4")),
            "native": GemmPolicy(default=api.precision("native"))}
    eng, _, serve = g["serve_phase"](dev, arch, pols["ozaki1-p4"])
    walls = step_walls(g, dev, arch, eng.params, view_tokens, pols)
    _, _, train = g["train_phase"](
        dev, arch, card,
        GemmPolicy(default=api.precision("ozaki1-p4+cached")),
        long_seq=False)
    prof = g["profile_phase"](dev, arch, eng.params, view_tokens,
                              (("ozaki1-p4", pols["ozaki1-p4"]),))
    walls_after = step_walls(g, dev, arch, eng.params, view_tokens, pols)
    del eng
    return {"root": root, "card": card, "serve": serve,
            "step_wall_ms": walls,
            "device_busy_ms": {k: v["device_busy_ms"]
                               for k, v in prof.items()},
            "train": {k: train[k] for k in ("step_wall_s", "tokens_per_s",
                                            "peak_memory_bytes")},
            "train_profile": {k: train["profile"][k]
                              for k in ("device_busy_ms", "idle_share",
                                        "profiled_wall_ms")},
            "step_wall_ms_after_profiling": walls_after}


def measure_scheme2(root: str) -> dict:
    """EmuGEMM-II's float-rhs form per step at the shapes of the checkout
    at ``root`` (device ms, CUDA events), then its hoisted train step."""
    g = runpy.run_path(os.path.join(root, "chip_smoke.py"),
                       run_name="chip_smoke")["main"].__globals__
    import torch
    from repro_torch import configs
    from repro_torch.core import scheme2
    from repro_torch.core.precision import default_moduli
    from repro_torch.kernels import ozaki2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    arch, emu = configs.get_config("olmo-1b"), configs.get_config("olmo-1b-emu")
    view_tokens = g["PAGE"] * math.ceil(
        (g["PROMPT"] + g["GEN"] - 1 + g["CHUNK"]) / g["PAGE"])
    bf, moduli = torch.bfloat16, default_moduli(g["M_MAIN"])
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = g["TOKENS"] // g["HOIST_MICRO"]
    cases = [({"serve": lbl.replace("serve ", ""), "train": "train",
               "long": "long"}[lbl.split()[0]], lbl, (bt,), m, k, n, ta, tb,
              count)
             for lbl, bt, m, k, n, ta, tb, count in g["qk_shapes"](
                 emu.model, view_tokens)]
    cases += [("dense", f"dense {(m, k, n)}", (), m, k, n, False, False, 1)
              for m, k, n in g["dense_shapes"](arch.model)]
    cases += [("db", f"dB K={k} N={n}", (), k, tokens, n, True, False,
               g["HOIST_MICRO"] * c)
              for k, n, _, c in g["weight_shapes"](arch.model)]
    per_step, per_case = {}, {}
    for step, lbl, lead, m, k, n, ta, tb, count in cases:
        a = g["operand"](gen, lead, m, k, ta, bf, dev)
        b = g["operand"](gen, lead, k, n, tb, bf, dev)
        mu, nu = scheme2.scales(a, b, moduli)
        ms = g["time_ms"](lambda: ozaki2.fused_matmul_scheme2(
            a, b, mu, nu, moduli, bf), 10)
        per_case[lbl] = ms
        per_step[step] = per_step.get(step, 0.0) + count * ms
        del a, b
    torch.cuda.empty_cache()
    _, _, hoist = g["hoisted_train_phase"](dev, arch, card)
    return {"root": root, "card": card, "float_rhs_ms_per_step": per_step,
            "float_rhs_ms_per_call": per_case,
            "hoisted": {k: hoist[k] for k in ("step_wall_s", "tokens_per_s",
                                              "peak_memory_bytes")},
            "hoisted_profile": {k: hoist["profile"][k]
                                for k in ("device_busy_ms", "idle_share",
                                          "profiled_wall_ms",
                                          "top_device_ms")}}


def measure_residues(root: str) -> dict:
    """The residue forms' device ms (CUDA events) in the checkout at
    ``root``, through its own chip_smoke.py's helpers."""
    g = runpy.run_path(os.path.join(root, "chip_smoke.py"),
                       run_name="chip_smoke")["main"].__globals__
    import torch
    from repro_torch import configs
    from repro_torch.core import scheme2
    from repro_torch.core.precision import default_moduli
    from repro_torch.kernels import ops, ozaki2, ozaki3m
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(22)
    time_ms, n, p = g["time_ms"], 4096, 16

    def res(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    moduli = default_moduli(p)
    out = {"root": root, "card": card}
    a3, b3 = res(p, 3, n, n), res(p, 3, n, n)
    out["k7_4096_ms"] = time_ms(lambda: ozaki3m.fused_3m_residue_matmul(
        a3, b3, moduli), 3)
    del a3, b3
    a, b = res(p, n, n), res(p, n, n)
    out["k5_4096_ms"] = time_ms(lambda: ozaki2.fused_residue_matmul(
        a, b, moduli), 5)
    del a, b
    dense, m6 = 0.0, default_moduli(g["M_MAIN"])
    for m, k, nn in g["dense_shapes"](configs.get_config("olmo-1b").model):
        a, b = res(len(m6), m, k), res(len(m6), k, nn)
        dense += time_ms(lambda: ozaki2.fused_residue_matmul(a, b, m6), 10)
    out["k5_dense_m6_ms"] = dense
    spec = f"ozaki2-m{p}"
    za, zb = (g["eq19"](gen, (n, n), torch.complex128, dev) for _ in "ab")
    out["ops_fused_3m_matmul_ms"] = time_ms(
        lambda: ops.fused_3m_matmul(za, zb, spec), 3)
    del za, zb
    da, db = (g["eq19"](gen, (n, n), torch.float64, dev) for _ in "ab")
    out["ops_fused_scheme2_matmul_ms"] = time_ms(
        lambda: ops.fused_scheme2_matmul(da, db, spec,
                                         out_dtype=torch.float64), 3)
    mu, nu = scheme2.scales(da, db, moduli)
    out["dgemm_route_ms"] = time_ms(lambda: ozaki2.fused_matmul_scheme2(
        da, db, mu, nu, moduli, torch.float64), 3)
    _, main, gemm, _ = g["plane_split"]("dgemm", da, db, mu, nu, moduli, 3)
    out["dgemm_plane_gemm_ms"], out["dgemm_mainloop_ms"] = gemm, main
    return out


def kernel_device_ms(fn, calls: int) -> float:
    """Mean device ms of the one kernel ``fn`` launches a call (either
    checkout's batched form), from one torch.profiler pass: the mean of the
    kernel events the pass kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / 1e3 / len(spans)


def measure_scheme1(root: str) -> dict:
    """EmuGEMM-I's batched and interleaved forms' device ms (CUDA events) in
    the checkout at ``root``, through its own chip_smoke.py's helpers."""
    g = runpy.run_path(os.path.join(root, "chip_smoke.py"),
                       run_name="chip_smoke")["main"].__globals__
    import torch
    from repro_torch import configs
    from repro_torch.core import scheme1
    from repro_torch.kernels import decompose, ozaki1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(23)
    time_ms, conditioned = g["time_ms"], g["conditioned"]
    mcfg = configs.get_config("olmo-1b").model
    bf, p = torch.bfloat16, g["P_MAIN"]
    view_tokens = g["PAGE"] * math.ceil(
        (g["PROMPT"] + g["GEN"] - 1 + g["CHUNK"]) / g["PAGE"])
    out = {"root": root, "card": card}
    for step, chunk in (("mixed", g["CHUNK"]), ("decode", 1)):
        total, device, per_call = 0.0, 0.0, {}
        for kind, bt, m, k, n, _, count in g["path_shapes"](
                mcfg, view_tokens, chunk):
            if kind != "batched":
                continue
            a = conditioned(gen, (bt, m, k), bf, dev)
            b = conditioned(gen, (bt, k, n), bf, dev)
            mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
            def run():
                return ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7, bf)
            # CUDA events over back-to-back calls, and the kernels' device
            # time from one profiler pass (the former is the host's at
            # these shapes).
            ms, dev_ms = time_ms(run, 20), kernel_device_ms(run, 20)
            per_call[f"{(bt, m, k, n)}"] = [ms, dev_ms]
            total += count * ms
            device += count * dev_ms
        out[f"k4_{step}_step_ms"], out[f"k4_{step}_step_device_ms"] = (
            total, device)
        out[f"k4_{step}_per_call_ms"] = per_call
    # Training's chunked attention (q and kv chunks of 1024): one train
    # step of 8 x 128 tokens and one of 2 x 2048, per call.
    for bt, m, k, n in ((128, 128, 128, 128), (32, 1024, 128, 1024),
                        (32, 1024, 1024, 128)):
        a = conditioned(gen, (bt, m, k), bf, dev)
        b = conditioned(gen, (bt, k, n), bf, dev)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)

        def run():
            return ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, 7, bf)
        out[f"k4_train_call_ms {(bt, m, k, n)}"] = [
            time_ms(run, 10), kernel_device_ms(run, 10)]
        del a, b
    # What sets a serve launch's time: one batch element (one block a
    # column tile), and the slice count.
    for label, bt, pp in (("batch 1", 1, p), ("p 1", 64, 1), ("p 8", 64, 8)):
        a = conditioned(gen, (bt, 16, 128), bf, dev)
        b = conditioned(gen, (bt, 128, 80), bf, dev)
        mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
        out[f"k4_probe_device_ms {label} {(bt, 16, 128, 80)}"] = \
            kernel_device_ms(lambda: ozaki1.fused_matmul_scheme1(
                a, b, mu, nu, pp, 7, bf), 20)
    # The plane route's encode (a 2-D product's operands, a weight).
    for r, k in ((64, 2048), (2048, 2048), (8192, 2048), (1024, 8192)):
        x = conditioned(gen, (r, k), bf, dev)
        sc = scheme1.pow2_scale(x, -1)
        out[f"encode_device_ms {(r, k)}"] = kernel_device_ms(
            lambda: ozaki1.launch_encode(x, sc, p, 7), 20)
    total, per_call = 0.0, {}
    for m, k, n in g["dense_shapes"](mcfg):
        a = conditioned(gen, (m, k), bf, dev)
        b = conditioned(gen, (k, n), bf, dev)
        beta = g["scheme1_cfg"](p, "xla").resolved_beta(k)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        a_hat = decompose.decompose_interleave(a, mu, p, beta)
        b_hat = decompose.decompose_interleave_rhs(b, nu, p, beta)
        ms = time_ms(lambda: ozaki1.fused_matmul_interleaved(
            a_hat, b_hat, mu, nu, p, beta, bf), 10)
        per_call[f"{(m, k, n)}"] = ms
        total += ms
        del a, b, a_hat, b_hat
    out["k8_dense_ms"], out["k8_dense_per_call_ms"] = total, per_call
    return out


def device_ms_per_call(fn, calls: int) -> float:
    """Device ms of every kernel ``fn`` launches, summed a call, from one
    torch.profiler pass over ``calls`` calls (either checkout's K9 is one
    or two kernels a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def measure_library(root: str) -> dict:
    """The library kernels' device ms (CUDA events) in the checkout at
    ``root``, through its own chip_smoke.py's helpers."""
    g = runpy.run_path(os.path.join(root, "chip_smoke.py"),
                       run_name="chip_smoke")["main"].__globals__
    import torch
    from repro_torch import configs
    from repro_torch.core import scheme1
    from repro_torch.kernels import decompose, matmul_int8
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(24)
    time_ms, conditioned = g["time_ms"], g["conditioned"]
    out = {"root": root, "card": card}
    for n in (4096, 8192):
        a8, b8 = (torch.randint(-128, 128, (n, n), generator=gen, device=dev,
                                dtype=torch.int8) for _ in "ab")
        out[f"k9_{n}_ms"] = time_ms(lambda: matmul_int8.int8_matmul(a8, b8),
                                    10)
        out[f"k9_{n}_device_ms"] = device_ms_per_call(
            lambda: matmul_int8.int8_matmul(a8, b8), 5)
        out[f"int_mm_{n}_ms"] = time_ms(lambda: torch._int_mm(a8, b8), 10)
        del a8, b8
    p, n = g["P_MAIN"], g["NAIVE_N"]
    na, nb = (conditioned(gen, (n, n), torch.float32, dev) for _ in "ab")
    beta = g["scheme1_cfg"](p, "xla").resolved_beta(n)
    out["naive_fig4_ms"] = time_ms(
        lambda: g["naive_scheme1"](na, nb, p, beta), 3)
    out["fused_k1_ms"] = time_ms(
        lambda: g["fused_scheme1"](na, nb, p, beta), 3)
    del na, nb
    bf, per_call = torch.bfloat16, {}
    for key in ("k2", "k2r", "k11"):
        out[f"{key}_dense_ms"] = out[f"{key}_dense_device_ms"] = 0.0
    for m, k, n in g["dense_shapes"](configs.get_config("olmo-1b").model):
        a = conditioned(gen, (m, k), bf, dev)
        b = conditioned(gen, (k, n), bf, dev)
        mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
        tau = scheme1.pow2_scale(b, 1).T
        for key, fn in (
                ("k2", lambda: decompose.decompose_interleave_pair(
                    b, nu, tau, p, 7, 7)),
                ("k2r", lambda: decompose.decompose_interleave_rhs(
                    b, nu, p, 7)),
                ("k11", lambda: decompose.decompose_interleave(a, mu, p, 7))):
            ms, dev_ms = time_ms(fn, 10), kernel_device_ms(fn, 10)
            per_call[f"{key} {(m, k, n)}"] = [ms, dev_ms]
            out[f"{key}_dense_ms"] += ms
            out[f"{key}_dense_device_ms"] += dev_ms
        del a, b
    out["decompose_per_call_ms"] = per_call
    return out


def main() -> int:
    modes = {"--measure": ("COMPARE", measure),
             "--measure-scheme2": ("COMPARE_S2", measure_scheme2),
             "--measure-residues": ("COMPARE_RES", measure_residues),
             "--measure-scheme1": ("COMPARE_S1", measure_scheme1),
             "--measure-library": ("COMPARE_LIB", measure_library)}
    if len(sys.argv) == 3 and (sys.argv[1] == "--build"
                               or sys.argv[1] in modes):
        root = os.path.abspath(sys.argv[2])
        if sys.argv[1] == "--build":
            runpy.run_path(os.path.join(root, "chip_smoke.py"),
                           run_name="chip_smoke")["build_phase"]()
        else:
            tag, fn = modes[sys.argv[1]]
            print(f"{tag} " + json.dumps(fn(root)), flush=True)
        return 0
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in (
            [], ["--scheme2"], ["--residues"], ["--scheme1"], ["--library"]):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    how = "--measure-" + sys.argv[2][2:] if sys.argv[2:] else "--measure"
    me = [sys.executable, os.path.abspath(__file__)]
    builds = [subprocess.Popen(me + ["--build", r]) for r in (other, HERE)]
    if any(p.wait() for p in builds):
        return 1
    for root in (other, HERE, HERE, other):
        if subprocess.run(me + [how, root]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
