#!/usr/bin/env python3
"""Tile-shape sweep of the tensor-core attention forward on one GPU.

    python3 tools/flash_fwd_tc_sweep.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  It builds ``mpi4torch_tpu_torch/ops/csrc/flash_fwd_tc.cu``
as shipped and in variants made by rewriting its tile constants (``NW``
warps of 16 q rows per block, ``BK`` keys per KV tile, ``__launch_bounds__``
blocks per SM) or its exponential (the library's ``exp2f`` in place of
``ex2.approx``), one ``nvcc`` per variant, all at once, into the package's
git-ignored ``build/sweep``.  For each variant it prints what ptxas and the
card made of it (registers, spill bytes, blocks per SM), checks it against
the plain version on a few edge cases with ``chip_smoke.py``'s tolerance
(bitwise repeatable too), and times it on the device at the training shape
(8, 2048, 16, 128) and the serving prefill shape (1, 1024, 16, 128), bf16
causal, beside the bound.  The shipped kernel is timed first and last, so
that a drift of the card's clock shows.  The last line is one JSON object
of the readings.  It exits non-zero without CUDA or when a variant
disagrees with the plain version.
"""

import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402  (the smoke's timing and tolerances)

# name -> (tile constants to set, use the library's exp2f)
VARIANTS = {
    "shipped": ({}, False),
    "exp2f": ({}, True),
    "rows128_warps8": ({"NW": 8}, False),
    "keys32": ({"BK": 32}, False),
    "rows128_warps8_keys32": ({"NW": 8, "BK": 32}, False),
}
# (b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal): GQA, ragged
# edges off the tiles with fewer keys than one, a window at d = 72,
# non-causal ragged keys, fully masked rows.
CASES = [(2, 133, 37, 4, 2, 128, 0, 0, 0, True),
         (1, 300, 300, 4, 2, 72, 0, 0, 64, True),
         (2, 130, 70, 4, 2, 128, 0, 0, 0, False),
         (1, 128, 128, 4, 4, 64, 0, 100, 0, True),
         (1, 1024, 1024, 16, 4, 128, 0, 0, 0, True)]
SHAPES = [(8, 2048), (1, 1024)]


def variant_source(src, consts, exp2f):
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    if consts.get("NW", 4) != 4:
        # Eight warps of 255 registers fit one block per SM, not two.
        blocks = 2 if consts.get("BK", 64) == 32 else 1
        src = src.replace("__launch_bounds__(NT, 2)",
                          f"__launch_bounds__(NT, {blocks})")
    if exp2f:
        src, n = re.subn(r"= ex2\(", "= exp2f(", src)
        assert n == 2
    return src


def main():
    if not torch.cuda.is_available():
        print("flash_fwd_tc_sweep: CUDA is not available", file=sys.stderr)
        return 2
    from mpi4torch_tpu_torch.ops import _kernels as kernels
    from mpi4torch_tpu_torch.ops import flash

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(kernels._CSRC, "flash_fwd_tc.cu")) as f:
        src = f.read()
    out_dir = os.path.join(kernels._BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, (consts, exp2f) in VARIANTS.items():
        path = os.path.join(out_dir, f"flash_fwd_tc_{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, consts, exp2f))
        libs[name] = f"sweep_{name}"
        kernels._SOURCES[libs[name]] = path
        kernels._SIGNATURES[libs[name]] = kernels._SIGNATURES["flash_fwd_tc"]
    with kernels._lock:
        kernels._load_locked(list(libs.values()))
    shipped = kernels.load("flash_fwd_tc")

    inputs = []
    for i, (b, sq, sk, h, h_kv, d, q_off, kv_off, window, causal) in \
            enumerate(CASES):
        q, k, v = S.attention_inputs(torch.bfloat16, b, sq, sk, h, h_kv, d,
                                     seed=100 + i)
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
                  window=window)
        po, pl = flash.flash_block_attention(q, k, v, impl="torch", **kw)
        inputs.append((q, k, v, kw, po, pl))
    big = {shape: S.attention_inputs(torch.bfloat16, shape[0], shape[1],
                                     shape[1], 16, 16, 128, seed=7)
           for shape in SHAPES}

    def run(name):
        kernels._libs["flash_fwd_tc"] = kernels._libs[libs[name]]
        ok, worst = True, 0.0
        for q, k, v, kw, po, pl in inputs:
            o, l = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
            o2, l2 = flash.flash_block_attention(q, k, v, impl="cuda", **kw)
            err_o, _, _, good = S.forward_errors(o, l, po, pl,
                                                 torch.bfloat16)
            ok = ok and good and torch.equal(o, o2) and torch.equal(l, l2)
            worst = max(worst, err_o)
        ms = {}
        for (b, s), (q, k, v) in big.items():
            ms[f"{b}x{s}"] = S.event_ms(
                lambda: kernels.flash_fwd(q, k, v, 0, 0, True),
                iters=10 if b > 1 else 50)
        return ok, worst, ms

    results = {}
    for name in list(VARIANTS) + ["shipped"]:
        ok, worst, ms = run(name)
        props = {d: kernels.tc_props("flash_fwd", d) for d in (64, 128)}
        ptxas = [line.split(":")[-1].strip() for line in
                 kernels.build_log[libs[name]]["output"].splitlines()
                 if "registers" in line or "spill" in line]
        key = name if name not in results else f"{name}_again"
        results[key] = {"ok": ok, "max_abs_err": worst, "ms": ms,
                        "props": props}
        line = f"  {key:24s} {'ok' if ok else 'FAIL'} max err {worst:.4f};"
        for (b, s) in SHAPES:
            t = ms[f"{b}x{s}"]
            flops = 4.0 * 128 * b * 16 * S.live_pairs(s, s, 0, 0, 0, True)
            nbytes = 4 * b * s * 16 * 128 * 2 + b * s * 16 * 4
            b_ms, b_by = S.bound(flops, nbytes, torch.bfloat16)
            line += (f" ({b}, {s}, 16, 128) {t:.4f} ms, {flops / t / 1e9:.1f}"
                     f" TFLOP/s, {100 * b_ms / t:.1f}% of its bound "
                     f"{b_ms:.4f} ms ({b_by});")
        line += " " + "; ".join(
            f"d <= {d}: {p['registers']} registers, {p['local_bytes']} B "
            f"local, {p['blocks_per_sm']} blocks/SM"
            for d, p in props.items())
        print(line, flush=True)
        print("    ptxas: " + " | ".join(ptxas), flush=True)
    kernels._libs["flash_fwd_tc"] = shipped
    print(smi)
    print(json.dumps({"device": smi, "variants": results}))
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
