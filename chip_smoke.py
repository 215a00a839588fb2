#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero; no phase's failure is caught):
  0. the card: `nvidia-smi` name and power limit, compute capability 9.0;
  1. build the CUDA kernels from ray_tpu_torch/csrc with nvcc (sm_90a);
  2. each kernel against its plain PyTorch version on the card, in bf16
     and f32, at the serving path's shapes: max error against the stated
     tolerance, device time (CUDA events, L2 flushed before each call, host
     launch overhead excluded; see device_ms), the plain version's time,
     the least time the card could take (bound), and one PyTorch library
     call computing the same function where one exists;
  3. the main path: LLMServer serving llama3-8b at full width and depth
     (random weights from a seed) with five concurrent requests — short
     prompts (bucketed prefill, kernel K2), a ~700-token prompt (chunked
     prefill, K6), one request sampled at temperature 0.8 / top_p 0.9 —
     32 tokens each. Launch counts are reset just before and read just
     after; every kernel must have run. The engine's logprobs are held
     against log-softmax of the port's own `forward` over prompt + output;
     as negative controls, the same burst with fresh prompts is served once
     per planted engine fault (FAULTS), and the gate must fail each.

The second-to-last line of stdout is {"kernels": [...]}, the last
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerances: |kernel - plain| <= atol + rtol * |plain|
TOL = {
    # f32: the kernels sum in another order than the plain versions
    ("rms_norm", torch.float32): (1e-5, 1e-5),
    ("attention", torch.float32): (2e-3, 2e-3),
    # bf16: both round their f32 results to bf16 (one ulp is 2^-8 relative)
    ("rms_norm", torch.bfloat16): (2e-2, 1.6e-2),
    ("attention", torch.bfloat16): (2e-2, 1.6e-2),
}
# nats, per request, on |engine - forward| over its output logprobs: the
# largest and the mean. The engine (bucketed/chunked prefill, then decode
# over the bf16 page pool) and the full forward round bf16 activations at
# different places, so sound runs differ a little; the sampled request,
# whose tokens change from run to run, read up to 0.30 (max) and 0.065
# (mean) on the H100. The weakest planted fault in FAULTS read 0.57 and
# 0.21 (PERF.md). The mean separates them best, so its limit sits near
# their geometric middle; the max limit guards against a fault confined
# to a few tokens, which the mean would dilute.
LOGPROB_TOL = {"max": 0.5, "mean": 0.12}

SOURCES = {
    "rms_norm": ("ray_tpu_torch/csrc/rms_norm.cu", "ray_tpu/ops/norm.py:31"),
    "flash_attention": ("ray_tpu_torch/csrc/flash_attention.cu", "ray_tpu/ops/attention.py:84"),
    "paged_attention_decode": ("ray_tpu_torch/csrc/paged_attention.cu",
                               "ray_tpu/ops/paged_attention.py:129"),
    "paged_attention_chunk": ("ray_tpu_torch/csrc/paged_attention.cu",
                              "ray_tpu/ops/paged_attention.py:222"),
}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# --------------------------------------------------------------- timing


_FLUSH = None
_CLOCK_HZ = 1.98e9  # the H100 SXM's top boost clock: a sleep of n cycles lasts >= n / this


def _flush_l2():
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    _FLUSH.zero_()


def device_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Device time of one fn() with a cold L2, in ms: median over trials of
    (reps x [flush, fn] - reps x [flush]) / reps, each run timed with CUDA
    events while the card first sleeps long enough for the host to enqueue
    the whole run, so host launch overhead is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    _flush_l2()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(_CLOCK_HZ * (5e-3 + 3 * reps * host_s))

    def run(with_fn: bool) -> float:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(reps):
            _flush_l2()
            if with_fn:
                fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    return statistics.median((run(True) - run(False)) / reps for _ in range(trials))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, kind, dtype, got, want) -> float:
    atol, rtol = TOL[(kind, dtype)]
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        fail(f"{name} {dtype}: non-finite output")
    if bool((err > limit).any()):
        fail(f"{name} {dtype}: max |err| {err.max().item():.3e} exceeds "
             f"atol {atol} + rtol {rtol}")
    return err.max().item()


# -------------------------------------------------------------- phase 2


def kernel_checks(gen) -> dict:
    """Each kernel vs its plain version at the serving path's shapes.
    Returns, per kernel, the bf16 figures at the main shape."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention, norm, paged_attention

    out = {}
    D_model, H, KVH, hd = 4096, 32, 8, 128
    P, ps, pps, B = 512, 16, 64, 8

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"

        # K1: decode rows (B tokens) and a prefill bucket's rows
        for rows in (B, 256):
            x, w = rnd((rows, D_model), dtype), 1.0 + 0.1 * rnd((D_model,), dtype)
            err = check_close("rms_norm", "rms_norm", dtype, norm.rms_norm(x, w, 1e-5),
                              norm.rms_norm_reference(x, w, 1e-5))
            ms = device_ms(lambda: norm.rms_norm(x, w, 1e-5))
            plain = device_ms(lambda: norm.rms_norm_reference(x, w, 1e-5))
            lib = device_ms(lambda: F.rms_norm(x, (D_model,), w, 1e-5))
            bnd, by = bound_ms((2 * rows * D_model + D_model) * el, 4 * rows * D_model, dtype)
            log(f"K1 rms_norm {tag} [{rows},{D_model}]: max_err {err:.3e} "
                f"(tol {TOL[('rms_norm', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
                f"bound {bnd:.4f} ({by}) F.rms_norm {lib:.4f}")
            if dtype == torch.bfloat16 and rows == B:
                out["rms_norm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                       bound_by=by, library_ms=lib)

        # K2: bucketed prefill, one prompt: the buckets the main path uses
        # (64, 128, 256) and a ragged T
        for T in (64, 100, 128, 256):
            q, k, v = rnd((1, T, H, hd), dtype), rnd((1, T, KVH, hd), dtype), rnd((1, T, KVH, hd), dtype)
            err = check_close("flash_attention", "attention", dtype,
                              attention.flash_attention(q, k, v), attention.mha_reference(q, k, v))
            ms = device_ms(lambda: attention.flash_attention(q, k, v))
            plain = device_ms(lambda: attention.mha_reference(q, k, v))
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            pairs = T * (T + 1) // 2
            bnd, by = bound_ms((2 * q.numel() + k.numel() + v.numel()) * el,
                               4 * H * hd * pairs, dtype)
            log(f"K2 flash_attention {tag} T={T}: max_err {err:.3e} "
                f"(tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
                f"bound {bnd:.4f} ({by}) sdpa {lib:.4f}")
            if dtype == torch.bfloat16 and T == 256:
                out["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                              bound_ms=bnd, bound_by=by, library_ms=lib)

        # K5: the engine's decode batch: 8 slots, one inactive, lengths not
        # multiples of the page size, pages scattered over the pool
        kp, vp = rnd((KVH, P, ps, hd), dtype), rnd((KVH, P, ps, hd), dtype)
        table = torch.randint(1, P, (B, pps), generator=gen, device="cuda", dtype=torch.int32)
        lengths = torch.tensor([0, 1, 17, 100, 333, 700, 1000, 1024], dtype=torch.int32,
                               device="cuda")
        q = rnd((B, H, hd), dtype)
        got = paged_attention.paged_attention_decode(q, kp, vp, table, lengths)
        want = paged_attention._paged_reference(q, kp, vp, table, lengths, hd ** -0.5)
        if bool(got[0].float().abs().max() != 0):
            fail("paged_attention_decode: a length-0 slot must give zeros")
        err = check_close("paged_attention_decode", "attention", dtype, got, want)
        ms = device_ms(lambda: paged_attention.paged_attention_decode(q, kp, vp, table, lengths))
        plain = device_ms(lambda: paged_attention._paged_reference(q, kp, vp, table, lengths,
                                                                 hd ** -0.5))
        keys = int(lengths.sum())
        bnd, by = bound_ms((2 * q.numel() + 2 * keys * KVH * hd) * el + 4 * (table.numel() + B),
                           4 * keys * H * hd, dtype)
        log(f"K5 paged_attention_decode {tag} B={B} lengths {lengths.tolist()}: "
            f"max_err {err:.3e} (tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
            f"bound {bnd:.4f} ({by})")
        if dtype == torch.bfloat16:
            out["paged_attention_decode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                 bound_ms=bnd, bound_by=by, library_ms=None)

        # K6: the chunks of a 700-token prompt (C = 256, starts 0/256/512)
        C = 256
        t1 = table[5].contiguous()
        for start in (0, 256, 512):
            total = start + C
            q = rnd((C, H, hd), dtype)
            got = paged_attention.paged_attention_chunk(q, kp, vp, t1, start, total)
            want = paged_attention._chunk_reference(q, kp, vp, t1, start, total, hd ** -0.5)
            err = check_close("paged_attention_chunk", "attention", dtype, got, want)
            ms = device_ms(lambda: paged_attention.paged_attention_chunk(q, kp, vp, t1, start, total))
            plain = device_ms(lambda: paged_attention._chunk_reference(q, kp, vp, t1, start,
                                                                     total, hd ** -0.5))
            pairs = sum(min(start + c + 1, total) for c in range(C))
            bnd, by = bound_ms((2 * q.numel() + 2 * total * KVH * hd) * el + 4 * pps,
                               4 * H * hd * pairs, dtype)
            log(f"K6 paged_attention_chunk {tag} C={C} start={start}: max_err {err:.3e} "
                f"(tol {TOL[('attention', dtype)]}) ms {ms:.4f} plain {plain:.4f} "
                f"bound {bnd:.4f} ({by})")
            if dtype == torch.bfloat16 and start == 512:
                out["paged_attention_chunk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                    bound_ms=bnd, bound_by=by, library_ms=None)
    torch.cuda.synchronize()
    return out


# -------------------------------------------------------------- phase 3


def run_requests(server, requests):
    """All requests at once, one thread each -> (results, wall s, errors)."""
    results = [None] * len(requests)
    errors = []

    def run(i):
        try:
            results[i] = server(requests[i])
        except Exception as e:  # noqa: BLE001 — reported as this phase's failure
            errors.append(f"request {i}: {e!r}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    torch.cuda.synchronize()
    if any(t.is_alive() for t in threads):
        errors.append("a request did not finish in 600 s")
    return results, time.monotonic() - t0, errors


def profile_run(server, requests) -> None:
    """The same requests again under torch.profiler: device time by kernel
    and the card's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _results, wall, errors = run_requests(server, requests)
    if errors:
        fail(f"profiled run: {errors}")
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"profile: wall {wall:.3f}s, device busy {busy_s:.3f}s "
        f"({100 * busy_s / wall:.1f}% busy, {100 - 100 * busy_s / wall:.1f}% idle)")
    for dev_us, count, key in rows[:20]:
        log(f"  {dev_us / 1e3:10.3f} ms {count:7d}x  {key[:90]}")


@contextlib.contextmanager
def planted(fault):
    """Swap one of the engine's kernel wrappers for a wrong one while the
    block runs (the negative controls of the logprob gate)."""
    from ray_tpu_torch.serve import engine

    name, make = fault
    real = getattr(engine, name)
    setattr(engine, name, make(real))
    try:
        yield
    finally:
        setattr(engine, name, real)


# Engine faults the logprob gate must catch, each planted by wrapping the
# kernel wrapper the engine calls: name -> (engine attribute, wrapper maker)
FAULTS = {
    # decode attends over pos keys, not pos + 1: it misses its own key
    "decode_length_off_by_one": ("paged_attention_decode", lambda f: (
        lambda q, kp, vp, tables, lengths: f(q, kp, vp, tables, (lengths - 1).clamp(min=0)))),
    # each slot reads its neighbour's page table: pages of another sequence
    "decode_wrong_pages": ("paged_attention_decode", lambda f: (
        lambda q, kp, vp, tables, lengths: f(q, kp, vp, tables.roll(1, 0).contiguous(),
                                             lengths))),
    # chunked prefill: every row also sees the key one position ahead
    "chunk_mask_off_by_one": ("paged_attention_chunk", lambda f: (
        lambda q, kp, vp, table, start, total: f(q, kp, vp, table, start + 1, total))),
}


def within_logprob_tol(gap) -> bool:
    mx, mean = gap
    return mx <= LOGPROB_TOL["max"] and mean <= LOGPROB_TOL["mean"]


def logprob_gaps(params, cfg, requests, results, yardstick: bool = False) -> list:
    """Per request, (max, mean) of |engine logprob - log-softmax of the
    port's full forward| over the output tokens. With `yardstick`, also
    prints both against the same forward run in f32 over the same bf16
    weights, as a measure of bf16 rounding."""
    from ray_tpu_torch.models import transformer

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gaps = []
    for i, (req, res) in enumerate(zip(requests, results)):
        seq = req["prompt_ids"] + res["token_ids"]
        T = len(req["prompt_ids"])
        toks = torch.tensor([seq[:-1]], device="cuda")
        picked = torch.tensor(res["token_ids"], device="cuda")[:, None]

        def forward_logprobs(c):
            with torch.no_grad():
                logits, _ = transformer.forward(params, toks, c)
            return torch.log_softmax(logits[0, T - 1:], dim=-1).gather(1, picked)[:, 0]

        ref = forward_logprobs(cfg)
        got = torch.tensor(res["logprobs"], device="cuda", dtype=torch.float32)
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            fail(f"request {i}: non-finite logprobs")
        diff = (got - ref).abs()
        gaps.append((diff.max().item(), diff.mean().item()))
        if yardstick:
            ref32 = forward_logprobs(cfg32)
            log(f"request {i}: logprob |engine - forward| max {gaps[-1][0]:.4f} mean "
                f"{gaps[-1][1]:.4f} (tol {LOGPROB_TOL}); against the f32 forward: "
                f"engine max {(got - ref32).abs().max().item():.4f}, bf16 forward max "
                f"{(ref - ref32).abs().max().item():.4f}")
    return gaps


def serve_main_path(profile: bool) -> dict:
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.serve import LLMServer

    t0 = time.monotonic()
    server = LLMServer(model_name="llama3-8b",
                       engine_config=dict(max_batch_size=8, max_seq_len=1024), seed=0)
    torch.cuda.synchronize()
    cfg = server.engine.cfg
    log(f"phase 3: LLMServer llama3-8b (d_model {cfg.d_model}, layers {cfg.n_layers}, "
        f"heads {cfg.n_heads}/{cfg.kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) "
        f"built + warmed in {time.monotonic() - t0:.1f}s; "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    rng = torch.Generator().manual_seed(1)  # prompts: seeded, host-side

    def burst():
        def prompt(n):
            return torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()

        return [
            {"prompt_ids": prompt(23), "max_tokens": 32},
            {"prompt_ids": prompt(100), "max_tokens": 32},
            {"prompt_ids": prompt(200), "max_tokens": 32},
            {"prompt_ids": prompt(700), "max_tokens": 32},
            {"prompt_ids": prompt(50), "max_tokens": 32, "temperature": 0.8, "top_p": 0.9},
        ]

    requests = burst()
    dispatch.reset_launches()
    results, wall, errors = run_requests(server, requests)
    launches = dispatch.launch_counts()
    if errors:
        server.shutdown()
        fail(f"main path: {errors}")
    log(f"launches on the main path: {launches}")
    for name in dispatch.KERNELS:
        if launches[name] <= 0:
            fail(f"main path never launched kernel {name}")

    total_tokens = 0
    for i, (req, res) in enumerate(zip(requests, results)):
        n = len(res["token_ids"])
        if n != req["max_tokens"] or res["finish_reason"] != "length":
            fail(f"request {i}: {n} tokens, finish_reason {res['finish_reason']}")
        total_tokens += n
        log(f"request {i}: prompt {len(req['prompt_ids'])} tokens, ttft {res['ttft_s']:.3f}s, "
            f"latency {res['latency_s']:.3f}s, first tokens {res['token_ids'][:6]}")
    ttfts = sorted(r["ttft_s"] for r in results)
    tpots = sorted((r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1) for r in results)
    log(f"TTFT s: p50 {statistics.median(ttfts):.4f} max {ttfts[-1]:.4f}; time per output "
        f"token after the first, ms: p50 {1e3 * statistics.median(tpots):.2f} max "
        f"{1e3 * tpots[-1]:.2f} (decode tok/s per request p50 "
        f"{1 / statistics.median(tpots):.2f}); aggregate output tok/s "
        f"{total_tokens / wall:.2f} over {wall:.2f}s wall; {len(results)} requests, "
        f"0 failed")

    if profile:
        profile_run(server, requests)
    # the negative controls: a burst of fresh prompts (no prefix hits) per
    # planted fault
    faulted = []
    for name, fault in FAULTS.items():
        reqs = burst()
        with planted(fault):
            res, _wall, errs = run_requests(server, reqs)
        if errs:
            server.shutdown()
            fail(f"planted fault {name}: {errs}")
        faulted.append((name, reqs, res))
    server.shutdown()

    # the gate: the engine's logprobs against the port's own full forward,
    # which must pass the sound run and fail each planted fault
    params = server.engine.params
    sound = logprob_gaps(params, cfg, requests, results, yardstick=True)
    caught = {}
    for name, reqs, res in faulted:
        gaps = logprob_gaps(params, cfg, reqs, res)
        caught[name] = any(not within_logprob_tol(g) for g in gaps)
        log(f"planted fault {name}: logprob |engine - forward| per request max "
            f"{[round(g[0], 4) for g in gaps]} mean {[round(g[1], 4) for g in gaps]}")
    for i, gap in enumerate(sound):
        if not within_logprob_tol(gap):
            fail(f"request {i}: logprobs differ from the forward by max {gap[0]:.4f}, "
                 f"mean {gap[1]:.4f} (tol {LOGPROB_TOL})")
    for name, hit in caught.items():
        if not hit:
            fail(f"the logprob gate {LOGPROB_TOL} passes planted fault {name}")
    return {"launches": launches}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, serve the requests again under torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops import dispatch  # fails where the package is absent

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    t0 = time.monotonic()
    dispatch.library()
    log(f"phase 1: kernels built in {time.monotonic() - t0:.1f}s "
        f"(nvcc {dispatch.BUILD_INFO.get('seconds', 0.0):.1f}s)")
    with open(dispatch.BUILD_INFO["log"]) as f:
        for line in f:
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.rstrip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    figures = kernel_checks(gen)
    serve = serve_main_path(args.profile)
    kernels = []
    for name in dispatch.KERNELS:
        source, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": serve["launches"].get(name, 0), **figures.get(name, {})})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
