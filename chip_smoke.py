#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each (any failed phase exits non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build  — compile every kernel under paddle_tpu_torch/ops/csrc;
3. K4     — ragged paged attention against its plain version at LLaMA-2-7B
            attention shapes (MHA, then GQA), with CUDA-event timings;
4. K5     — paged decode attention, likewise;
5. serve equality — LLaMA-2-7B widths, 2 layers, f32: greedy tokens served
            on the card (kernels) equal those served on the CPU (plain
            versions);
6. slice  — LLaMA-2-7B, full width and depth, bf16, seeded weights: 8
            requests through the ragged continuous-batching engine, with
            both kernels' launch counts taken over that run alone;
7. profile — the same traffic again under torch.profiler: device time by
            kernel family and the device's idle share.

Then the kernel table as one JSON line, and the contract's last line.
Imports no JAX and nothing of the JAX package.
"""
import copy
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12,   # dense tensor-core bf16
                  "torch.float32": 67e12}     # f32 outside the tensor cores
TOLERANCE = {"torch.bfloat16": (2e-2, 1e-2),  # (atol, rtol): bf16 output ulp
             "torch.float32": (1e-4, 1e-4)}   # summation order only
BS, D, HQ = 16, 128, 32            # LLaMA-2-7B attention: page 16, head 128
MAX_SEQS, MAX_LEN, CHUNK = 8, 2048, 256
PAGES_PER_SEQ = MAX_LEN // BS
NUM_PAGES = 1 + MAX_SEQS * PAGES_PER_SEQ


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` on the card, one event pair each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, got, want, valid_rows):
    """Max |got - want| over the valid rows; raises past the tolerance or
    on a non-finite output anywhere."""
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    g, w = got[:valid_rows].float(), want[:valid_rows].float()
    atol, rtol = TOLERANCE[str(got.dtype)]
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements past atol={atol} rtol={rtol}"
            f" (max abs err {float(err.max())})")
    return float(err.max())


def pools(gen, hkv, dtype):
    import torch

    shape = (hkv, NUM_PAGES, BS, D)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def page_table(rng):
    import numpy as np
    import torch

    perm = rng.permutation(np.arange(1, NUM_PAGES)).astype(np.int32)
    return torch.from_numpy(perm.reshape(MAX_SEQS, PAGES_PER_SEQ)).cuda()


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_k4(seed=1):
    """6 decode rows, one 256-token prefill chunk and one empty row:
    S = 8 rows in a T = 264 stream (2 pad tokens), the mixed dispatch's
    shapes; MHA then GQA (Hkv = 8)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = torch.bfloat16
    T = CHUNK + MAX_SEQS
    q_lens = np.array([1, 1, 1, CHUNK, 1, 0, 1, 1], np.int32)
    kv_lens = rng.randint(1, MAX_LEN + 1, MAX_SEQS).astype(np.int32)
    kv_lens[3] = max(kv_lens[3], CHUNK)
    kv_lens[q_lens == 0] = 0
    cu = np.zeros(MAX_SEQS + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    n_valid = int(cu[-1])
    rows = []
    for hkv in (HQ, 8):
        kp, vp = pools(gen, hkv, dtype)
        pt = page_table(rng)
        q = torch.randn((T, HQ, D), generator=gen, device="cuda").to(dtype)
        args = (q, kp, vp, torch.from_numpy(kv_lens).cuda(), pt,
                torch.from_numpy(cu).cuda())
        scale = D ** -0.5
        got = rpa.ragged_paged_attention(*args)
        torch.cuda.synchronize()
        want = rpa._ragged_math(*args, scale)
        err = compare(f"ragged_paged_attention Hkv={hkv}", got, want, n_valid)
        ms = cuda_ms(lambda: rpa.ragged_paged_attention(*args))
        plain_ms = cuda_ms(lambda: rpa._ragged_math(*args, scale), reps=5,
                           warmup=1)
        live = kv_lens[q_lens > 0].astype(np.int64)
        limits = np.concatenate([
            kv_lens[b] - q_lens[b] + np.arange(q_lens[b]) + 1
            for b in range(MAX_SEQS)]).astype(np.int64)
        elt = q.element_size()
        nbytes = (int(live.sum()) * hkv * D * 2 * elt + 2 * T * HQ * D * elt
                  + (kv_lens.nbytes + pt.numel() * 4 + cu.nbytes))
        ops = int(limits.sum()) * HQ * D * 4
        b_ms, b_by = bound(nbytes, ops, str(dtype))
        row = {"phase": "k4", "hkv": hkv, "hq": HQ, "d": D, "bs": BS,
               "T": T, "valid_tokens": n_valid, "q_lens": q_lens.tolist(),
               "kv_lens": kv_lens.tolist(), "dtype": str(dtype),
               "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "ops": ops}
        emit(row)
        rows.append(row)
        del kp, vp
    return rows


def phase_k5(seed=2):
    """B = 8 decode rows, kv lengths up to 2048; MHA then GQA (Hkv = 8)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = torch.bfloat16
    lengths = rng.randint(1, MAX_LEN + 1, MAX_SEQS).astype(np.int32)
    lengths[0] = 1      # a row frozen at the scratch page reads page 0
    rows = []
    for hkv in (HQ, 8):
        kp, vp = pools(gen, hkv, dtype)
        pt = page_table(rng)
        pt[0] = 0
        q = torch.randn((MAX_SEQS, HQ, D), generator=gen,
                        device="cuda").to(dtype)
        args = (q, kp, vp, torch.from_numpy(lengths).cuda(), pt)
        scale = D ** -0.5
        got = pa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        want = pa._paged_math(*args, scale)
        err = compare(f"paged_decode_attention Hkv={hkv}", got, want,
                      MAX_SEQS)
        ms = cuda_ms(lambda: pa.paged_decode_attention(*args))
        plain_ms = cuda_ms(lambda: pa._paged_math(*args, scale), reps=5,
                           warmup=1)
        elt = q.element_size()
        tokens = int(lengths.astype(np.int64).sum())
        nbytes = (tokens * hkv * D * 2 * elt + 2 * MAX_SEQS * HQ * D * elt
                  + lengths.nbytes + pt.numel() * 4)
        ops = tokens * HQ * D * 4
        b_ms, b_by = bound(nbytes, ops, str(dtype))
        row = {"phase": "k5", "hkv": hkv, "hq": HQ, "d": D, "bs": BS,
               "B": MAX_SEQS, "lengths": lengths.tolist(),
               "dtype": str(dtype), "max_abs_err": err, "kernel_ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": ops}
        emit(row)
        rows.append(row)
        del kp, vp
    return rows


def _counts():
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    return {"ragged_paged_attention": ragged_paged_attention.launches,
            "paged_decode_attention": paged_decode_attention.launches}


def _reset_counts():
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    ragged_paged_attention.launches = 0
    paged_decode_attention.launches = 0


def phase_serve_equal(seed=3):
    """f32, LLaMA-2-7B widths, 2 layers: the same 4 prompts served greedily
    on the card and on the CPU give the same token ids."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

    cfg = llama2_7b()
    cfg.num_hidden_layers = 2
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 33, 70, 130)]
    kw = dict(max_seqs=4, page_size=BS, max_len=256, decode_block=8,
              prefill_chunk=64)
    t0 = time.perf_counter()
    _reset_counts()
    got = ContinuousBatchingEngine(gpu_model, device="cuda", **kw).serve(
        prompts, max_new_tokens=16)
    counts = _counts()
    t_gpu = time.perf_counter() - t0
    want = ContinuousBatchingEngine(cpu_model, device="cpu", **kw).serve(
        prompts, max_new_tokens=16)
    t_cpu = time.perf_counter() - t0 - t_gpu
    same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
    emit({"phase": "serve_equal", "layers": 2, "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts], "new_tokens": 16,
          "identical": same, "kernels": counts,
          "gpu_s": t_gpu, "cpu_s": t_cpu})
    if not all(same):
        raise AssertionError(
            "card and CPU served different tokens: "
            + json.dumps([[g.tolist(), w.tolist()]
                          for g, w, s in zip(got, want, same) if not s]))
    if min(counts.values()) < 1:
        raise AssertionError(f"the card's serve launched no kernel: {counts}")
    del gpu_model
    torch.cuda.empty_cache()


def phase_slice(seed=0, new_tokens=64):
    """LLaMA-2-7B, full width and depth, bf16, seeded weights: 8 requests
    of 32-1024 prompt tokens and 64 new tokens each, greedy."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

    cfg = llama2_7b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    eng = ContinuousBatchingEngine(
        model, max_seqs=MAX_SEQS, page_size=BS, max_len=MAX_LEN,
        decode_block=8, prefill_chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in rng.randint(32, 1025, MAX_SEQS)]
    eng.serve([prompts[0][:16]], max_new_tokens=2)   # warm-up
    first = {}

    def on_token(rid, tok):
        first.setdefault(rid, time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = eng.serve(prompts, max_new_tokens=new_tokens, on_token=on_token)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    for p, o in zip(prompts, out):
        if o is None or len(o) != len(p) + new_tokens:
            raise AssertionError(f"request returned {None if o is None else len(o)}"
                                 f" tokens, expected {len(p) + new_tokens}")
        if not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise AssertionError("token id out of range")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    ttft = sorted(first[r] - t0 for r in range(len(prompts)))
    row = {"phase": "slice", "model": "llama2_7b", "layers": 32,
           "dtype": "bfloat16", "max_seqs": MAX_SEQS, "page_size": BS,
           "max_len": MAX_LEN, "decode_block": 8, "prefill_chunk": CHUNK,
           "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new_tokens, "wall_s": wall,
           "generated_tok_per_s": len(prompts) * new_tokens / wall,
           "ttft_median_s": statistics.median(ttft),
           "setup_s": t_setup, "decode_steps": eng.stats["decode_steps"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernels": counts}
    emit(row)
    return row, eng, prompts


def _family(name):
    """Kernel family of a device event, by the kernel's name."""
    if "ragged_paged_kernel" in name:
        return "ragged_paged_attention"
    if "paged_decode_kernel" in name:
        return "paged_decode_attention"
    if any(s in name.lower()
           for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "other"


def phase_profile(eng, prompts, new_tokens=64):
    """The slice's traffic once more, under torch.profiler tracing the card
    only: device time by kernel family, and the share of the serve's wall
    time in which no kernel ran (the device's idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_family, other = [], {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = ev.time_range
        spans.append((t.start, t.end))
        fam = _family(ev.name)
        by_family[fam] = by_family.get(fam, 0.0) + (t.end - t.start) / 1e6
        if fam == "other":
            other[ev.name[:96]] = other.get(ev.name[:96], 0.0) + (
                t.end - t.start) / 1e6
    busy, end = 0.0, None
    for s, e in sorted(spans):   # union of the kernels' intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy /= 1e6
    row = {"phase": "profile", "wall_s": wall, "device_events": len(spans),
           "device_busy_s": busy if spans else None,
           "idle_share": 1 - busy / wall if spans else None,
           "device_s": by_family,
           "top_other": sorted(other.items(), key=lambda kv: -kv[1])[:6]}
    emit(row)
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build()
    log = _build.BUILD_DIR / "build.log"
    log.write_text("\n".join(f"== {n}\n{b['log']}" for n, b in built.items()))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {n: b["seconds"] for n, b in built.items()},
          "log": str(log)})

    k4 = phase_k4()
    k5 = phase_k5()
    phase_serve_equal()
    sl, eng, prompts = phase_slice()
    phase_profile(eng, prompts)

    table = []
    for name, rows, src, ref in (
            ("ragged_paged_attention", k4,
             "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/ragged_paged_attention.py:258"),
            ("paged_decode_attention", k5,
             "paddle_tpu_torch/ops/csrc/paged_attention.cu",
             "paddle_tpu/ops/paged_attention.py:155")):
        main_row = rows[0]   # MHA: the shapes LLaMA-2-7B's path gives it
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": ref, "launches": sl["kernels"][name],
                      "max_abs_err": max(r["max_abs_err"] for r in rows),
                      "ms": main_row["kernel_ms"],
                      "plain_ms": main_row["plain_ms"],
                      "bound_ms": main_row["bound_ms"],
                      "bound_by": main_row["bound_by"],
                      "library_ms": None})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
