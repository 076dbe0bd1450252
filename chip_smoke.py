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
            kernel family and the device's idle share;
8. k1     — flash attention (K1) forward and backward against the plain
            version's autograd at LLaMA-2-7B attention shapes (B 2, S 2048,
            32 heads of 128, bf16, causal), plus a full (non-causal) and an
            Sq != Sk causal case and an f32 case, O and every gradient
            held row by row (``row_check``); CUDA-event timings of every
            kernel entry, the plain version and F.sdpa;
9. k2     — the same for GQA (K2): Hq 64 / Hkv 8 (llama2_70b attention),
            also held to the plain version with the splash kernel's
            rounding of q;
10. train_equal — f32, LLaMA-2-7B widths, 2 layers, B 1, S 256: three
            TrainSteps on the card (kernels) and on the CPU (plain
            versions) from the same weights and batches give the same
            losses, the same gradients at every step, and parameters
            apart only where a gradient sat at zero;
11. train — the slice: LLaMA-2-7B, full width and depth, bf16, recompute
            "full", fused linear cross-entropy, AdamW; B 2, S 2048, 2
            warm-up and 8 timed steps; tokens/s, MFU, peak memory, losses
            and the flash kernels' launch counts over the timed steps;
12. train_gqa — llama2_70b widths at 2 layers (GQA 64/8), recompute "dots",
            B 1, S 2048: 1 warm-up and 3 timed steps;
13. train_profile — two steps of `train` under torch.profiler.

Then the kernel table as one JSON line, the card's name and power limit,
and the contract's last line. ``--only k1,k2`` runs the named phases alone
(with the build), to iterate on a kernel: it ends in a ``partial_run`` line
and prints neither the kernel table nor the contract's last line, so only
a run of every phase (no arguments) reads as a passing smoke. Imports no
JAX and nothing of the JAX package.
"""
import copy
import gc
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
PHASES = ("k1", "k2", "adamw", "k4", "k5", "serve_equal", "slice",
          "profile", "train_equal", "train", "train_profile", "train_gqa")
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
    for kernel in ("flash_fwd", "flash_bwd_delta", "flash_bwd_dkdv",
                   "flash_bwd_dq"):
        if kernel + "_kernel" in name:
            return "flash_attention_" + kernel.removeprefix("flash_")
    if "adamw_kernel" in name:
        return "adamw_update"
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
    return _device_profile(
        "profile", lambda: eng.serve(prompts, max_new_tokens=new_tokens))

ROW_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}
FEW_KEYS = 32      # query rows seeing fewer keys: see flash_case


def row_check(got, want, elementwise, spare=None):
    """Flash output or gradient against a plain version, one row at a
    time: a row is one head's D values at one position (a query row of O
    and dQ, a key row of dK and dV), and its error
    ``||got_r - want_r||`` is held to ``ROW_TOL x (||want_r|| + 0.1 x
    rms_r)``, where ``rms_r`` is the RMS of all the rows' norms: the limit
    scales with each row's own size, and the small floor only spares rows
    whose exact value is 0 (dQ of the first query of a causal row). bf16:
    each rounding to bf16 errs by at most 2^-9 = 1.95e-3 of the value (RMS
    1.1e-3); the kernels round P and dS before their products and each
    output once, so a row of 128 values errs by some 2-5e-3 of its norm,
    and 1e-2 leaves a 2-5x margin while a kernel 10% off on any row fails
    by 10x. f32: summation order only. ``elementwise``: also hold every
    element to the (atol, rtol) of TOLERANCE. ``spare``: a bool per row;
    those rows past the limit are counted apart (``spared_rows``), not as
    failures. Returns the sizes compared, the largest ratio of a row's
    error to its limit's scale, and the failures."""
    import torch

    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    tol = ROW_TOL[str(got.dtype)]
    diff = g - w
    norm = w.norm(dim=-1)
    rms_row = float(norm.square().mean().sqrt())
    ratio = diff.norm(dim=-1) / (norm + 0.1 * rms_row)
    bad = ratio > tol
    out = {"max_abs_err": float(diff.abs().max()),
           "max_abs_want": float(w.abs().max()),
           "rms_want": float(w.square().mean().sqrt()),
           "rms_row_norm": rms_row, "row_ratio": float(ratio.max()),
           "row_tol": tol, "rows": int(g.shape[0])}
    if spare is not None:
        out["spared_rows"] = int((bad & spare).sum())
        out["row_ratio_unspared"] = float(ratio[~spare].max()) if bool(
            (~spare).any()) else 0.0
        bad &= ~spare
    out["bad_rows"] = int(bad.sum())
    out["bad_elements"] = 0
    if elementwise:
        atol, rtol = TOLERANCE[str(got.dtype)]
        out["bad_elements"] = int((diff.abs() > atol + rtol * w.abs()).sum())
    out["finite"] = bool(torch.isfinite(g).all())
    return out


def _few_keys(B, sq, sk, hq, causal, device="cuda"):
    """Per query row of a [B, Sq, Hq, D] tensor: does it see fewer than
    FEW_KEYS keys?"""
    import torch

    s = torch.arange(sq, device=device)
    seen = (s + sk - sq + 1).clamp(max=sk) if causal else torch.full_like(
        s, sk)
    return (seen < FEW_KEYS).repeat_interleave(hq).repeat(B)


def _visible_pairs(sq, sk, causal):
    """(query, key) pairs the mask lets through, per (batch, head)."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def _flash_bounds(B, sq, sk, hq, hkv, elt, causal):
    """{entry: (bytes, ops)}: each input read once, each output written
    once; ops of the products the visible pairs need (2 flops per
    multiply-add): forward Q K^T and P V; dK/dV also recomputes S and dP;
    dQ needs S, dP and dS K. `bwd` is the whole backward at 2.5x the
    forward's products."""
    pairs = _visible_pairs(sq, sk, causal) * B * hq
    nq, nk = B * sq * hq * D, B * sk * hkv * D
    rows = B * hq * sq * 4
    fwd_ops = 4 * pairs * D
    return {
        "fwd": ((2 * nq + 2 * nk) * elt + rows, fwd_ops),
        "bwd_delta": (2 * nq * elt + rows, 2 * nq),
        "bwd_dkdv": ((2 * nq + 4 * nk) * elt + 2 * rows, 2 * fwd_ops),
        "bwd_dq": ((3 * nq + 2 * nk) * elt + 2 * rows, 3 * fwd_ops // 2),
        "bwd": ((4 * nq + 4 * nk) * elt + 2 * rows, 5 * fwd_ops // 2),
    }


def flash_case(gen, B, sq, sk, hq, hkv, causal, dtype, timed):
    """One flash-attention case on the card: each kernel entry against its
    plain version on the same inputs, and forward and backward end to end
    against the plain version's autograd; with
    ``timed``, CUDA-event medians of every entry, the plain version and
    F.scaled_dot_product_attention (the library time)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do = rand((B, sq, hq, D)), rand((B, sq, hq, D))
    k, v = rand((B, sk, hkv, D)), rand((B, sk, hkv, D))
    scale = D ** -0.5

    def fwd_bwd(attn):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = attn(qq, kk, vv, causal, scale)
        out.backward(do)
        return out.detach(), qq.grad, kk.grad, vv.grad

    def held(got, want, names, spare=None):
        """{tensor: row_check}; O and f32 gradients also element by
        element; ``spare`` applies to dQ."""
        return {n: row_check(g, w, n == "o" or dtype == torch.float32,
                             spare if n == "dq" else None)
                for n, g, w in zip(names, got, want)}

    got = fwd_bwd(fa.FlashAttention.apply)
    torch.cuda.synchronize()
    plain = fwd_bwd(fa._attention_math)
    # each entry against its plain version on its own inputs: the forward
    # against the plain forward, the backward entries against the plain
    # backward given the kernel's stored O (``_attention_bwd_math``)
    checks = held(got, plain, ("o",))
    checks.update(held(got[1:], fa._attention_bwd_math(
        q, k, v, got[0], do, causal, scale), ("dq", "dk", "dv")))
    # end to end, against autograd of the plain forward: that takes delta
    # = rowsum(dO * O) from the f32 softmax where the kernels (and the
    # reference's TPU kernel) take the stored O, rounded to bf16; in a
    # query row that sees only a few keys P sits on one or two of them
    # and dQ nearly cancels, but delta's rounding does not, so those rows
    # of dQ are counted apart
    few = _few_keys(B, sq, sk, hq, causal)
    end_to_end = held(got[1:], plain[1:], ("dq", "dk", "dv"), few)
    splash = None
    if hq != hkv and dtype == torch.bfloat16:
        # the reference's splash kernel (K2) scales q in its storage dtype
        # before the products (paddle_tpu/ops/flash_attention.py:161); the
        # port's kernels scale the f32 scores, as K1 does: hold them to
        # that rounding end to end as well
        splash = held(got, fwd_bwd(lambda a, b, c, cz, s: fa._attention_math(
            (a * s).to(a.dtype), b, c, cz, 1.0)), ("o", "dq", "dk", "dv"),
            few)
    del plain
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_bwd_delta(out, do)
    want_delta = (out.float() * do.float()).sum(-1).transpose(1, 2)
    err = {name: c["max_abs_err"] for name, c in checks.items()}
    err["delta"] = compare(f"flash delta {hq}/{hkv}", delta,
                           want_delta.contiguous(), B)
    row = {"B": B, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv, "d": D,
           "causal": causal, "dtype": str(dtype), "max_abs_err": err,
           "checks": checks, "end_to_end": end_to_end}
    if splash is not None:
        row["end_to_end_splash_rounding"] = splash
    bad = [f"{against} {name}: {c}"
           for against, cs in (("entry", checks), ("end to end", end_to_end),
                               ("splash", splash or {}))
           for name, c in cs.items()
           if c["bad_rows"] or c["bad_elements"] or not c["finite"]]
    if bad:
        emit(row)
        raise AssertionError(f"flash {hq}/{hkv} causal={causal} {dtype}: "
                             + "; ".join(bad))
    if not timed:
        return row
    kern = {
        "fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
        "bwd_delta": cuda_ms(lambda: fa.flash_bwd_delta(out, do)),
        "bwd_dkdv": cuda_ms(lambda: fa.flash_bwd_dkdv(
            q, k, v, do, lse, delta, causal, scale)),
        "bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, causal, scale)),
        "fwd_bwd": cuda_ms(lambda: fwd_bwd(fa.FlashAttention.apply)),
    }
    qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
    plain_out = fa._attention_math(qp, kp, vp, causal, scale)

    def plain_grad(inputs):
        return lambda: torch.autograd.grad(plain_out, inputs, do,
                                           retain_graph=True)

    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: fa._attention_math(q, k, v, causal,
                                                       scale), reps=5,
                            warmup=1)
    plain = {
        "fwd": plain_fwd,
        "bwd_delta": cuda_ms(lambda: (out.float() * do.float()).sum(-1)
                             .transpose(1, 2).contiguous(), reps=5, warmup=1),
        "bwd_dkdv": cuda_ms(plain_grad((kp, vp)), reps=5, warmup=1),
        "bwd_dq": cuda_ms(plain_grad((qp,)), reps=5, warmup=1),
        "fwd_bwd": cuda_ms(lambda: fwd_bwd(fa._attention_math), reps=5,
                           warmup=1),
    }
    del plain_out
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(
            a, b, c, is_causal=causal, scale=scale, enable_gqa=hq != hkv)

    def sdpa_fwd_bwd():
        a, b, c = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa(a, b, c).backward(dot)

    library = {"fwd": cuda_ms(lambda: sdpa(qt, kt, vt)),
               "fwd_bwd": cuda_ms(sdpa_fwd_bwd)}
    bounds = {}
    for name, (nbytes, ops) in _flash_bounds(B, sq, sk, hq, hkv,
                                              q.element_size(),
                                              causal).items():
        b_ms, b_by = bound(nbytes, ops, str(dtype))
        bounds[name] = {"bytes": nbytes, "ops": ops, "bound_ms": b_ms,
                        "bound_by": b_by}
    row.update(kernel_ms=kern, plain_ms=plain, library_ms=library,
               bounds=bounds)
    return row


def phase_flash(phase, hq, hkv, seed):
    """``phase`` k1 (MHA) or k2 (GQA): the main case at the training
    path's shape (B 2, S 2048, causal, bf16), timed; for k1 also a full
    case, an Sq != Sk causal case with tails past every tile, and an f32
    case."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [dict(B=2, sq=2048, sk=2048, causal=True, dtype=torch.bfloat16,
                  timed=True)]
    if phase == "k1":
        cases += [dict(B=2, sq=2048, sk=2048, causal=False,
                       dtype=torch.bfloat16, timed=False),
                  dict(B=2, sq=1000, sk=1500, causal=True,
                       dtype=torch.bfloat16, timed=False)]
    cases += [dict(B=1, sq=300, sk=300, causal=True, dtype=torch.float32,
                   timed=False)]
    rows = []
    for c in cases:
        row = flash_case(gen, c["B"], c["sq"], c["sk"], hq, hkv, c["causal"],
                         c["dtype"], c["timed"])
        row["phase"] = phase
        emit(row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_adamw(seed=8):
    """The AdamW update kernel against its plain version on one LLaMA-2-7B
    MLP weight (11008 x 4096), bf16 and f32, after three updates from the
    same moments; CUDA-event timings of the kernel, the plain version and
    torch.optim.AdamW(fused=True).step() (the library time)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import adamw

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        shape = (11008, 4096)
        p0 = (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(
            dtype)
        grads = [(1e-3 * torch.randn(shape, generator=gen,
                                     device="cuda")).to(dtype)
                 for _ in range(3)]
        args = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                    factor=float(np.float32(1) - np.float32(1e-4 * 0.01)))
        states = []
        for tier in ("kernel", "plain"):
            p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
            for step, g in enumerate(grads, start=1):
                if tier == "kernel":
                    adamw.adamw_update(p, g, m, v, step=step, **args)
                else:
                    adamw._adamw_math(p, g, m, v, adamw._scalars(
                        p, args["lr"], args["beta1"], args["beta2"],
                        args["eps"], step, args["factor"]))
            states.append((p, m, v))
        torch.cuda.synchronize()
        # the tiers do the same operations in the same order, except that
        # PyTorch's CUDA division by a Python scalar multiplies by its
        # reciprocal (one f32 rounding apart), so a stored value may land
        # an ulp away and carry that into the next update: allow two ulps
        # of each value plus one ulp of the tensor's largest magnitude
        # (where a sum cancels), and count the elements that differ at all
        ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -24
        err, differ = 0.0, 0
        for name, got, want in zip("pmv", *states):
            g32, w32 = got.float(), want.float()
            diff = (g32 - w32).abs()
            bad = diff > 4 * ulp * w32.abs() + ulp * float(w32.abs().max())
            if bad.any():
                i = int(bad.flatten().nonzero()[0])
                raise AssertionError(
                    f"adamw {dtype} {name}: {int(bad.sum())} elements past "
                    f"tolerance, e.g. {float(g32.flatten()[i])} vs "
                    f"{float(w32.flatten()[i])}")
            err = max(err, float(diff.max()))
            differ += int((diff > 0).sum())
        n, elt = p0.numel(), p0.element_size()
        p, m, v = states[0]
        g = grads[0]
        ms = cuda_ms(lambda: adamw.adamw_update(p, g, m, v, step=4, **args))
        sc = adamw._scalars(p, args["lr"], args["beta1"], args["beta2"],
                            args["eps"], 4, args["factor"])
        plain_ms = cuda_ms(lambda: adamw._adamw_math(p, g, m, v, sc),
                           reps=5, warmup=1)
        lib_p = p.detach().clone().requires_grad_()
        lib_p.grad = g.clone()
        lib = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=0.01,
                                fused=True)
        lib_ms = cuda_ms(lib.step)
        nbytes, ops = 7 * n * elt, 20 * n
        b_ms, b_by = bound(nbytes, ops, str(dtype))
        row = {"phase": "adamw", "shape": list(shape), "dtype": str(dtype),
               "max_abs_err": err, "elements_differing": differ,
               "elements": 3 * n, "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "ops": ops}
        emit(row)
        rows.append(row)
        del states, grads, lib, lib_p
        torch.cuda.empty_cache()
    return rows


def _flash_counts():
    """Launch counts of the training path's kernels: the four flash
    entries and the AdamW update."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.adamw import adamw_update

    counts = {"flash_attention_" + k.__name__.removeprefix("flash_"):
              k.launches for k in fa.KERNELS}
    counts["adamw_update"] = adamw_update.launches
    return counts


def _reset_flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.adamw import adamw_update

    for k in fa.KERNELS:
        k.launches = 0
    adamw_update.launches = 0


def _trainer(cfg, seed, device="cuda", model=None):
    from paddle_tpu_torch.jit_api import TrainStep
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM, LlamaPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    if model is None:
        model = LlamaForCausalLM(cfg, device=device, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01)
    return model, TrainStep(model, LlamaPretrainingCriterion(cfg), opt,
                            device=device)


# a gradient element within this many times its row's card-vs-CPU noise
# is indistinguishable from 0; a lone element off by D adds D / sqrt(W)
# to the noise of a row of W >= 4096, so 10x that does not excuse it
NOISE_MULT = 10


def _record_gradients(step):
    """Keep, on the CPU, the gradients ``step`` hands its optimizer: one
    {name: gradient} per step."""
    names = {id(p): n for n, p in step.model.named_parameters()}
    record, apply = [], step.optimizer.apply_gradients

    def recording(params_grads, skip_update=False):
        params_grads = list(params_grads)
        record.append({names[id(p)]: g.detach().cpu()
                       for p, g in params_grads if g is not None})
        return apply(params_grads, skip_update=skip_update)

    step.optimizer.apply_gradients = recording
    return record


def _grad_report(rec_gpu, rec_cpu):
    """Per step and parameter, ``||g_card - g_cpu|| / ||g_cpu||``."""
    return [{n: float((g[n] - c[n]).norm() / c[n].norm().clamp_min(1e-30))
             for n in c} for g, c in zip(rec_gpu, rec_cpu)]


def _row_noise(g, c):
    """Per row of a weight (the whole tensor for a 1-D one), the RMS of
    the card-vs-CPU difference of its gradient over the elements either
    side left nonzero (an embedding's absent rows are exactly 0 on both):
    the local size of the summation noise, which differs from row to row
    (lm_head's rows of this batch's label tokens carry ~h / N, the others
    ~p h / N)."""
    import torch

    g2, c2 = g.reshape(-1, g.shape[-1]) if g.dim() > 1 else g[None], (
        c.reshape(-1, c.shape[-1]) if c.dim() > 1 else c[None])
    live = ((g2 != 0) | (c2 != 0)).sum(-1).clamp_min(1)
    return ((g2 - c2).square().sum(-1) / live).sqrt(), torch.Size(
        [g2.shape[-1]])


def _param_report(gpu_model, cpu_model, rec_gpu, rec_cpu, lr, beta1,
                  top=8):
    """Per parameter, |card - CPU| after the steps in units of lr: the
    median, the largest, the elements past 0.1 lr ("outliers") and how many
    of them are explained: at some step both sides' gradient, or both
    sides' first moment m = beta1 m + (1 - beta1) g, of the element lay
    within NOISE_MULT times its card-vs-CPU noise (the row's gradient noise,
    ``_row_noise``, carried through the same recurrence for m) without both
    being exactly 0. Adam's update m_hat / (sqrt(v_hat) + eps) is then the
    ratio of a value within noise of 0 to one that is not: summation noise
    sets its sign and size (a gradient near 0 at the first step, or a
    moment that cancels when a gradient changes sign). A lone element off
    by more than its row's noise stays unexplained. For the ``top`` largest
    differences overall, and up to 2 x ``top`` unexplained ones, the
    element's values and both sides' gradients and moments at every step
    beside their noise."""
    import torch

    per, cand, noise = {}, [], {}
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        d = (p.detach().cpu() - cpu_params[name].detach()).abs().flatten()
        out = (d > 0.1 * lr).nonzero().flatten()
        near = torch.zeros(out.numel(), dtype=torch.bool)
        noise[name] = []
        mg = mc = var_m = torch.zeros(out.numel())

        def within(a, b, nz):
            return (torch.maximum(a.abs(), b.abs()) <= NOISE_MULT * nz) & (
                (a != 0) | (b != 0))

        for g, c in zip(rec_gpu, rec_cpu):
            rows, (width,) = _row_noise(g[name], c[name])
            noise[name].append((rows, width))
            go, co = g[name].flatten()[out], c[name].flatten()[out]
            nz = rows[out // width]
            mg = beta1 * mg + (1 - beta1) * go
            mc = beta1 * mc + (1 - beta1) * co
            var_m = beta1 ** 2 * var_m + (1 - beta1) ** 2 * nz.square()
            near |= within(go, co, nz) | within(mg, mc, var_m.sqrt())
        per[name] = {"median_lr": float(d.median()) / lr,
                     "max_lr": float(d.max()) / lr,
                     "outliers": int(out.numel()),
                     "explained": int(near.sum())}
        vals, idx = d.topk(min(top, d.numel()))
        cand += [(float(v), name, int(i), "largest")
                 for v, i in zip(vals, idx)]
        cand += [(float(d[i]), name, int(i), "unexplained")
                 for i in out[~near][:top]]
    gpu_params = dict(gpu_model.named_parameters())

    def moments(rec, name, i):
        m, ms = 0.0, []
        for g in rec:
            m = beta1 * m + (1 - beta1) * float(g[name].flatten()[i])
            ms.append(m)
        return ms

    def detail(diff, name, i, why):
        return {"param": name, "index": i, "diff_lr": diff / lr,
                "p_gpu": float(gpu_params[name].detach().flatten()[i]),
                "p_cpu": float(cpu_params[name].detach().flatten()[i]),
                "grads_gpu": [float(g[name].flatten()[i]) for g in rec_gpu],
                "grads_cpu": [float(c[name].flatten()[i]) for c in rec_cpu],
                "row_noise": [float(rows[i // w]) for rows, w in noise[name]],
                "moments_gpu": moments(rec_gpu, name, i),
                "moments_cpu": moments(rec_cpu, name, i), "why": why}

    worst = [detail(*c) for c in sorted(
        (c for c in cand if c[3] == "largest"), reverse=True)[:top]]
    worst += [detail(*c) for c in cand if c[3] == "unexplained"][:2 * top]
    return per, worst


def phase_train_equal(seed=4, steps=3, rel_tol=1e-4, grad_tol=1e-4,
                      outlier_share=1e-5):
    """f32, LLaMA-2-7B widths, 2 layers, B 1, S 256, fused CE, recompute
    "full": three TrainSteps on the card (kernels) and on the CPU (plain
    versions) from the same weights and batches, every gradient handed to
    the optimizer kept. Held (f32: the two differ in summation order
    only): the losses within ``rel_tol`` relative; every parameter's
    gradient at every step within ``grad_tol`` in relative norm (Adam
    hides a wrong gradient's size, so this is the backward's witness); and
    the parameters in units of lr: at most ``outlier_share`` of the
    elements more than 0.1 lr apart, each explained by a gradient or a
    first moment within noise of zero (``_param_report``)."""
    import torch

    from paddle_tpu_torch.models.llama import llama2_7b

    cfg = llama2_7b(use_recompute=True, recompute_policy="full",
                    fuse_linear_cross_entropy=True)
    cfg.num_hidden_layers = 2
    cpu_model, cpu_step = _trainer(cfg, seed, device="cpu")
    gpu_model, gpu_step = _trainer(cfg, seed,
                                   model=copy.deepcopy(cpu_model).to("cuda"))
    rec_gpu, rec_cpu = _record_gradients(gpu_step), _record_gradients(cpu_step)
    ids = _tokens(seed, cfg.vocab_size, (steps, 1, 257))
    _reset_flash_counts()
    t0 = time.perf_counter()
    gpu = [float(gpu_step(i[:, :-1], i[:, 1:])) for i in ids]
    counts = _flash_counts()
    t_gpu = time.perf_counter() - t0
    cpu = [float(cpu_step(i[:, :-1], i[:, 1:])) for i in ids]
    t_cpu = time.perf_counter() - t0 - t_gpu
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu, cpu)]
    grad_rel = _grad_report(rec_gpu, rec_cpu)
    worst_grad = max(((r, k, n) for k, step in enumerate(grad_rel, 1)
                      for n, r in step.items()))
    by_step = [{"worst": max((r, n) for n, r in step.items())[::-1],
                "median": statistics.median(step.values())}
               for step in grad_rel]
    lr = gpu_step.optimizer.get_lr()
    with torch.no_grad():
        per, worst = _param_report(gpu_model, cpu_model, rec_gpu, rec_cpu,
                                   lr, gpu_step.optimizer._beta1)
    n_el = sum(p.numel() for p in cpu_model.parameters())
    outliers = sum(r["outliers"] for r in per.values())
    unexplained = outliers - sum(r["explained"] for r in per.values())
    emit({"phase": "train_equal", "layers": 2, "dtype": "float32", "B": 1,
          "S": 256, "losses_gpu": gpu, "losses_cpu": cpu, "rel_err": rel,
          "rel_tol": rel_tol,
          "grad_rel_worst": {"rel": worst_grad[0], "step": worst_grad[1],
                             "param": worst_grad[2]},
          "grad_rel_by_step": by_step,
          "grad_tol": grad_tol, "lr": lr, "elements": n_el,
          "param_outliers": outliers, "param_unexplained": unexplained,
          "outlier_share_limit": outlier_share,
          "param_median_diff_lr_max": max(r["median_lr"]
                                          for r in per.values()),
          "param_diff": per, "param_diff_worst": worst, "kernels": counts,
          "gpu_s": t_gpu, "cpu_s": t_cpu})
    if max(rel) > rel_tol:
        raise AssertionError(f"card and CPU losses differ: {gpu} vs {cpu}")
    if worst_grad[0] > grad_tol:
        raise AssertionError(f"card and CPU gradients differ: {worst_grad}")
    if outliers > outlier_share * n_el or unexplained:
        raise AssertionError(
            f"card and CPU parameters differ: {outliers} elements past "
            f"0.1 lr ({unexplained} with no gradient or moment within "
            "noise of 0)")
    if min(counts.values()) < 1:
        raise AssertionError(f"a flash kernel never launched: {counts}")
    del gpu_model, gpu_step, rec_gpu, rec_cpu
    gc.collect()
    torch.cuda.empty_cache()


def _tokens(seed, vocab, shape):
    """Token ids drawn uniformly by seed, as bench.py draws its batches."""
    import numpy as np

    return np.random.RandomState(seed).randint(
        0, vocab, shape).astype(np.int32)


def _train_run(phase, cfg, B, S, warmup, steps, seed, check_trend=True):
    """Warm-up steps, then ``steps`` timed steps with the kernels' counts
    taken over the timed steps alone; a fresh seeded batch every step.
    ``check_trend``: the loss must not rise over the steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    model, step = _trainer(cfg, seed)
    ids = _tokens(seed, cfg.vocab_size, (warmup + steps, B, S + 1))
    losses = [step(i[:, :-1], i[:, 1:]) for i in ids[:warmup]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    t0 = time.perf_counter()
    losses += [step(i[:, :-1], i[:, 1:]) for i in ids[warmup:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()
    losses = [float(x) for x in losses]
    tok_s = B * S * steps / wall
    flops = LlamaForCausalLM.flops_per_token(cfg, seq_len=S)
    L = cfg.num_hidden_layers
    want = {"flash_attention_fwd": 2 * L * steps,
            "flash_attention_bwd_delta": L * steps,
            "flash_attention_bwd_dkdv": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "adamw_update": len(list(model.parameters())) * steps}
    row = {"phase": phase, "layers": L, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads,
           "kv_heads": cfg.num_key_value_heads,
           "intermediate": cfg.intermediate_size, "dtype": cfg.dtype,
           "recompute": cfg.recompute_policy, "B": B, "S": S,
           "warmup_steps": warmup, "timed_steps": steps,
           "params": model.num_parameters(), "wall_s": wall,
           "step_ms": wall / steps * 1e3, "tokens_per_s": tok_s,
           "flops_per_token": flops, "mfu": flops * tok_s / 989e12,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses,
           "loss_slope_per_step": float(np.polyfit(np.arange(len(losses)),
                                                   losses, 1)[0]),
           "kernels": counts, "expected_kernels": want}
    emit(row)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, expected {want}")
    if not check_trend:
        return row, model, step, ids
    # uniform tokens hold the loss near its floor ln(vocab) at this lr, so
    # "not rising" is read against the step-to-step spread of the losses
    half = len(losses) // 2
    if np.mean(losses[half:]) > np.mean(losses[:half]) + np.std(losses):
        raise AssertionError(f"{phase}: loss rose {losses}")
    return row, model, step, ids


def phase_train(seed=0):
    """The slice: LLaMA-2-7B at full width and depth, bf16, as bench.py
    configures it (recompute "full", fused linear CE, AdamW lr 1e-4 and
    weight decay 0.01); B 2, S 2048, 2 warm-up and 8 timed steps."""
    from paddle_tpu_torch.models.llama import llama2_7b

    cfg = llama2_7b(dtype="bfloat16", use_recompute=True,
                    recompute_policy="full", fuse_linear_cross_entropy=True)
    return _train_run("train", cfg, B=2, S=2048, warmup=2, steps=8,
                      seed=seed)


def phase_train_gqa(seed=5):
    """llama2_70b widths (hidden 8192, Hq 64 / Hkv 8, intermediate 28672)
    at 2 layers, bf16, recompute "dots"; B 1, S 2048, 1 warm-up and 3
    timed steps."""
    import torch

    from paddle_tpu_torch.models.llama import llama2_70b

    cfg = llama2_70b(dtype="bfloat16", use_recompute=True,
                     recompute_policy="dots", fuse_linear_cross_entropy=True)
    cfg.num_hidden_layers = 2   # depth cut: 80 layers do not fit one card
    row, model, step, _ = _train_run("train_gqa", cfg, B=1, S=2048,
                                     warmup=1, steps=3, seed=seed,
                                     check_trend=False)
    del model, step
    torch.cuda.empty_cache()
    return row


def _device_profile(phase, fn):
    """Run ``fn`` under torch.profiler tracing the card only: device time
    by kernel family and the share of the wall time in which no kernel
    ran (the device's idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    row = {"phase": phase, "wall_s": wall, "device_events": len(spans),
           "device_busy_s": busy if spans else None,
           "idle_share": 1 - busy / wall if spans else None,
           "device_s": by_family,
           "top_other": sorted(other.items(), key=lambda kv: -kv[1])[:6]}
    emit(row)
    return row


def phase_train_profile(step, ids):
    """Two more steps of `train` under torch.profiler."""
    def two_steps():
        for i in ids[:2]:
            step(i[:, :-1], i[:, 1:])

    return _device_profile("train_profile", two_steps)


def kernel_table(rows):
    """The contract's kernel line, from the phases that ran: every entry's
    launches over the main path (serving's `slice`, training's `train`)."""
    table = []
    for name, phase, src, ref in (
            ("ragged_paged_attention", "k4",
             "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/ragged_paged_attention.py:258"),
            ("paged_decode_attention", "k5",
             "paddle_tpu_torch/ops/csrc/paged_attention.cu",
             "paddle_tpu/ops/paged_attention.py:155")):
        if phase not in rows:
            continue
        main_row = rows[phase][0]   # MHA: the shapes LLaMA-2-7B gives it
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": ref,
                      "launches": rows.get("slice", {}).get(
                          "kernels", {}).get(name),
                      "max_abs_err": max(r["max_abs_err"]
                                         for r in rows[phase]),
                      "ms": main_row["kernel_ms"],
                      "plain_ms": main_row["plain_ms"],
                      "bound_ms": main_row["bound_ms"],
                      "bound_by": main_row["bound_by"],
                      "library_ms": None})
    errs = {"fwd": ("o",), "bwd_delta": ("delta",), "bwd_dkdv": ("dk", "dv"),
            "bwd_dq": ("dq",)}
    for entry, keys in errs.items():
        if "k1" not in rows:
            break
        name = "flash_attention_" + entry
        src = ("paddle_tpu_torch/ops/csrc/flash_attention_fwd.cu"
               if entry == "fwd" else
               "paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu")
        main_row = rows["k1"][0]    # MHA, B 2, S 2048, causal, bf16
        flash_rows = rows["k1"] + rows.get("k2", [])
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": "paddle_tpu/ops/flash_attention.py:81",
               "launches": rows.get("train", {}).get("kernels", {}).get(name),
               "max_abs_err": max(r["max_abs_err"][k] for r in flash_rows
                                  for k in keys),
               "ms": main_row["kernel_ms"][entry],
               "plain_ms": main_row["plain_ms"][entry],
               "bound_ms": main_row["bounds"][entry]["bound_ms"],
               "bound_by": main_row["bounds"][entry]["bound_by"],
               "library_ms": (main_row["library_ms"]["fwd"]
                              if entry == "fwd" else None),
               "also_replaces": "paddle_tpu/ops/flash_attention.py:157 (GQA)"}
        if "k2" in rows:
            row["gqa_ms"] = rows["k2"][0]["kernel_ms"][entry]
            row["gqa_launches"] = rows.get("train_gqa", {}).get(
                "kernels", {}).get(name)
        table.append(row)
    if "adamw" in rows:
        main_row = rows["adamw"][0]    # bf16, as the 7B step runs it
        table.append({
            "name": "adamw_update", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/adamw.cu",
            "replaces": "paddle_tpu/optimizer/optimizers.py:51 (XLA-fused "
                        "in the compiled step; no Pallas kernel)",
            "launches": rows.get("train", {}).get("kernels", {}).get(
                "adamw_update"),
            "max_abs_err": max(r["max_abs_err"] for r in rows["adamw"]),
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    return table


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
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

    only = set(args.only.split(",")) if args.only else None
    if only and not only <= set(PHASES):
        ap.error(f"unknown phases {sorted(only - set(PHASES))}; "
                 f"known: {','.join(PHASES)}")

    def runs(phase):
        return only is None or phase in only

    rows = {}
    if runs("k1"):
        rows["k1"] = phase_flash("k1", HQ, HQ, seed=6)
    if runs("k2"):
        rows["k2"] = phase_flash("k2", 64, 8, seed=7)
    if runs("adamw"):
        rows["adamw"] = phase_adamw()
    if runs("k4"):
        rows["k4"] = phase_k4()
    if runs("k5"):
        rows["k5"] = phase_k5()
    if runs("serve_equal"):
        phase_serve_equal()
    if runs("slice"):
        rows["slice"], eng, prompts = phase_slice()
        if runs("profile"):
            phase_profile(eng, prompts)
        # free the serving model and engine before training
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        emit({"phase": "free_serving", "allocated_gb": held / 1e9})
        if held >= 1e9:
            raise AssertionError(f"serving left {held / 1e9:.2f} GB "
                                 "allocated")
    if runs("train_equal"):
        phase_train_equal()
    if runs("train"):
        rows["train"], model, step, ids = phase_train()
        if runs("train_profile"):
            phase_train_profile(step, ids)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    if runs("train_gqa"):
        rows["train_gqa"] = phase_train_gqa()

    if only is not None:
        # a partial run drove only some phases: no kernel table and no
        # contract line, so it never reads as a passing smoke
        emit({"partial_run": sorted(only), "complete": False})
        return 0
    print(smi, flush=True)
    emit({"kernels": kernel_table(rows)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
