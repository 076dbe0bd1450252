#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each (any failed phase exits non-zero):

1. device — the card's name and power limit (nvidia-smi);
2. build  — compile every kernel under paddle_tpu_torch/ops/csrc;
3. k1     — flash attention (K1) forward and backward against the plain
            version's autograd at LLaMA-2-7B attention shapes (B 2, S 2048,
            32 heads of 128, bf16, causal), plus a full (non-causal) and an
            Sq != Sk causal case and an f32 case, O and every gradient
            held row by row (``row_check``) and the saved lse within
            1e-3; two launches of the dK/dV and dQ kernels bit for bit;
            CUDA-event timings of every kernel entry, the whole backward,
            the plain version and F.sdpa (its backward alone too); then
            the bf16 kernels' edges, forward and backward (Sq, Sk no
            multiple of 128, causal Sq < Sk, head dim 64, B x H < 132)
            and, for k1, 24 mixed-shape forwards on four streams at once,
            each equal bit for bit to the call alone, and the growing
            cache's decode shapes (causal Sq 1 and 7 against Sk 1000,
            forward only, row by row);
4. k2     — the same for GQA (K2): Hq 64 / Hkv 8 (llama2_70b attention),
            also held to the plain version with the splash kernel's
            rounding of q;
5. k3     — segment-masked flash attention (K3), held as k1 is: packed
            rows of LLaMA-2-7B attention (B 2, S 2048 packed from
            conversations of 64-1024 tokens, bf16, causal), MHA with K1's
            causal forward and forward + backward timed beside, GQA 64/8,
            an f32 case; the varlen form ([total, 32, 128], total no
            multiple of 64) causal and full, cross-offset, and with an
            empty key sequence; bounds from the visible pairs alone, and
            F.sdpa with the boolean segment mask as the library time; the
            edges as k1's, rows of 1-3 token segments, and dQ exactly 0
            on rows that see no key (dK, dV on keys no query sees);
6. k6     — ring attention (K6) over a sep-4 ring on the one card (B 1,
            S 4 x 2048 = 8192, D 128, bf16): causal MHA 32/32 and GQA
            64/8, timed, full MHA, and an f32 case at S 4 x 256.
            RingFlashAttention's output and gradients (K6 per kept visit,
            K1's backward entries) against the plain ring row by row, one
            K6 launch against its plain version, the public ring_attention
            equal to the kernel path; CUDA-event times of the ring forward
            and forward + backward beside K1 over the whole 8192 and F.sdpa
            over it; the edges (shards of 1000, head dim 64, Hq 4); two
            runs of the ring's backward bit for bit;
6a. adamw — the AdamW update kernel against its plain version, bf16 and
            f32, and its recipe instances (ADAMW_RECIPE_CASES: bf16 p with
            an f32 master, m, v or alone; with and without the loss scale,
            the clip factor, L1/L2 decay and the dynamics epilogue, whose
            sums are checked too) on one 7B MLP weight;
6b. grad_norm — the gradient-norm kernel (kernel A) against its plain
            version: the gradients of 2 layers at 7B widths plus the
            embedding and the head, bf16 and f32, without and with a
            scale, grouped; edge lists; a planted NaN, Inf and finite
            1e30; two launches bit for bit; torch._foreach_norm beside;
6c. wo_linear — the weight-only product (kernel C) against its plain
            version at LLaMA-2-7B's projections (4096 -> 4096, 4096 ->
            11008, 11008 -> 4096), int8 and int4 codes, bf16 and f32 x of
            1, 8, 24, 32, 40 and 64 rows, two launches bit for bit; codes
            and scales quantized on the card equal the CPU's; the edges
            (odd K, N no multiple of the 64-channel tile, and 65 rows
            taking the plain form); the bf16 rows timed (kernel ms, device
            ms with the L2 flushed, the bound, the plain version; at 8
            rows also with the L2 flushed by reads) beside torch.matmul
            over the bf16 weight, each call one launch of one kernel;
6d. moe_dispatch — kernels D and E (the MoE dispatch and combine),
            forward and backward (E's weight gradient too), against their
            plain versions (the reference's einsums over the dense
            routing) at Mixtral's training shape (T 4096, M 4096, E 8, k
            2, C 1228 as moe_train's gate computes it; timed: kernel ms,
            device ms with the L2 flushed, the bound, the plain version,
            the dense torch.einsum and index_select) and decode shape (T 8, C 4), bf16 and f32, and
            the edges (all first choices on one expert, tokens dropped in
            both choices, a zero-weight choice, an empty expert, k 1 and
            4, 21 (token, choice) pairs); the copies and the bf16 k <= 2
            sums exact, two launches bit for bit, refused operands raise;
7. codec  — the int8 KV codec on the card against the CPU: codes, scales
            and dequantized values bit-identical (zero, +-absmax and .5-tie
            rows included);
8. k4, k5 — ragged paged attention (K4) and paged decode attention (K5)
            against their plain versions at LLaMA-2-7B attention shapes
            (MHA, then GQA), over bf16 pools (bf16 q) and f32 pools (f32
            q), each launched twice for the same bits; then their edges
            for both pool types (``k4_edges``, ``k5_edges``): groups 1, 2,
            4 and 8 and head dim 64; for K5 lengths 1, bs, bs + 1, a
            split's span and one past it, the full 2048, and B 1; for K4
            an empty row, pad tokens (zeros), a fresh prefill, a chunk no
            multiple of the 64-pair tile, a chunk starting mid-page, a
            2-token prefill and a decode row at 2048; both also over
            64-token pages (MHA), the page size slice_online serves from;
9. k4_int8, k5_int8 — the same over int8 pools, q in bf16 and f32, and
            the same edges (``k4_int8_edges``, ``k5_int8_edges``). Each of
            k4, k5, k4_int8 and k5_int8 reports ``device_ms`` beside the
            single-call ``kernel_ms``: the summed device time of every
            kernel one call launches (tiles, split and merge), from
            torch.profiler's kernel events over 20 calls with the L2
            flushed before each;
10. serve_equal — LLaMA-2-7B widths, 1 layer, f32: tokens served on the
            card (kernels) equal those served on the CPU (plain versions),
            in four runs: float pools greedy, int8 pools greedy, float
            pools sampled, float pools with the prefix cache;
10a. serve_surface_equal — the same setting, the engine's surface card
            vs CPU: the legacy ladder (ragged=False) greedy over float and
            int8 pools (the insert's int8 codes bit for bit), with the
            prefix cache and prefill_chunk, rank-8 LoRA adapters beside
            base rows (ragged and legacy), sampling_overrides; then on the
            card a zero-weight adapter against the base serve, a request
            exported, detached and adopted by a second engine, and a
            legacy engine after warmup. The legacy runs launch K5 and no
            K4;
10b. frontend_equal — serve_equal's model and seed at 2 layers through
            the port's ServingFrontend, card against CPU: (a) 2 ragged replicas, 8
            requests (4 interactive of 8-24 tokens, 4 batch of 100-300),
            16 new each: the CPU frontend's tokens and each device's
            single-engine serve's, each replica completing a request and
            launching K4 and K5 (counted per dispatcher thread); (b) roles
            prefill/decode over the spool and over the wire: (a)'s tokens,
            handoffs published = adopted > 0, none corrupt or stale; (c)
            serving.replica_kill mid-stream: (a)'s tokens, rerouted >= 1;
            (d) a queue bound of 2: Overloaded for the excess, (a)'s tokens
            for the admitted; (e) replicas that build the paged libraries
            themselves into an empty build directory, the heartbeat
            deadline 1.5x the longer build: their beats go stale past it
            during the two builds, the monitor's lock probe spares them,
            none is killed. A differing request passes
            only at an explained near tie;
11. slice — LLaMA-2-7B's full width at SLICE_LAYERS (16) of its 32
            layers, bf16, seeded weights: 8
            requests through the ragged continuous-batching engine, with
            both kernels' launch counts taken over that run alone;
12. profile — the same traffic again under torch.profiler: device time by
            kernel family and the device's idle share;
13. slice_int8 — the slice over int8 KV pools: the int8 kernels' launch
            counts (and none of the float ones), the pools' size and the
            share of tokens equal to the bf16 slice's; then its prompts
            once more with 16 new tokens under torch.profiler;
14. slice_sampled_prefix — the same model, float pools, the prefix cache
            and sampling: one request carrying a 512-token system prompt,
            then 8 that share it; prefix_hit_pages must be > 0; then the 8
            once more with 16 new tokens under torch.profiler;
14b. slice_surface — `slice`'s model and requests through the legacy
            ladder (prefill_chunk 256, with the dense prefill's share of
            the wall), a legacy engine after warmup (its seconds, and the
            first request's TTFT beside a cold engine's), and the ragged
            plane with 4 rank-16 adapters on 6 of the 8 requests:
            tokens/s, TTFT, decode steps, peak memory, K4/K5 launches and
            the share of tokens equal to `slice`'s;
14c. slice_online — LLaMA-2-7B uncut (32 layers) served online through
            the port's
            ServingFrontend at bench_serving.py's TPU load (2 replicas of
            max_seqs 4, page_size 64, max_len 2048, decode_block 32,
            prefill_chunk 512; 4 batch prompts of 1024-1536 tokens with 64
            new, 12 interactive of 8-24 with 32 new), in its `baseline`
            (sync, monolithic prefill, ragged=False, one shared lock) and
            `pipelined` (the defaults) modes, each with its TTFT-under-
            prefill probe (one replica, 6 shorts behind a long prompt),
            then its role-split block: tokens/s, TTFT p50/p99, interactive
            TTFT p50, TPOT p50, errors (0), handoffs, K4/K5 launches per
            mode and per replica, peak memory, and serving_report()'s
            goodput, devprof and memory blocks (telemetry on);
14d. generate_equal — f32, LLaMA-2-7B widths, 1 layer: generate on the
            card and on the CPU gives the same tokens: greedy (B 4,
            prompts of 100, 32 new), an attention_mask batch, sampled,
            beam K 4, speculative with a 1-layer draft (equal to each
            device's greedy), and int8 and int4 weight-only greedy with
            kernel C's exact launches; then a growing-cache decode on K1
            (exact launches, logits against the CPU and the fixed cache);
14e. generate — LLaMA-2-7B bf16 at GEN_LAYERS (16) of 32, bench.py
            run_decode's
            traffic (B 8, prompts of 512, 256 new): tokens/s, decode ms a
            step, HBM share, peak memory and a profiled decode; then
            speculative with an 8-layer draft (gamma 4), beam K 4 at B 2,
            and int8 and int4 weight-only with the head kept bf16 (kernel
            C's exact launches, each profiled);
15. train_equal — f32, LLaMA-2-7B widths, 1 layer, B 1, S 256: two
            TrainSteps on the card (kernels) and on the CPU (plain
            versions) from the same weights and batches give the same
            losses, the same gradients at every step, and parameters
            apart only where a gradient sat at zero;
16. train_packed_equal — the same on packed rows (S 256 cut into 3-5
            segments, through K3), then each segment's logits from the
            packed row against its standalone forward (K1) on the card;
16a. train_equal_s1024 — `train_equal` on K1's path at B 1 x S 1024, two
            steps: the witness that rule (a) of the parameter check, set
            at S 256, leaves outliers here on K1 too; the amplified rule
            (``_param_report``) explains them, and planted faults stay
            unexplained;
16b. train_cp_equal — `train_equal` under context parallelism: B 1 x S
            1024, sep 4 (S_local 256), two DistributedTrainSteps on the
            card and the CPU, the ring and then Ulysses, with the amplified
            rule as in 16a; on the card the first step's loss equals the
            no-mesh loss within 1e-5 relative;
16c. train_recipe_equal — the training recipe card against CPU: f32,
            7B widths, 1 layer, B 1 x S 256, 4 TrainSteps under LLaMA 2's
            AdamW, a warm-up + cosine schedule, a global-norm clip that
            clips, a dynamic loss scaler whose first step overflows and
            dynamics spilling every step: losses, gradients, parameters,
            lr, skip and scale sequences, clip factors, dynamics sums and
            exact launches (kernel A, kernel B's master-less general
            instance);
16d. moe_equal — f32, bench.py MOE_RUNG's widths (hidden 1024, 16
            heads, 8 experts, top-2) at 2 layers: `train_equal`'s two
            TrainSteps (B 1, S 256) through make_loss_fn, with every
            layer's slots identical card vs CPU and the aux loss within
            1e-5; then greedy generate (B 4, prompts of 100, 16 new) and
            the engine's greedy serve (4 requests of 32-200, 16 new):
            tokens identical, or the first differing draw at an explained
            near tie; D and E launch once a layer per forward;
17. train — the slice: LLaMA-2-7B, full width and depth, bf16, recompute
            "full", fused linear cross-entropy, AdamW; B 2, S 2048, 2
            warm-up and 8 timed steps; tokens/s, MFU, peak memory, losses
            and the launch counts of the flash kernels, AdamW and the
            gradient-norm kernel (the non-finite guard's, once a step)
            over the timed steps;
18. train_profile — two steps of `train` under torch.profiler;
19. train_packed — SFT packing on `train`'s model and optimizer: B 2 x S
            2048 of k3's packed rows, 2 warm-up and 8 timed steps, K3's
            exact launch counts and none of K1's, tokens/s and MFU over
            the conversations' tokens and visible pairs (the padding tail
            is no work; the figures counting it beside), `train`'s step
            time beside; two steps profiled;
19a. train_cp — context-parallel training on `train`'s model and AdamW:
            B 2 x S 4096 through DistributedTrainStep under a sep-4 mesh
            over cuda:0, 2 warm-up and 5 timed steps, the ring's exact
            launch counts and no K1 forward; then the same model with no
            mesh (K1 over the whole 4096), step ms, tokens/s, MFU and peak
            memory of both, and two steps of each profiled;
20. train_gqa — llama2_70b widths at 2 layers (GQA 64/8), recompute "dots",
            B 1, S 2048: 1 warm-up and 3 timed steps;
21. train_recipe — LLaMA-2-7B widths cut to 16 layers, bf16, B 2, S
            2048: `train`'s plain recipe, then LLaMA 2's (f32 master
            weights, clip 1.0, warm-up + cosine, StepMetricsBus,
            PADDLE_DYNAMICS=1), 2 warm-up and 5 timed steps each: step ms,
            tokens/s, MFU (the bus's beside), peak memory, exact launches
            of K1, kernel A and kernel B's master instance;
22. moe_train — Mixtral-8x7B's widths cut to 4 layers, bf16, B 2 x S
            2048, fused CE, make_loss_fn, AdamW: 2 warm-up and 5 timed
            steps; step ms, tokens/s, MFU by the reference's
            flops_per_token and by the active count (and the E x C slots
            computed), peak memory under 80 GB, dropped choices per layer,
            exact launches (K2's entries, D and E per layer, kernel A);
            two steps profiled;
23. moe_generate — that model greedy: bench.py run_decode's traffic (B
            8, 512 + 256), then the engine serving `slice`'s 8 requests
            with 64 new tokens (K4, K5, D and E launched).

Then the kernel table as one JSON line, the card's name and power limit,
and the contract's last line. ``--only k1,k2`` runs the named phases alone
(with the build), to iterate on a kernel (``--only k3,train_packed_equal,
train_packed`` for the packed path, ``--only k6,train_equal_s1024,
train_cp_equal,train_cp`` for context parallelism, ``--only
grad_norm,adamw,train_recipe_equal,train_recipe`` for the training
recipe, ``--only wo_linear,generate_equal,generate`` for generation and
weight-only quantization, ``--only moe_dispatch,moe_equal,moe_train,
moe_generate`` for mixture of experts, ``--only serve_surface_equal,
slice_surface`` for the engine's surface, with `slice` run for it,
``--only frontend_equal,slice_online`` for the serving control plane): it
ends in a
``partial_run`` line
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
PHASES = ("k1", "k2", "k3", "k6", "adamw", "grad_norm", "wo_linear",
          "moe_dispatch", "codec",
          "k4", "k5", "k4_int8", "k5_int8", "serve_equal",
          "serve_surface_equal", "frontend_equal", "slice", "profile",
          "slice_int8", "slice_sampled_prefix", "slice_surface",
          "slice_online", "generate_equal",
          "generate",
          "train_equal", "train_packed_equal",
          "train_equal_s1024", "train_cp_equal", "train_recipe_equal",
          "moe_equal", "train", "train_profile", "train_packed", "train_cp",
          "train_gqa", "train_recipe", "moe_train", "moe_generate")
MAX_SEQS, MAX_LEN, CHUNK = 8, 2048, 256
PROFILE_NEW_TOKENS = 16   # profiles of slice_int8 and slice_sampled_prefix
#: depth cuts that keep the call inside its 1200 s budget on a slow host
#: (one whose host-bound phases run 1.5x longer), made when
#: frontend_equal and slice_online joined it: the f32 card-vs-CPU serving
#: and generation phases (serve_equal, serve_surface_equal,
#: generate_equal) at 1 layer of 2; the `slice` family (slice, profile,
#: slice_int8, slice_sampled_prefix, slice_surface) and `generate` at 16
#: layers of 32. slice_online keeps all 32, and the training *_equal
#: phases their 2 (at 1 layer train_equal's parameter rule leaves an
#: element it cannot explain)
EQUAL_LAYERS = 1
SLICE_LAYERS = 16
GEN_LAYERS = 16


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase row also gets the seconds since the start."""
    if "phase" in obj:
        obj["t_s"] = round(time.perf_counter() - T0, 1)
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


L2_FLUSH_BYTES = 64 << 20          # > the H100's 50 MB L2


def device_ms(fn, calls=20, warmup=2, clean=False):
    """Device milliseconds of one ``fn()``: the summed durations of every
    kernel it launches once (a split pass and its merge alike), each the
    mean of torch.profiler's CUDA kernel events over ``calls`` calls, with
    the L2 flushed before each by a 64 MB write (a decode step finds a
    layer's pages cold). The write leaves the L2 full of dirty lines,
    which the call's first reads write back to HBM; ``clean`` flushes by
    reading 64 MB instead (clean lines, as the other layers' weights leave
    the L2 in a decode step). Returns (ms, {kernel name: ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    sink = torch.empty((), device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_name = {}
    # a profiling session can come back without device events (seen once
    # in some fifty sessions of a call): the measurement is taken again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                if clean:
                    torch.sum(flush, dim=0, out=sink)
                else:
                    flush.fill_(float(i))
                fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or "FillFunctor" in ev.name
                    or (clean and "reduce_kernel" in ev.name)):
                continue
            t = ev.time_range
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + (t.end - t.start), n + 1)
        if by_name:
            break
    if not by_name:
        raise AssertionError("device_ms: the profiler saw no kernel")
    # each kernel of these calls launches once a call: its mean over the
    # events the profiler kept (it can drop some under load)
    per_call = {name[:120]: us / n / 1e3 for name, (us, n) in by_name.items()}
    return sum(per_call.values()), per_call


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


def pools(gen, hkv, dtype, d=D, bs=BS):
    import torch

    shape = (hkv, 1 + MAX_SEQS * (MAX_LEN // bs), bs, d)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def page_table(rng, bs=BS):
    import numpy as np
    import torch

    pages_per_seq = MAX_LEN // bs
    perm = rng.permutation(np.arange(1, 1 + MAX_SEQS * pages_per_seq))
    return torch.from_numpy(perm.astype(np.int32).reshape(
        MAX_SEQS, pages_per_seq)).cuda()


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_pools(gen, hkv, d=D, bs=BS):
    """An int8 K/V pool pair: seeded f32 rows quantized on the card."""
    import torch

    from paddle_tpu_torch.ops.quantization import quantize_pages

    kf, vf = pools(gen, hkv, torch.float32, d, bs)
    return quantize_pages(kf), quantize_pages(vf)


def same_bits(name, fn):
    """Two launches of ``fn`` give the same bits (the paged kernels' split
    partials and tile groups merge in a fixed order, with no atomics)."""
    import torch

    a = fn()
    b = fn()
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int16 if a.element_size() == 2
                              else torch.int32),
                       b.view(torch.int16 if b.element_size() == 2
                              else torch.int32)):
        raise AssertionError(f"{name}: two launches differ in "
                             f"{int((a != b).sum())} elements")
    return True


EDGE_CONFIGS = (   # (hkv, hq, d): groups 1, 2, 4, 8 and head dim 64
    (32, 32, 128), (16, 32, 128), (8, 32, 128), (4, 32, 128), (8, 32, 64))
#: the page size of bench_serving.py's TPU configuration (slice_online)
BS_WIDE = 64


def pool_runs(pool):
    """(q dtype, ...) for a pool type: an int8 pool is read by a bf16 and
    by an f32 q, a float pool by a q of its own dtype."""
    import torch

    if pool == "int8":
        return (torch.bfloat16, torch.float32)
    return (getattr(torch, pool),)


def make_pools(gen, hkv, pool, d=D, bs=BS):
    """A K/V pool pair of type ``pool`` (int8, bfloat16, float32) of
    ``bs``-token pages."""
    import torch

    if pool == "int8":
        return int8_pools(gen, hkv, d, bs)
    return pools(gen, hkv, getattr(torch, pool), d, bs)


def pool_label(pool):
    return " int8 pool" if pool == "int8" else f" {pool} pool"


def k5_edges(seed, pool):
    """K5 over pools of type ``pool`` at its edges (an int8 pool with q
    bf16 and f32, a float pool with q of its dtype), against the plain
    version within TOLERANCE, every output finite: per group and head dim,
    rows of length 1 (frozen at page 0), bs, bs + 1, a split's span and one
    past it, two spans and a few, the full MAX_LEN and one in between;
    then B 1; then the MHA rows over 64-token pages (``BS_WIDE``, the page
    size slice_online serves from). Returns one row per case."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    cases = ([(c, False, BS) for c in EDGE_CONFIGS]
             + [((32, 32, 128), True, BS), ((32, 32, 128), False, BS_WIDE)])
    for (hkv, hq, d), single, bs in cases:
        splits, per = pa.kv_split_plan(MAX_LEN // bs, hkv,
                                       pa.num_sms(torch.device("cuda")))
        span = per * bs
        kp, vp = make_pools(gen, hkv, pool, d, bs)
        pt = page_table(rng, bs)
        if single:      # B 1
            lengths = np.array([1337], np.int32)
            pt = pt[:1].contiguous()
        else:
            lengths = np.array([1, bs, bs + 1, span, span + 1,
                                min(2 * span + 5, MAX_LEN), MAX_LEN, 700],
                               np.int32)
            pt[0] = 0   # the frozen row reads the scratch page
        q32 = torch.randn((len(lengths), hq, d), generator=gen,
                          device="cuda")
        lens = torch.from_numpy(lengths).cuda()
        for dtype in pool_runs(pool):
            q = q32.to(dtype)
            scale = d ** -0.5
            got = pa.paged_decode_attention(q, kp, vp, lens, pt)
            torch.cuda.synchronize()
            want = pa._paged_math(q, kp, vp, lens, pt, scale)
            case = (f"k5 edge hkv={hkv} hq={hq} d={d} B={len(lengths)}"
                    f" bs={bs} {dtype}{pool_label(pool)}")
            rows.append({"case": case, "lengths": lengths.tolist(),
                         "page_size": bs,
                         "splits": splits, "pages_per_split": per,
                         "max_abs_err": compare(case, got, want,
                                                len(lengths))})
        del kp, vp
    return rows


def k4_edges(seed, pool):
    """K4 over pools of type ``pool`` at its edges (q types as
    ``k5_edges``), against the plain version within TOLERANCE, every
    output finite and the pad tokens zero: per group and head dim, one
    stream holding a decode row at MAX_LEN, an empty row, a fresh prefill
    (kv_len = q_len = 100), a chunk of 77 tokens (no multiple of a tile), a
    40-token chunk starting mid-page (kv 1010), a short decode row, a
    2-token prefill, and 3 pad tokens; then the MHA stream over 64-token
    pages (``BS_WIDE``). Returns one row per case."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_lens = np.array([1, 0, 100, 77, 40, 1, 2, 0], np.int32)
    kv_lens = np.array([MAX_LEN, 0, 100, 300, 1010, 17, 2, 0], np.int32)
    cu = np.zeros(MAX_SEQS + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    n_valid = int(cu[-1])
    T = n_valid + 3
    rows = []
    cases = [(c, BS) for c in EDGE_CONFIGS] + [((32, 32, 128), BS_WIDE)]
    for (hkv, hq, d), bs in cases:
        kp, vp = make_pools(gen, hkv, pool, d, bs)
        pt = page_table(rng, bs)
        q32 = torch.randn((T, hq, d), generator=gen, device="cuda")
        args_i = (torch.from_numpy(kv_lens).cuda(), pt,
                  torch.from_numpy(cu).cuda())
        for dtype in pool_runs(pool):
            q = q32.to(dtype)
            scale = d ** -0.5
            got = rpa.ragged_paged_attention(q, kp, vp, *args_i)
            torch.cuda.synchronize()
            want = rpa._ragged_math(q, kp, vp, *args_i, scale)
            case = (f"k4 edge hkv={hkv} hq={hq} d={d} bs={bs} "
                    f"{dtype}{pool_label(pool)}")
            err = compare(case, got, want, n_valid)
            if (got[n_valid:] != 0).any():
                raise AssertionError(f"{case}: pad tokens not zero")
            rows.append({"case": case, "q_lens": q_lens.tolist(),
                         "kv_lens": kv_lens.tolist(), "T": T,
                         "page_size": bs,
                         "max_abs_err": err})
        del kp, vp
    return rows


def pool_row_bytes(hkv, quant, elt):
    """Bytes of one token's K and V rows over all kv heads: D codes plus a
    4-byte scale each for an int8 pool, D elements of q's type else."""
    return 2 * hkv * ((D + 4) if quant else D * elt)


def phase_k4(seed=1, quant=False):
    """6 decode rows, one 256-token prefill chunk and one empty row:
    S = 8 rows in a T = 264 stream (2 pad tokens), the mixed dispatch's
    shapes; MHA then GQA (Hkv = 8), each over bf16 pools (bf16 q) and f32
    pools (f32 q). ``quant``: the int8 variant over an int8 pool, with q in
    bf16 and in f32. Each run is held to the plain version, launched twice
    for the same bits and timed; then the edges (``k4_edges``) for each
    pool type."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    phase = "k4_int8" if quant else "k4"
    kinds = ("int8",) if quant else ("bfloat16", "float32")
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
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
        pt = page_table(rng)
        q32 = torch.randn((T, HQ, D), generator=gen, device="cuda")
        for pool in kinds:
            kp, vp = make_pools(gen, hkv, pool)
            for dtype in pool_runs(pool):
                q = q32.to(dtype)
                args = (q, kp, vp, torch.from_numpy(kv_lens).cuda(), pt,
                        torch.from_numpy(cu).cuda())
                scale = D ** -0.5
                name = f"ragged_paged_attention Hkv={hkv} {dtype}" + (
                    pool_label(pool))
                got = rpa.ragged_paged_attention(*args)
                torch.cuda.synchronize()
                want = rpa._ragged_math(*args, scale)
                err = compare(name, got, want, n_valid)
                ms = cuda_ms(lambda: rpa.ragged_paged_attention(*args))
                dev_ms, dev_kernels = device_ms(
                    lambda: rpa.ragged_paged_attention(*args))
                plain_ms = cuda_ms(lambda: rpa._ragged_math(*args, scale),
                                   reps=5, warmup=1)
                live = kv_lens[q_lens > 0].astype(np.int64)
                limits = np.concatenate([
                    kv_lens[b] - q_lens[b] + np.arange(q_lens[b]) + 1
                    for b in range(MAX_SEQS)]).astype(np.int64)
                elt = q.element_size()
                nbytes = (int(live.sum()) * pool_row_bytes(hkv, quant, elt)
                          + 2 * T * HQ * D * elt
                          + (kv_lens.nbytes + pt.numel() * 4 + cu.nbytes))
                ops = int(limits.sum()) * HQ * D * 4
                b_ms, b_by = bound(nbytes, ops, str(dtype))
                row = {"phase": phase, "hkv": hkv,
                       "hq": HQ, "d": D, "bs": BS, "T": T,
                       "valid_tokens": n_valid, "q_lens": q_lens.tolist(),
                       "kv_lens": kv_lens.tolist(), "dtype": str(dtype),
                       "pool": pool, "max_abs_err": err, "kernel_ms": ms,
                       "device_ms": dev_ms, "device_kernels": dev_kernels,
                       "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "ops": ops,
                       "same_bits": same_bits(
                           name, lambda: rpa.ragged_paged_attention(*args))}
                emit(row)
                rows.append(row)
            del kp, vp
    edges = []
    for pool in kinds:
        cases = k4_edges(seed + 100, pool)
        emit({"phase": phase + "_edges", "pool": pool, "cases": cases})
        edges += cases
    rows[0]["edge_max_abs_err"] = max(r["max_abs_err"] for r in edges)
    return rows


def phase_k5(seed=2, quant=False):
    """B = 8 decode rows, kv lengths up to 2048; MHA then GQA (Hkv = 8),
    each over bf16 pools (bf16 q) and f32 pools (f32 q). ``quant``: the
    int8 variant over an int8 pool, with q in bf16 and in f32. Each run is
    held to the plain version, launched twice for the same bits and timed;
    then the edges (``k5_edges``) for each pool type."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    phase = "k5_int8" if quant else "k5"
    kinds = ("int8",) if quant else ("bfloat16", "float32")
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lengths = rng.randint(1, MAX_LEN + 1, MAX_SEQS).astype(np.int32)
    lengths[0] = 1      # a row frozen at the scratch page reads page 0
    rows = []
    for hkv in (HQ, 8):
        pt = page_table(rng)
        pt[0] = 0
        q32 = torch.randn((MAX_SEQS, HQ, D), generator=gen, device="cuda")
        for pool in kinds:
            kp, vp = make_pools(gen, hkv, pool)
            for dtype in pool_runs(pool):
                q = q32.to(dtype)
                args = (q, kp, vp, torch.from_numpy(lengths).cuda(), pt)
                scale = D ** -0.5
                name = f"paged_decode_attention Hkv={hkv} {dtype}" + (
                    pool_label(pool))
                got = pa.paged_decode_attention(*args)
                torch.cuda.synchronize()
                want = pa._paged_math(*args, scale)
                err = compare(name, got, want, MAX_SEQS)
                ms = cuda_ms(lambda: pa.paged_decode_attention(*args))
                dev_ms, dev_kernels = device_ms(
                    lambda: pa.paged_decode_attention(*args))
                plain_ms = cuda_ms(lambda: pa._paged_math(*args, scale),
                                   reps=5, warmup=1)
                elt = q.element_size()
                tokens = int(lengths.astype(np.int64).sum())
                nbytes = (tokens * pool_row_bytes(hkv, quant, elt)
                          + 2 * MAX_SEQS * HQ * D * elt
                          + lengths.nbytes + pt.numel() * 4)
                ops = tokens * HQ * D * 4
                b_ms, b_by = bound(nbytes, ops, str(dtype))
                row = {"phase": phase, "hkv": hkv,
                       "hq": HQ, "d": D, "bs": BS, "B": MAX_SEQS,
                       "lengths": lengths.tolist(), "dtype": str(dtype),
                       "pool": pool, "max_abs_err": err, "kernel_ms": ms,
                       "device_ms": dev_ms, "device_kernels": dev_kernels,
                       "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "ops": ops,
                       "same_bits": same_bits(
                           name, lambda: pa.paged_decode_attention(*args))}
                emit(row)
                rows.append(row)
            del kp, vp
    edges = []
    for pool in kinds:
        cases = k5_edges(seed + 100, pool)
        emit({"phase": phase + "_edges", "pool": pool, "cases": cases})
        edges += cases
    rows[0]["edge_max_abs_err"] = max(r["max_abs_err"] for r in edges)
    return rows


def codec_rows():
    """f32 rows for the codec check: seeded rows at spread magnitudes, an
    all-zero row, rows whose absmax is +max and -max (codes 127 and
    -128), and rows of values on .5 ties after scaling."""
    import numpy as np

    rng = np.random.RandomState(9)
    x = (rng.randn(4096, D)
         * rng.lognormal(0.0, 2.0, (4096, 1))).astype(np.float32)
    x[0:2] = 0.0
    x[1, :3] = (1.0, -1.0, 0.5)
    x[2] = np.abs(x[2])
    x[3] = -np.abs(x[3])
    # absmax 127.5 makes the scale factor 1: every value a tie k + 0.5
    x[4] = np.arange(D, dtype=np.float32) - 63.5
    x[4, 0] = 127.5
    x[5] = -x[4]
    return x


def phase_codec():
    """The int8 codec on the card against the CPU on the same f32 rows:
    codes, scales and dequantized values bit-identical (CUDA's float ->
    int8 cast of a NaN or an out-of-range value would show here)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops.quantization import from_int8, quantize_to_int8

    x = torch.from_numpy(codec_rows())
    cpu = quantize_to_int8(x)
    gpu = quantize_to_int8(x.cuda())
    codes_diff = int((gpu.weight.cpu() != cpu.weight).sum())
    scales_diff = int((gpu.scales.cpu().view(torch.int32)
                       != cpu.scales.view(torch.int32)).sum())
    deq_cpu = from_int8(cpu.weight, cpu.scales)
    deq_gpu = from_int8(gpu.weight, gpu.scales).cpu()
    deq_diff = int((deq_gpu.view(torch.int32)
                    != deq_cpu.view(torch.int32)).sum())
    special = cpu.weight[:6, :4].tolist()
    row = {"phase": "codec", "rows": int(x.shape[0]), "d": D,
           "codes_differing": codes_diff, "scales_differing": scales_diff,
           "dequantized_differing": deq_diff,
           "zero_row_codes_nonzero": int((gpu.weight[0] != 0).sum()),
           "first_codes_of_special_rows": special}
    emit(row)
    if codes_diff or scales_diff or deq_diff or row["zero_row_codes_nonzero"]:
        bad = np.argwhere((gpu.weight.cpu() != cpu.weight).numpy())[:8]
        raise AssertionError(
            "codec: card and CPU differ at (row, col) "
            + json.dumps([[int(r), int(c), int(gpu.weight[r, c]),
                           int(cpu.weight[r, c])] for r, c in bad]))
    if cpu.weight[1, :3].tolist() != [127, -128, 64]:
        raise AssertionError(f"codec: row [1, -1, 0.5] gave "
                             f"{cpu.weight[1, :3].tolist()}")
    return row


def _counts():
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    return {"ragged_paged_attention": ragged_paged_attention.launches,
            "paged_decode_attention": paged_decode_attention.launches,
            "ragged_paged_attention_int8":
                ragged_paged_attention.launches_int8,
            "paged_decode_attention_int8":
                paged_decode_attention.launches_int8}


def _reset_counts():
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    ragged_paged_attention.launches = 0
    paged_decode_attention.launches = 0
    ragged_paged_attention.launches_int8 = 0
    paged_decode_attention.launches_int8 = 0
    ragged_paged_attention.launches_by_thread.clear()
    paged_decode_attention.launches_by_thread.clear()


FLOAT_KERNELS = ("ragged_paged_attention", "paged_decode_attention")
INT8_KERNELS = ("ragged_paged_attention_int8", "paged_decode_attention_int8")


def check_launches(counts, int8):
    """The serving path ran through its kernels: both of the pool type's
    launched, and none of the other pool type's."""
    ran, idle = ((INT8_KERNELS, FLOAT_KERNELS) if int8
                 else (FLOAT_KERNELS, INT8_KERNELS))
    if min(counts[k] for k in ran) < 1 or max(counts[k] for k in idle) > 0:
        raise AssertionError(f"expected launches of {ran} and none of "
                             f"{idle}: {counts}")


def _pool_codes_differing(gpu_eng, cpu_eng):
    """Int8 codes and scales that differ between the card's pools and the
    CPU's after the same serve (page allocation is deterministic)."""
    import torch

    codes = scales = 0
    for gpu_pair, cpu_pair in zip(gpu_eng.pools, cpu_eng.pools):
        for g, c in zip(gpu_pair, cpu_pair):
            codes += int((g.weight.cpu() != c.weight).sum())
            scales += int((g.scales.cpu().view(torch.int32)
                           != c.scales.view(torch.int32)).sum())
    return codes, scales


# int8 pools turn an ulp of difference in a K/V value into a whole code
# step: the same prefix's logits differ between card and CPU by about 1e-2
# (so do the CPU's own after an ulp's move of every weight: `calibration`
# below), where f32 pools keep them within about 1e-6. A greedy token can
# then flip only at a near tie. 0.05 is 4% of the logits' spread (std
# 1.28 at these random weights) and some 5x that noise.
NEAR_TIE = 0.05


def prefix_logits(model, tokens, kv_cache_dtype):
    """f32 logits of the token after ``tokens``: one ragged pass over fresh
    pools of a one-slot engine on the model's device (the engine's
    prefill path; K4 on the card)."""
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
    from paddle_tpu_torch.ops.ragged_paged_attention import RaggedLayerCache

    dev = next(model.parameters()).device
    n = len(tokens)
    eng = ContinuousBatchingEngine(model, max_seqs=1, page_size=BS,
                                   max_len=max(256, -(-n // BS) * BS),
                                   kv_cache_dtype=kv_cache_dtype,
                                   device=str(dev))
    npages = -(-n // BS)
    table = torch.zeros((1, eng.pages_per_seq), dtype=torch.int32)
    table[0, :npages] = torch.arange(1, npages + 1)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    caches = [RaggedLayerCache(k, v, table.to(dev), i32([n]), i32([0, n]),
                               i32([0] * n), i32(list(range(n))),
                               torch.ones(n, dtype=torch.bool, device=dev))
              for k, v in eng.pools]
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)[None]
    with torch.no_grad():
        h, _ = model.llama(ids, position_ids=caches[0].token_pos[None].long(),
                           past_key_values=caches)
        return model.head(h[0, -1]).float().cpu()


def explain_divergences(gpu_model, cpu_model, got, want, kv_cache_dtype):
    """Each request's first differing token, with the logits of its shared
    prefix on the card and on the CPU: ``explained`` when the two agree
    within NEAR_TIE and the CPU's logits for its token and the card's are
    within NEAR_TIE of each other (a near tie, not a kernel fault)."""
    import numpy as np

    out = []
    for rid, (g, w) in enumerate(zip(got, want)):
        diff = np.nonzero(g != w)[0]
        if len(diff) == 0:
            continue
        pos = int(diff[0])
        lg = prefix_logits(gpu_model, w[:pos], kv_cache_dtype)
        lc = prefix_logits(cpu_model, w[:pos], kv_cache_dtype)
        noise = float((lg - lc).abs().max())
        gap = float(lc[int(w[pos])] - lc[int(g[pos])])
        out.append({"request": rid, "position": pos, "card": int(g[pos]),
                    "cpu": int(w[pos]), "cpu_gap": gap,
                    "logits_max_diff": noise,
                    "explained": noise <= NEAR_TIE
                    and abs(gap) <= NEAR_TIE})
    return out


def perturbed_copy(model):
    """A copy of ``model`` with every weight moved one ulp, up or down at
    random (seeded): the size of difference two summation orders make."""
    import torch

    twin = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in twin.parameters():
            up = torch.rand(p.shape, generator=gen) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
    return twin


def phase_serve_equal(seed=3):
    """f32, LLaMA-2-7B widths, 1 layer: the same prompts served on the
    card and on the CPU give the same token ids, in four runs: float pools
    greedy; int8 pools greedy; float pools sampled (temperature 0.8, top-p
    0.9, seed 0); float pools with the prefix cache, over two serve()
    calls sharing a 64-token system prompt. The int8 run may differ only
    at near ties (``explain_divergences``); its `calibration` serves the
    CPU once more with every weight an ulp off and counts the requests
    that diverge there, without a card."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

    cfg = llama2_7b()
    cfg.num_hidden_layers = EQUAL_LAYERS
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.RandomState(seed)

    def draw(n):
        return rng.randint(1, cfg.vocab_size, n).astype(np.int32)

    prompts = [draw(n) for n in (7, 33, 70, 130)]
    system = draw(64)
    shared = [[np.concatenate([system, draw(n)]) for n in lens]
              for lens in ((9, 40), (3, 25, 60))]
    base = dict(max_seqs=4, page_size=BS, max_len=256, decode_block=8)
    runs = (
        ("float_greedy", dict(prefill_chunk=64), [prompts], {}),
        ("int8_greedy", dict(kv_cache_dtype="int8"), [prompts], {}),
        ("float_sampled", dict(prefill_chunk=64), [prompts],
         dict(do_sample=True, temperature=0.8, top_p=0.9, seed=0)),
        ("float_prefix_cache", dict(prefill_chunk=64,
                                    enable_prefix_cache=True), shared, {}),
    )
    rows = []
    for name, kw, batches, serve_kw in runs:
        int8 = kw.get("kv_cache_dtype") == "int8"
        engines = (ContinuousBatchingEngine(gpu_model, device="cuda",
                                            **base, **kw),
                   ContinuousBatchingEngine(cpu_model, device="cpu",
                                            **base, **kw))
        outs, secs = [], []
        for i, eng in enumerate(engines):
            if i == 0:
                _reset_counts()
            t0 = time.perf_counter()
            outs.append([o for batch in batches
                         for o in eng.serve(batch, max_new_tokens=16,
                                            **serve_kw)])
            if i == 0:
                torch.cuda.synchronize()
                counts = _counts()
            secs.append(time.perf_counter() - t0)
        got, want = outs
        same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
        row = {"phase": "serve_equal", "run": name, "layers": EQUAL_LAYERS,
               "dtype": "float32",
               "prompt_lens": [len(p) for b in batches for p in b],
               "new_tokens": 16, "identical": same, "kernels": counts,
               "gpu_s": secs[0], "cpu_s": secs[1]}
        if int8:
            row["codes_differing"], row["scales_differing"] = (
                _pool_codes_differing(*engines))
            row["divergences"] = explain_divergences(
                gpu_model, cpu_model, got, want, "int8")
            twin = perturbed_copy(cpu_model)
            moved = ContinuousBatchingEngine(
                twin, device="cpu", **base, **kw).serve(
                    prompts, max_new_tokens=16)
            row["calibration"] = {
                "cpu_ulp_perturbed_requests_differing": sum(
                    not np.array_equal(a, b) for a, b in zip(moved, want)),
                "divergences": explain_divergences(
                    twin, cpu_model, moved, want, "int8")}
            del twin
            # a request that differs passes only at an explained near tie
            same = [s or any(d["request"] == i and d["explained"]
                             for d in row["divergences"])
                    for i, s in enumerate(same)]
            row["identical_or_near_tie"] = same
        if kw.get("enable_prefix_cache"):
            row["prefix_hit_pages"] = [e.stats["prefix_hit_pages"]
                                       for e in engines]
        emit(row)
        rows.append(row)
        if not all(same):
            raise AssertionError(
                f"serve_equal {name}: card and CPU served different tokens"
                + (f" beyond near ties {row['divergences']}" if int8
                   else "")
                + (f" ({row['codes_differing']} int8 codes and "
                   f"{row['scales_differing']} scales differ between the "
                   "pools)" if int8 else "") + ": "
                + json.dumps([[g.tolist(), w.tolist()]
                              for g, w, s in zip(got, want, same) if not s]))
        check_launches(counts, int8)
        if kw.get("enable_prefix_cache"):
            hits = row["prefix_hit_pages"]
            if hits[0] != hits[1] or hits[0] < 1:
                raise AssertionError(f"serve_equal {name}: prefix hits "
                                     f"card/CPU {hits}")
        del engines
    del gpu_model
    torch.cuda.empty_cache()
    return rows


def slice_prompts(seed, vocab):
    """The slice's 8 seeded prompts of 32-1024 tokens."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, n).astype(np.int32)
            for n in rng.randint(32, 1025, MAX_SEQS)]


def _timed_serve(eng, prompts, new_tokens, ttfts=None, **serve_kw):
    """One serve() on the card with launch counts reset just before and
    read just after: (outputs, wall seconds, TTFT median, counts);
    ``ttfts`` (a list) receives every request's TTFT in rid order."""
    import torch

    first = {}

    def on_token(rid, tok):
        first.setdefault(rid, time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = eng.serve(prompts, max_new_tokens=new_tokens, on_token=on_token,
                    **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    vocab = eng.model.config.vocab_size
    for p, o in zip(prompts, out):
        if o is None or len(o) != len(p) + new_tokens:
            raise AssertionError(
                f"request returned {None if o is None else len(o)} tokens, "
                f"expected {len(p) + new_tokens}")
        if not ((o >= 0) & (o < vocab)).all():
            raise AssertionError("token id out of range")
    ttft = [first[r] - t0 for r in range(len(prompts))]
    if ttfts is not None:
        ttfts.extend(ttft)
    return out, wall, statistics.median(ttft), counts


def phase_slice(model, seed=0, new_tokens=64, kv_cache_dtype=None,
                reference=None):
    """LLaMA-2-7B's full width at SLICE_LAYERS of 32 layers, bf16, seeded
    weights: 8 requests
    of 32-1024 prompt tokens and 64 new tokens each, greedy. With
    ``kv_cache_dtype="int8"`` (phase `slice_int8`) the pools are int8 and
    ``prefill_chunk`` is left out (the int8 engine refuses it; its ragged
    chunk is 256 anyway); ``reference`` is the bf16 slice's (row, outputs),
    for the pool size and the share of equal tokens."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine

    int8 = kv_cache_dtype == "int8"
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(
        model, max_seqs=MAX_SEQS, page_size=BS, max_len=MAX_LEN,
        decode_block=8, kv_cache_dtype=kv_cache_dtype,
        prefill_chunk=None if int8 else CHUNK, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    prompts = slice_prompts(seed, model.config.vocab_size)
    eng.serve([prompts[0][:16]], max_new_tokens=2)   # warm-up
    out, wall, ttft, counts = _timed_serve(eng, prompts, new_tokens)
    check_launches(counts, int8)
    row = {"phase": "slice_int8" if int8 else "slice", "model": "llama2_7b",
           "layers": model.config.num_hidden_layers, "dtype": "bfloat16",
           "kv_cache_dtype": "int8" if int8 else "bfloat16",
           "max_seqs": MAX_SEQS, "page_size": BS, "max_len": MAX_LEN,
           "decode_block": 8, "prefill_chunk": None if int8 else CHUNK,
           "ragged_chunk": eng._ragged_chunk,
           "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new_tokens, "wall_s": wall,
           "generated_tok_per_s": len(prompts) * new_tokens / wall,
           "ttft_median_s": ttft, "setup_s": t_setup,
           "decode_steps": eng.stats["decode_steps"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "pool_bytes": eng.pool_bytes(), "kernels": counts}
    if reference is not None:
        ref_row, ref_out = reference
        row["pool_bytes_vs_bf16"] = eng.pool_bytes() / ref_row["pool_bytes"]
        gen = [(o[len(p):], r[len(p):])
               for p, o, r in zip(prompts, out, ref_out)]
        row["tokens_equal_to_bf16_share"] = (
            sum(int((a == b).sum()) for a, b in gen)
            / sum(len(a) for a, _ in gen))
        row["requests_equal_to_bf16"] = sum(
            bool(np.array_equal(a, b)) for a, b in gen)
    emit(row)
    if int8:
        # 16 new tokens: the trace of 64 takes the profiler ~2 minutes
        row["profile"] = _device_profile(
            "slice_int8_profile",
            lambda: eng.serve(prompts, max_new_tokens=PROFILE_NEW_TOKENS))
    return row, eng, prompts, out


def phase_slice_sampled_prefix(model, seed=0, new_tokens=64):
    """LLaMA-2-7B bf16, 32 layers, float pools with the prefix cache and
    sampling (temperature 0.8, top-p 0.9, seed 0): one request carrying a
    512-token system prompt, then 8 requests of that system prompt plus
    32-256 tokens of their own, each sharing its 32 pages."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine

    sampled = dict(do_sample=True, temperature=0.8, top_p=0.9, seed=0)
    vocab = model.config.vocab_size
    rng = np.random.RandomState(seed + 1)
    system = rng.randint(1, vocab, 512).astype(np.int32)
    first = np.concatenate([system, rng.randint(1, vocab, 32)
                            .astype(np.int32)])
    prompts = [np.concatenate([system, rng.randint(1, vocab, n)
                               .astype(np.int32)])
               for n in rng.randint(32, 257, MAX_SEQS)]
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(
        model, max_seqs=MAX_SEQS, page_size=BS, max_len=MAX_LEN,
        decode_block=8, prefill_chunk=CHUNK, enable_prefix_cache=True,
        device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    _, first_wall, first_ttft, _ = _timed_serve(eng, [first], new_tokens,
                                                **sampled)
    hits0 = eng.stats["prefix_hit_pages"]
    out, wall, ttft, counts = _timed_serve(eng, prompts, new_tokens,
                                           **sampled)
    check_launches(counts, int8=False)
    hits = eng.stats["prefix_hit_pages"] - hits0
    row = {"phase": "slice_sampled_prefix", "model": "llama2_7b",
           "layers": model.config.num_hidden_layers, "dtype": "bfloat16",
           "max_seqs": MAX_SEQS,
           "page_size": BS, "max_len": MAX_LEN, "decode_block": 8,
           "prefill_chunk": CHUNK, "sampling": sampled,
           "system_prompt": len(system), "first_prompt": len(first),
           "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new_tokens, "first_wall_s": first_wall,
           "first_ttft_s": first_ttft, "wall_s": wall,
           "generated_tok_per_s": len(prompts) * new_tokens / wall,
           "ttft_median_s": ttft, "setup_s": t_setup,
           "prefix_hit_pages": hits,
           "prefix_hit_pages_expected": MAX_SEQS * len(system) // BS,
           "prefix_evictions": eng.stats["prefix_evictions"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernels": counts}
    emit(row)
    if hits < 1:
        raise AssertionError(f"slice_sampled_prefix: no prefix hit: {row}")
    row["profile"] = _device_profile(
        "slice_sampled_prefix_profile",
        lambda: eng.serve(prompts, max_new_tokens=PROFILE_NEW_TOKENS,
                          **sampled))
    return row


def check_plane_launches(counts, ragged, int8=False):
    """A ragged serve launched both of its pool type's kernels and none of
    the other's (``check_launches``); a legacy (``ragged=False``) serve
    launched K5 of its pool type and never K4 (its prefill is the dense
    masked plain tier)."""
    if ragged:
        return check_launches(counts, int8)
    sfx = "_int8" if int8 else ""
    k5 = counts["paged_decode_attention" + sfx]
    idle = [n for n in (FLOAT_KERNELS + INT8_KERNELS)
            if n != "paged_decode_attention" + sfx]
    if k5 < 1 or any(counts[n] for n in idle):
        raise AssertionError(f"legacy serve: expected launches of "
                             f"paged_decode_attention{sfx} alone: {counts}")


SURFACE_SAMPLED = dict(do_sample=True, temperature=0.8, top_p=0.9)


def _surface_adapter(rng, name, rank, hidden, vocab, scale=1.0):
    """A seeded f32 LoRA adapter: A [hidden, rank], B [rank, vocab] drawn
    Normal(0, 0.05), so the delta moves some greedy tokens."""
    import numpy as np

    from paddle_tpu_torch.serving import LoRAAdapter

    return LoRAAdapter(name,
                       (rng.randn(hidden, rank) * 0.05).astype(np.float32),
                       (rng.randn(rank, vocab) * 0.05).astype(np.float32),
                       scale=scale)


def phase_serve_surface_equal(seed=3):
    """f32, LLaMA-2-7B widths, 1 layer, ``serve_equal``'s prompt draw: the
    engine's surface card vs CPU. Token ids identical (int8 pools: or the
    first differing token at an explained near tie) in: the legacy ladder
    (``ragged=False``) greedy over float and int8 pools; the legacy ladder
    with the prefix cache and ``prefill_chunk`` 64 (two serves, a
    three-chunk prompt); rank-8 LoRA adapters beside base rows, ragged and
    legacy; ``sampling_overrides`` mixing greedy and sampled. Launches:
    K5 and no K4 on the legacy plane, both on the ragged. Then, on the
    card: the legacy insert's int8 codes and scales on the CPU's dense
    K/V bit for bit with the CPU's; a zero-weight adapter's tokens equal
    the base serve's on both planes (and the base serve does no LoRA
    work); a request exported, detached and adopted by a second engine
    ends with one engine's tokens (and the CPU's); a legacy engine after
    ``warmup`` (greedy and sampled) keeps its ``stats`` and serves the
    tokens the unwarmed run served."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine, EngineRequest, canonical_sampling,
    )
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.serving import LoRAAdapter

    cfg = llama2_7b()
    cfg.num_hidden_layers = EQUAL_LAYERS
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.RandomState(seed)

    def draw(n):
        return rng.randint(1, cfg.vocab_size, n).astype(np.int32)

    prompts = [draw(n) for n in (7, 33, 70, 130)]
    system = draw(64)
    shared = [[np.concatenate([system, draw(n)]) for n in lens]
              for lens in ((9, 40), (3, 25, 60))]
    arng = np.random.RandomState(seed + 100)
    ad_a = _surface_adapter(arng, "a", 8, cfg.hidden_size, cfg.vocab_size)
    ad_b = _surface_adapter(arng, "b", 8, cfg.hidden_size, cfg.vocab_size,
                            scale=-1.0)
    mixed = [ad_a, None, ad_b, None]
    base = dict(max_seqs=4, page_size=BS, max_len=256, decode_block=8)
    runs = (
        ("legacy_float_greedy", dict(ragged=False), [prompts], {}),
        ("legacy_int8_greedy", dict(ragged=False, kv_cache_dtype="int8"),
         [prompts], {}),
        ("legacy_prefix_chunk", dict(ragged=False, prefill_chunk=64,
                                     enable_prefix_cache=True),
         [shared[0], shared[1] + [prompts[3]]], {}),
        ("lora_ragged", dict(prefill_chunk=64), [prompts],
         dict(adapters=mixed)),
        ("lora_legacy", dict(ragged=False), [prompts], dict(adapters=mixed)),
        ("sampling_overrides", dict(prefill_chunk=64), [prompts],
         dict(seed=0, sampling_overrides=[None, SURFACE_SAMPLED, {},
                                          SURFACE_SAMPLED])),
    )
    rows, card_out = [], {}
    for name, kw, batches, serve_kw in runs:
        int8 = kw.get("kv_cache_dtype") == "int8"
        ragged = kw.get("ragged", True)
        engines = (ContinuousBatchingEngine(gpu_model, device="cuda",
                                            **base, **kw),
                   ContinuousBatchingEngine(cpu_model, device="cpu",
                                            **base, **kw))
        outs, secs = [], []
        for i, eng in enumerate(engines):
            if i == 0:
                _reset_counts()
            t0 = time.perf_counter()
            outs.append([o for batch in batches
                         for o in eng.serve(batch, max_new_tokens=16,
                                            **serve_kw)])
            if i == 0:
                torch.cuda.synchronize()
                counts = _counts()
            secs.append(time.perf_counter() - t0)
        got, want = outs
        card_out[name] = got
        same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
        row = {"phase": "serve_surface_equal", "run": name,
               "layers": EQUAL_LAYERS,
               "dtype": "float32", "ragged": ragged,
               "prompt_lens": [len(p) for b in batches for p in b],
               "new_tokens": 16, "identical": same, "kernels": counts,
               "gpu_s": secs[0], "cpu_s": secs[1]}
        if "adapters" in serve_kw:
            row["lora_dispatches"] = [e.lora_dispatches for e in engines]
        if int8:
            row["codes_differing"], row["scales_differing"] = (
                _pool_codes_differing(*engines))
            row["divergences"] = explain_divergences(
                gpu_model, cpu_model, got, want, "int8")
            same = [s or any(d["request"] == i and d["explained"]
                             for d in row["divergences"])
                    for i, s in enumerate(same)]
            row["identical_or_near_tie"] = same
            # the insert itself on the same dense K/V (the CPU prefill's),
            # card vs CPU: the codec's bit-for-bit contract
            ids = np.zeros((1, 64), np.int32)
            ids[0, :33] = prompts[1]
            with torch.no_grad():
                _, ks, vs = engines[1]._prefill(torch.from_numpy(ids), 33,
                                                canonical_sampling(False),
                                                None)
            pages = [1, 2, 3, 4]
            for eng in engines:
                eng._insert(ks.to(eng.device), vs.to(eng.device), pages)
            row["insert_codes_differing"] = row["insert_scales_differing"] = 0
            for gp, cp in zip(engines[0].pools, engines[1].pools):
                for g, c in zip(gp, cp):
                    row["insert_codes_differing"] += int(
                        (g.weight[:, pages].cpu() != c.weight[:, pages])
                        .sum())
                    row["insert_scales_differing"] += int(
                        (g.scales[:, pages].cpu().view(torch.int32)
                         != c.scales[:, pages].view(torch.int32)).sum())
        if kw.get("enable_prefix_cache"):
            row["prefix_hit_pages"] = [e.stats["prefix_hit_pages"]
                                       for e in engines]
            row["prefill_chunks"] = kw["prefill_chunk"]
        emit(row)
        rows.append(row)
        if not all(same):
            raise AssertionError(
                f"serve_surface_equal {name}: card and CPU served different "
                "tokens" + (f" beyond near ties {row['divergences']}"
                            if int8 else "") + ": "
                + json.dumps([[g.tolist(), w.tolist()]
                              for g, w, s in zip(got, want, same) if not s]))
        check_plane_launches(counts, ragged, int8)
        if int8 and (row["insert_codes_differing"]
                     or row["insert_scales_differing"]):
            raise AssertionError(f"serve_surface_equal {name}: the insert's "
                                 f"codes differ card vs CPU: {row}")
        if kw.get("enable_prefix_cache"):
            hits = row["prefix_hit_pages"]
            if hits[0] != hits[1] or hits[0] < 1:
                raise AssertionError(f"serve_surface_equal {name}: prefix "
                                     f"hits card/CPU {hits}")
        del engines
    # ---- on the card: a zero adapter is the base model, on both planes
    zero = LoRAAdapter("zero", np.zeros((cfg.hidden_size, 8), np.float32),
                       np.zeros((8, cfg.vocab_size), np.float32))
    zrow = {"phase": "serve_surface_equal", "run": "zero_adapter"}
    for plane, ragged in (("ragged", True), ("legacy", False)):
        eng = ContinuousBatchingEngine(gpu_model, device="cuda", **base,
                                       ragged=ragged)
        _reset_counts()
        b = eng.serve(prompts, max_new_tokens=16)
        n_base = eng.lora_dispatches
        z = eng.serve(prompts, max_new_tokens=16, adapters=zero)
        torch.cuda.synchronize()
        zrow[plane] = {"identical": [bool(np.array_equal(x, y))
                                     for x, y in zip(b, z)],
                       "base_lora_dispatches": n_base,
                       "zero_lora_dispatches": eng.lora_dispatches - n_base,
                       "kernels": _counts()}
        check_plane_launches(zrow[plane]["kernels"], ragged)
        if not all(zrow[plane]["identical"]) or n_base \
                or eng.lora_dispatches == n_base:
            raise AssertionError(f"serve_surface_equal zero_adapter: {zrow}")
        del eng
    emit(zrow)
    rows.append(zrow)
    # ---- on the card: export, detach, adopt
    p = prompts[2]
    one = ContinuousBatchingEngine(gpu_model, device="cuda", **base,
                                   prefill_chunk=64)
    want_one = one.serve([p], max_new_tokens=32)[0]
    want_cpu = ContinuousBatchingEngine(
        cpu_model, device="cpu", **base, prefill_chunk=64).serve(
            [p], max_new_tokens=32)[0]
    # the prefill side reads back each block: export after its first
    a = ContinuousBatchingEngine(gpu_model, device="cuda", **base,
                                 prefill_chunk=64, async_decode=False)
    b = ContinuousBatchingEngine(gpu_model, device="cuda", **base,
                                 prefill_chunk=64)
    req = EngineRequest(0, p, 32)
    _reset_counts()
    if a.try_admit_one(req) != "admitted":
        raise AssertionError("serve_surface_equal handoff: not admitted")
    while req.n_generated == 0:
        a.step()
    payload = a.export_pages(req.slot)
    if payload is None:
        raise AssertionError("serve_surface_equal handoff: the request "
                             "finished before its export")
    moved_at = req.n_generated
    a.detach_request(req.slot)
    status = b.adopt_request(req, payload)
    b.drain()
    torch.cuda.synchronize()
    hrow = {"phase": "serve_surface_equal", "run": "handoff",
            "prompt_len": len(p), "moved_after_tokens": moved_at,
            "payload_pages": payload["n_pages"], "adopt": status,
            "identical_to_one_engine": bool(np.array_equal(req.result,
                                                           want_one)),
            "identical_to_cpu": bool(np.array_equal(req.result, want_cpu)),
            "kernels": _counts()}
    emit(hrow)
    rows.append(hrow)
    if status != "admitted" or not (hrow["identical_to_one_engine"]
                                    and hrow["identical_to_cpu"]):
        raise AssertionError(f"serve_surface_equal handoff: {hrow}")
    del one, a, b
    # ---- on the card: warmup keeps stats and streams
    warm = ContinuousBatchingEngine(gpu_model, device="cuda", **base,
                                    ragged=False)
    stats = dict(warm.stats)
    t0 = time.perf_counter()
    warm.warmup(buckets=[len(q) for q in prompts],
                sampling=[canonical_sampling(False),
                          canonical_sampling(**SURFACE_SAMPLED)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    stats_after = dict(warm.stats)
    _reset_counts()
    out = warm.serve(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    wrow = {"phase": "serve_surface_equal", "run": "warmup",
            "warmup_s": warm_s, "warmup_build_s": warm.warmup_build_s,
            "programs": len(warm._warm),
            "stats_unchanged": stats_after == stats,
            "identical": [bool(np.array_equal(x, y)) for x, y in zip(
                out, card_out["legacy_float_greedy"])],
            "kernels": _counts()}
    emit(wrow)
    rows.append(wrow)
    check_plane_launches(wrow["kernels"], ragged=False)
    if not (wrow["stats_unchanged"] and all(wrow["identical"])):
        raise AssertionError(f"serve_surface_equal warmup: {wrow}")
    del warm, gpu_model
    torch.cuda.empty_cache()
    return rows


SURFACE_RANK = 16      # slice_surface's adapters: rank 16, f32


def _surface_row(run, eng, prompts, out, wall, ttft, counts, reference,
                 new_tokens):
    """slice_surface's report of one serve, beside `slice`'s outputs."""
    import numpy as np
    import torch

    ref_row, ref_out = reference
    gen = [(o[len(p):], r[len(p):]) for p, o, r in zip(prompts, out, ref_out)]
    return {"phase": "slice_surface", "run": run, "model": "llama2_7b",
            "layers": eng.model.config.num_hidden_layers,
            "dtype": "bfloat16", "ragged": eng._ragged,
            "prefill_chunk": eng.prefill_chunk, "decode_block": 8,
            "prompt_lens": [len(p) for p in prompts],
            "new_tokens": new_tokens, "wall_s": wall,
            "generated_tok_per_s": len(prompts) * new_tokens / wall,
            "ttft_median_s": ttft, "decode_steps": eng.stats["decode_steps"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kernels": counts,
            "tokens_equal_to_slice_share": (
                sum(int((a == b).sum()) for a, b in gen)
                / sum(len(a) for a, _ in gen)),
            "requests_equal_to_slice": sum(
                bool(np.array_equal(a, b)) for a, b in gen),
            "slice_tok_per_s": ref_row["generated_tok_per_s"]}


def phase_slice_surface(model, reference, seed=0, new_tokens=64):
    """`slice`'s model (LLaMA-2-7B bf16, 32 layers, nothing cut) and
    prompts (8 requests of 32-1024 tokens, 64 new) through the engine's
    surface: ``legacy`` (``ragged=False``, ``prefill_chunk`` 256, bf16
    pools; the share of the serve's wall in the dense prefill, the masked
    plain tier, synchronised at each prefill's end as its own readback
    is), ``warmup`` (a legacy engine's warmup seconds, then its serve and
    the first request's TTFT beside a cold legacy engine's) and ``lora``
    (the ragged plane with 4 rank-16 f32 adapters on 6 of the 8
    requests). Each run: tokens/s, TTFT median, decode steps, peak
    memory, K4/K5 launches (the legacy plane launches K5 and never K4),
    and the share of tokens equal to `slice`'s (reported, not held: cuBLAS
    may round another batch shape differently)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine

    prompts = slice_prompts(seed, model.config.vocab_size)
    kw = dict(max_seqs=MAX_SEQS, page_size=BS, max_len=MAX_LEN,
              decode_block=8, prefill_chunk=CHUNK, device="cuda")
    rows = []
    # ---- legacy, with the dense prefill's share of the wall
    eng = ContinuousBatchingEngine(model, ragged=False, **kw)
    eng.serve([prompts[0][:16]], max_new_tokens=2)   # warm-up, as slice's
    prefill = {"s": 0.0, "calls": 0}
    inner = eng._prefill

    def timed_prefill(*a, **k):
        t0 = time.perf_counter()
        res = inner(*a, **k)
        torch.cuda.synchronize()
        prefill["s"] += time.perf_counter() - t0
        prefill["calls"] += 1
        return res

    eng._prefill = timed_prefill
    out, wall, ttft, counts = _timed_serve(eng, prompts, new_tokens)
    # drop the timer and the bound method it holds, or the engine's pools
    # outlive it into the next runs' peak memory
    del eng._prefill, inner
    check_plane_launches(counts, ragged=False)
    row = _surface_row("legacy", eng, prompts, out, wall, ttft, counts,
                       reference, new_tokens)
    row.update(prefill_s=prefill["s"], prefill_calls=prefill["calls"],
               prefill_share=prefill["s"] / wall)
    emit(row)
    rows.append(row)

    def free():
        # each run's peak memory holds its own engine's pools alone
        gc.collect()
        torch.cuda.empty_cache()

    del eng
    free()
    # ---- warmup against a cold engine
    cold = ContinuousBatchingEngine(model, ragged=False, **kw)
    cold_ttfts = []
    _, cold_wall, _, _ = _timed_serve(cold, prompts, new_tokens,
                                      ttfts=cold_ttfts)
    del cold
    free()
    warm = ContinuousBatchingEngine(model, ragged=False, **kw)
    stats = dict(warm.stats)
    t0 = time.perf_counter()
    warm.warmup(buckets=[len(p) for p in prompts])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    unchanged = warm.stats == stats
    ttfts = []
    out, wall, ttft, counts = _timed_serve(warm, prompts, new_tokens,
                                           ttfts=ttfts)
    check_plane_launches(counts, ragged=False)
    row = _surface_row("warmup", warm, prompts, out, wall, ttft, counts,
                       reference, new_tokens)
    row.update(warmup_s=warm_s, warmup_build_s=warm.warmup_build_s,
               programs=len(warm._warm), stats_unchanged=unchanged,
               first_ttft_s=ttfts[0], cold_first_ttft_s=cold_ttfts[0],
               cold_wall_s=cold_wall)
    emit(row)
    rows.append(row)
    if not unchanged:
        raise AssertionError(f"slice_surface warmup changed stats: {row}")
    del warm
    free()
    # ---- LoRA: 4 rank-16 adapters on 6 of the 8 requests
    arng = np.random.RandomState(seed + 200)
    ads = [_surface_adapter(arng, f"tenant{i}", SURFACE_RANK,
                            model.config.hidden_size,
                            model.config.vocab_size) for i in range(4)]
    per_request = ads + ads[:2] + [None, None]
    eng = ContinuousBatchingEngine(model, **kw)
    eng.serve([prompts[0][:16]], max_new_tokens=2)   # warm-up, as slice's
    out, wall, ttft, counts = _timed_serve(eng, prompts, new_tokens,
                                           adapters=per_request)
    check_launches(counts, int8=False)
    row = _surface_row("lora", eng, prompts, out, wall, ttft, counts,
                       reference, new_tokens)
    base_rows = [i for i, a in enumerate(per_request) if a is None]
    row.update(adapters=len(ads), rank=SURFACE_RANK,
               adapter_requests=len(prompts) - len(base_rows),
               lora_dispatches=eng.lora_dispatches,
               base_requests_equal_to_slice=sum(
                   bool(np.array_equal(out[i], reference[1][i]))
                   for i in base_rows))
    emit(row)
    rows.append(row)
    del eng
    free()
    return rows


PAGED_KERNELS = (("ragged_tile_kernel<", "ragged_paged_attention"),
                 ("paged_split_kernel<", "paged_decode_attention"),
                 ("split_merge_kernel<", "paged_split_merge"))
POOL_FAMILY = {"PoolInt8": "_int8", "PoolBf16": "", "PoolF32": ""}


def _family(name):
    """Kernel family of a device event, by the kernel's name."""
    # the paged kernels, templated <Pool, T, D(, G)>: K4's tiles, the
    # split-KV decode (K5 and K4's decode rows) and the splits' merge, each
    # of the float pools' family or the int8 pool's by its pool type
    for kernel, family in PAGED_KERNELS:
        if kernel in name:
            pool = name.partition(kernel)[2].partition(",")[0]
            tag = pool.strip().rpartition("::")[2]
            if tag not in POOL_FAMILY:
                raise AssertionError(f"_family: no pool type in {name!r}")
            return family + POOL_FAMILY[tag]
    # the forward's kernels (bf16 flash_fwd_hopper, f32 flash_fwd_f32) are
    # templated <D, SEG, RING>, the bf16 gradients' <D, SEG, ACC>, the f32
    # backward's <T, D, SEG>: SEG is K3's segment mask (its delta pass is
    # K1's kernel), RING K6's merge, ACC the ring visits' f32 sums
    for kernel, entry, n_lead in (("flash_fwd_hopper<", "fwd", 1),
                                  ("flash_fwd_f32<", "fwd", 1),
                                  ("flash_dkdv_hopper<", "bwd_dkdv", 1),
                                  ("flash_dq_hopper<", "bwd_dq", 1),
                                  ("flash_bwd_delta_kernel<", "bwd_delta", 2),
                                  ("flash_bwd_dkdv_kernel<", "bwd_dkdv", 2),
                                  ("flash_bwd_dq_kernel<", "bwd_dq", 2)):
        if kernel in name:
            args = name.partition(kernel)[2].partition(">")[0]
            flags = [a.strip() == "true" for a in args.split(",")[n_lead:]]
            kind = ("ring_" if flags[1:2] == [True] else
                    "seg_" if flags[:1] == [True] else "")
            return "flash_attention_" + kind + entry
    if "adamw_kernel" in name:
        return "adamw_update"
    if "wo_hopper_kernel<" in name or "wo_f32_kernel<" in name:
        return "weight_only_linear"
    for kernel, family in (("gather_rows_kernel<", "moe_dispatch"),
                           ("combine_rows_kernel<", "moe_combine"),
                           ("combine_dw_kernel<", "moe_combine_dw")):
        if kernel in name:
            return family
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
    ratio = _row_ratios(got, want)
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


def _row_ratios(got, want):
    """Per row (the last dim), ``row_check``'s ratio of the row's error
    to its limit's scale."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    norm = w.norm(dim=-1)
    return (g - w).norm(dim=-1) / (norm + 0.1 * norm.square().mean().sqrt())


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


def _flash_bounds(pairs, B, sq, sk, hq, hkv, elt, id_bytes=0, d=D):
    """{entry: (bytes, ops)}: each input read once, each output written
    once (``id_bytes``: K3's segment ids, positions and range table); ops
    of the products the ``pairs`` visible (query, key, head) triples need
    (2 flops per multiply-add): forward Q K^T and P V; dK/dV also
    recomputes S and dP; dQ needs S, dP and dS K. `bwd` is the whole
    backward at 2.5x the forward's products."""
    nq, nk = B * sq * hq * d, B * sk * hkv * d
    rows = B * hq * sq * 4
    fwd_ops = 4 * pairs * d
    return {
        "fwd": ((2 * nq + 2 * nk) * elt + rows + id_bytes, fwd_ops),
        "bwd_delta": (2 * nq * elt + rows, 2 * nq),
        "bwd_dkdv": ((2 * nq + 4 * nk) * elt + 2 * rows + id_bytes,
                     2 * fwd_ops),
        "bwd_dq": ((3 * nq + 2 * nk) * elt + 2 * rows + id_bytes,
                   3 * fwd_ops // 2),
        "bwd": ((4 * nq + 4 * nk) * elt + 2 * rows + id_bytes,
                5 * fwd_ops // 2),
    }


def _plain_lse(q, k, mask, scale):
    """The rows' log-sum-exp [B, Hq, Sq] of the scaled f32 scores under
    ``mask`` (None or broadcast to [B, Hq, Sq, Sk]; True = visible), -inf
    where a row sees no key: what the forward kernel saves."""
    import torch

    qt, kt = q.transpose(1, 2).float(), k.transpose(1, 2).float()
    kt = kt.repeat_interleave(qt.shape[1] // kt.shape[1], dim=1)
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(logits, dim=-1)


def lse_error(got, want):
    """Largest |got - want| over the rows, inf where the two disagree on
    which rows see no key (-inf)."""
    import torch

    empty = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), empty):
        return float("inf")
    return float((got - want)[~empty].abs().max()) if bool(
        (~empty).any()) else 0.0


LSE_TOL = 1e-3     # the forward's saved lse against the plain version's


def flash_case(gen, B, sq, sk, hq, hkv, causal, dtype, timed, segs=None,
               public=None, beside_k1=False, d=D):
    """One flash-attention case on the card: K1/K2 (``segs`` None, the
    bottom-right causal mask) or K3 (``segs``, a ``Segments`` on the card),
    at head dim ``d``. Each kernel entry against its plain version on the
    same inputs (the forward's O and its saved lse, within LSE_TOL), and
    forward and backward end to end against the plain version's autograd;
    ``public(q, k, v)``, the entry point a user calls, must give the
    kernel's output bit for bit; two launches of the dK/dV and dQ kernels
    must give the same bits; K3's dQ rows that see no key and dK/dV rows of
    keys no query sees must be exactly 0. With ``timed``, CUDA-event medians
    of every entry, the whole backward (delta, dK/dV, dQ), the plain version
    and F.scaled_dot_product_attention (the library time, its backward alone
    as autograd of its retained output; K3: with the boolean segment mask,
    built outside the timed region); ``beside_k1`` also times K1's causal
    forward and forward + backward on the same tensors."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do = rand((B, sq, hq, d)), rand((B, sq, hq, d))
    k, v = rand((B, sk, hkv, d)), rand((B, sk, hkv, d))
    scale = d ** -0.5
    if segs is None:
        def attn(a, b, c):
            return fa.FlashAttention.apply(a, b, c, causal, scale)

        def plain(a, b, c, s=scale):
            return fa._attention_math(a, b, c, causal, s)

        def plain_bwd(out):
            return fa._attention_bwd_math(q, k, v, out, do, causal, scale)

        entry = {
            "fwd": lambda: fa.flash_fwd(q, k, v, causal, scale),
            "bwd_delta": lambda o: fa.flash_bwd_delta(o, do),
            "bwd_dkdv": lambda lse, dl: fa.flash_bwd_dkdv(
                q, k, v, do, lse, dl, causal, scale),
            "bwd_dq": lambda lse, dl: fa.flash_bwd_dq(
                q, k, v, do, lse, dl, causal, scale)}
        few = _few_keys(B, sq, sk, hq, causal)
        pairs = _visible_pairs(sq, sk, causal) * B * hq
        id_bytes, lib_mask, extra = 0, None, {}
        lse_mask = fa._causal_mask(q, k, causal)
    else:
        # the tables built once, outside the timed calls, as LlamaModel
        # prepares them once for every layer
        key_ranges, query_ranges = fa._tile_ranges(segs, causal)

        def attn(a, b, c):
            return fa.SegmentFlashAttention.apply(
                a, b, c, *segs, key_ranges, query_ranges, causal, scale)

        def plain(a, b, c, s=scale):
            return fa._segment_math(a, b, c, segs, causal, s)

        def plain_bwd(out):
            return fa._segment_bwd_math(q, k, v, out, do, segs, causal,
                                        scale)

        entry = {
            "fwd": lambda: fa.seg_flash_fwd(q, k, v, segs, key_ranges,
                                            causal, scale),
            "bwd_delta": lambda o: fa.seg_flash_bwd_delta(o, do),
            "bwd_dkdv": lambda lse, dl: fa.seg_flash_bwd_dkdv(
                q, k, v, do, lse, dl, segs, query_ranges, causal, scale),
            "bwd_dq": lambda lse, dl: fa.seg_flash_bwd_dq(
                q, k, v, do, lse, dl, segs, key_ranges, causal, scale)}
        seen = segs.mask(causal).sum(-1)
        few = (seen < FEW_KEYS).reshape(-1).repeat_interleave(hq)
        pairs = int(seen.sum()) * hq
        id_bytes = 4 * (segs.seg_q.numel() + segs.pos_q.numel()
                        + segs.seg_k.numel() + segs.pos_k.numel()
                        + key_ranges.numel())
        lib_mask = segs.mask(causal)[:, None]
        n_kt, n_qt = -(-sk // 64), -(-sq // 64)
        k1_tiles = (sum(min(n_kt, i + 1) for i in range(n_qt)) if causal
                    else n_qt * n_kt)
        fwd_ranges = fa._fwd_key_ranges(key_ranges)
        dkdv_ranges = fa._dkdv_query_ranges(query_ranges)
        extra = {"segments_per_row": [len(torch.unique(r))
                                      for r in segs.seg_q],
                 "rows_seeing_no_key": int((seen == 0).sum()),
                 "tile_pairs_visited": int(
                     (key_ranges[..., 1] - key_ranges[..., 0]).sum()),
                 "tile_pairs_k1_causal": B * k1_tiles,
                 "fwd_tile_pairs_visited_128": int(
                     (fwd_ranges[..., 1] - fwd_ranges[..., 0]).sum()),
                 "dkdv_stages_visited_128x64": int(
                     (dkdv_ranges[..., 1] - dkdv_ranges[..., 0]).sum())}
        lse_mask = lib_mask

    def fwd_bwd(fn):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv)
        out.backward(do)
        return out.detach(), qq.grad, kk.grad, vv.grad

    def held(got, want, names, spare=None):
        """{tensor: row_check}; O and f32 gradients also element by
        element; ``spare``: {tensor: rows counted apart}."""
        return {n: row_check(g, w, n == "o" or dtype == torch.float32,
                             (spare or {}).get(n))
                for n, g, w in zip(names, got, want)}

    got = fwd_bwd(attn)
    torch.cuda.synchronize()
    want = fwd_bwd(plain)
    # each entry against its plain version on its own inputs: the forward
    # against the plain forward, the backward entries against the plain
    # backward given the kernel's stored O
    given_o = plain_bwd(got[0])
    checks = held(got, want, ("o",))
    checks.update(held(got[1:], given_o, ("dq", "dk", "dv")))
    # end to end, against autograd of the plain forward: that takes delta
    # = rowsum(dO * O) from the f32 softmax where the kernels (and the
    # reference's TPU kernel) take the stored O, rounded to bf16; in a
    # query row that sees only a few keys P sits on one or two of them
    # and dQ nearly cancels, but delta's rounding does not, so those rows
    # of dQ are counted apart. K3's short segments put many more rows near
    # that regime (query rows seeing tens of keys; the keys of a short
    # segment's end, seen by a few queries that see a few keys): there
    # delta's rounding alone, in the plain version, moves a dQ or dK row
    # past half the limit, and such rows (the plain backward given the
    # stored O against autograd) are counted apart too
    spare = {"dq": few}
    if segs is not None:
        tol = ROW_TOL[str(dtype)]
        for i, n in enumerate(("dq", "dk", "dv")):
            moved = _row_ratios(given_o[i], want[i + 1]) > tol / 2
            extra[f"{n}_rows_moved_by_delta_rounding"] = int(moved.sum())
            spare[n] = moved | spare[n] if n in spare else moved
    del given_o
    end_to_end = held(got[1:], want[1:], ("dq", "dk", "dv"), spare)
    splash = None
    if hq != hkv and dtype == torch.bfloat16:
        # the reference's splash kernel (K2; K3's GQA too) scales q in its
        # storage dtype before the products
        # (paddle_tpu/ops/flash_attention.py:161, :301); the port's kernels
        # scale the f32 scores, as K1 does: hold them to that rounding end
        # to end as well
        splash = held(got, fwd_bwd(lambda a, b, c: plain(
            (a * scale).to(a.dtype), b, c, 1.0)), ("o", "dq", "dk", "dv"),
            spare)
    del want
    out, lse = entry["fwd"]()
    lse_err = lse_error(lse, _plain_lse(q, k, lse_mask, scale))
    delta = entry["bwd_delta"](out)
    want_delta = (out.float() * do.float()).sum(-1).transpose(1, 2)
    err = {name: c["max_abs_err"] for name, c in checks.items()}
    err["lse"] = lse_err
    err["delta"] = compare(f"flash delta {hq}/{hkv}", delta,
                           want_delta.contiguous(), B)
    row = {"B": B, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv, "d": d,
           "causal": causal, "dtype": str(dtype), "visible_pairs": pairs,
           **extra, "max_abs_err": err, "checks": checks,
           "end_to_end": end_to_end}
    if splash is not None:
        row["end_to_end_splash_rounding"] = splash
    if public is not None:
        row["public_entry_equal"] = bool(torch.equal(public(q, k, v),
                                                     got[0]))
    # two launches of the gradient kernels give the same bits (no sum
    # crosses blocks)
    grads = [(*entry["bwd_dkdv"](lse, delta), entry["bwd_dq"](lse, delta))
             for _ in range(2)]
    row["deterministic"] = all(torch.equal(a, b) for a, b in zip(*grads))
    del grads
    if segs is not None:
        # K3: a query row that sees no key has dQ exactly 0, and a key that
        # no query sees has dK and dV exactly 0
        unseen = segs.mask(causal).sum(1) == 0
        row["exact_zeros"] = {
            "dq_rows_seeing_no_key": int((seen == 0).sum()),
            "dq_zero": bool((got[1][seen == 0] == 0).all()),
            "keys_seen_by_none": int(unseen.sum()),
            "dk_dv_zero": bool((got[2][unseen] == 0).all()
                               and (got[3][unseen] == 0).all())}
    bad = [f"{against} {name}: {c}"
           for against, cs in (("entry", checks), ("end to end", end_to_end),
                               ("splash", splash or {}))
           for name, c in cs.items()
           if c["bad_rows"] or c["bad_elements"] or not c["finite"]]
    if row.get("public_entry_equal") is False:
        bad.append("the public entry point differs from the kernel path")
    if not row["deterministic"]:
        bad.append("two launches of the gradient kernels differ")
    zeros = row.get("exact_zeros", {})
    if zeros and not (zeros["dq_zero"] and zeros["dk_dv_zero"]):
        bad.append(f"gradients of unseen rows or keys are not 0: {zeros}")
    if not lse_err <= LSE_TOL:
        bad.append(f"lse off by {lse_err}")
    if bad:
        emit(row)
        raise AssertionError(f"flash {hq}/{hkv} causal={causal} {dtype}"
                             f"{' segments' if segs else ''}: "
                             + "; ".join(bad))
    if not timed:
        return row
    def bwd():
        dl = entry["bwd_delta"](out)
        entry["bwd_dkdv"](lse, dl)
        entry["bwd_dq"](lse, dl)

    kern = {
        "fwd": cuda_ms(entry["fwd"]),
        "bwd_delta": cuda_ms(lambda: entry["bwd_delta"](out)),
        "bwd_dkdv": cuda_ms(lambda: entry["bwd_dkdv"](lse, delta)),
        "bwd_dq": cuda_ms(lambda: entry["bwd_dq"](lse, delta)),
        "bwd": cuda_ms(bwd),
        "fwd_bwd": cuda_ms(lambda: fwd_bwd(attn)),
    }
    qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
    plain_out = plain(qp, kp, vp)

    def plain_grad(inputs):
        return lambda: torch.autograd.grad(plain_out, inputs, do,
                                           retain_graph=True)

    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: plain(q, k, v), reps=5, warmup=1)
    plain_ms = {
        "fwd": plain_fwd,
        "bwd_delta": cuda_ms(lambda: (out.float() * do.float()).sum(-1)
                             .transpose(1, 2).contiguous(), reps=5, warmup=1),
        "bwd_dkdv": cuda_ms(plain_grad((kp, vp)), reps=5, warmup=1),
        "bwd_dq": cuda_ms(plain_grad((qp,)), reps=5, warmup=1),
        "bwd": cuda_ms(lambda: plain_bwd(out), reps=5, warmup=1),
        "fwd_bwd": cuda_ms(lambda: fwd_bwd(plain), reps=5, warmup=1),
    }
    del plain_out
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

    def sdpa(a, b, c):
        if lib_mask is None:
            return F.scaled_dot_product_attention(
                a, b, c, is_causal=causal, scale=scale,
                enable_gqa=hq != hkv)
        return F.scaled_dot_product_attention(
            a, b, c, attn_mask=lib_mask, scale=scale, enable_gqa=hq != hkv)

    def sdpa_fwd_bwd():
        a, b, c = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa(a, b, c).backward(dot)

    # the library's backward alone: autograd of the retained F.sdpa output
    lib_in = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    lib_out = sdpa(*lib_in)
    library = {"fwd": cuda_ms(lambda: sdpa(qt, kt, vt)),
               "bwd": cuda_ms(lambda: torch.autograd.grad(
                   lib_out, lib_in, dot, retain_graph=True)),
               "fwd_bwd": cuda_ms(sdpa_fwd_bwd)}
    del lib_out, lib_in
    bounds = {}
    for name, (nbytes, ops) in _flash_bounds(pairs, B, sq, sk, hq, hkv,
                                              q.element_size(), id_bytes,
                                              d).items():
        b_ms, b_by = bound(nbytes, ops, str(dtype))
        bounds[name] = {"bytes": nbytes, "ops": ops, "bound_ms": b_ms,
                        "bound_by": b_by}
    row.update(kernel_ms=kern, plain_ms=plain_ms, library_ms=library,
               bounds=bounds)
    if beside_k1:
        row["k1_causal_ms"] = {
            "fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, True, scale)),
            "fwd_bwd": cuda_ms(lambda: fwd_bwd(
                lambda a, b, c: fa.FlashAttention.apply(a, b, c, True,
                                                        scale)))}
    return row


def phase_flash(phase, hq, hkv, seed):
    """``phase`` k1 (MHA) or k2 (GQA): the main case at the training
    path's shape (B 2, S 2048, causal, bf16), timed; for k1 also a full
    case, an Sq != Sk causal case with tails past every tile, and an f32
    case. Then the bf16 forward's edges (``edge_cases``): Sq and Sk no
    multiple of its 128-row and 128-key tiles, causal Sq < Sk, head dim
    64, and a grid of fewer (batch, head) pairs than the card's 132 SMs."""
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
    bf16 = dict(dtype=torch.bfloat16, timed=False)
    small = (4, 4) if hq == hkv else (8, 1)    # B 1: 16 x Hq tiles < 132
    cases += [dict(edge="tails", B=2, sq=1000, sk=1900, causal=False, **bf16),
              dict(edge="tails_causal", B=2, sq=1000, sk=1900, causal=True,
                   **bf16),
              dict(edge="d64", B=2, sq=2048, sk=2048, causal=True, d=64,
                   **bf16),
              dict(edge="few_blocks", B=1, sq=2048, sk=2048, causal=True,
                   hq=small[0], hkv=small[1], **bf16)]
    rows = []
    for c in cases:
        row = flash_case(gen, c["B"], c["sq"], c["sk"], c.get("hq", hq),
                         c.get("hkv", hkv), c["causal"], c["dtype"],
                         c["timed"], d=c.get("d", D))
        if "edge" in c:
            row["edge"] = c["edge"]
        row["phase"] = phase
        emit(row)
        rows.append(row)
        torch.cuda.empty_cache()
    if phase == "k1":
        emit(concurrent_forwards(gen))
        growing_cache_edges(gen)
    return rows


def concurrent_forwards(gen, n_cases=24, n_streams=4, reps=3):
    """The bf16 forward's launches share nothing: seeded cases of mixed
    shapes (K1 and K2, causal and full, D 64 and 128, Sq and Sk no multiple
    of 128, B x H below and above the SM count), launched on ``n_streams``
    streams at once, ``reps`` times, each equal bit for bit to the same
    call made alone. The persistent kernel's blocks walk a fixed stride of
    work tiles and keep no state in device memory; state shared by two
    launches in flight would drop or repeat tiles. Returns the phase row;
    raises on a mismatch."""
    import random

    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    rng = random.Random(15)
    cases = []
    for _ in range(n_cases):
        B, hkv, d = rng.choice([1, 2]), rng.choice([1, 4, 8]), rng.choice(
            [64, 128])
        hq, sq = hkv * rng.choice([1, 4]), rng.choice([100, 513, 1024, 2048])
        sk = rng.choice([sq, sq + 37])
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((B, sq, hq, d), (B, sk, hkv, d),
                                          (B, sk, hkv, d)))
        cases.append((q, k, v, rng.random() < 0.6, d ** -0.5))
    want = [fa.flash_fwd(*c) for c in cases]
    streams = [torch.cuda.Stream() for _ in range(n_streams)]
    mismatches = 0
    for _ in range(reps):
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        got = []
        for i, c in enumerate(cases):
            with torch.cuda.stream(streams[i % n_streams]):
                got.append(fa.flash_fwd(*c))
        torch.cuda.synchronize()
        mismatches += sum(not (torch.equal(g[0], w[0])
                               and torch.equal(g[1], w[1]))
                          for g, w in zip(got, want))
    row = {"phase": "k1", "check": "concurrent_forwards", "cases": n_cases,
           "streams": n_streams, "reps": reps, "mismatches": mismatches}
    if mismatches:
        emit(row)
        raise AssertionError(f"concurrent forwards: {mismatches} of "
                             f"{n_cases * reps} differ from the call alone")
    return row


def _ring_shards(x, n):
    """[B, S, H, D] -> the sep ranks' sequence shards stacked [n, B, S / n,
    H, D] (contiguous), the layout ``RingFlashAttention`` takes."""
    B, S = x.shape[:2]
    return x.reshape(B, n, S // n, *x.shape[2:]).transpose(0, 1).contiguous()


def ring_case(gen, B, s_loc, hq, hkv, causal, dtype, timed, n=4, d=D):
    """One K6 case on the card: a sep-``n`` ring over cuda:0 on q [B, n
    s_loc, Hq, D] and k, v [B, n s_loc, Hkv, D]. ``RingFlashAttention``'s
    output and gradients (K6 per kept visit, K1's backward entries) against
    the plain ring (``_ring_block_impl`` through autograd) on the same
    inputs, row by row (dQ rows of the first FEW_KEYS global positions
    counted apart, as in k1: there autograd's delta and the kernels' differ
    by the rounding of the stored O); one ``ring_flash_fwd`` launch merging
    into a state already holding a full visit, against its plain version
    (``_visit_math`` + ``_ring_merge_math``); the public ``ring_attention``
    equal to the kernel path bit for bit. With ``timed``: CUDA-event
    medians of the ring's forward and forward + backward, the plain ring's,
    K1 over the whole sequence (``flash_fwd``, ``FlashAttention``) and
    F.scaled_dot_product_attention over it (the library time), and the
    bounds of the whole function over the n s_loc positions. A second run of
    the kernel path must give the same bits."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.distributed import build_mesh, mesh_guard
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ring_attention as ra

    S = n * s_loc

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do = rand((B, S, hq, d)), rand((B, S, hq, d))
    k, v = rand((B, S, hkv, d)), rand((B, S, hkv, d))
    scale = d ** -0.5
    qs, ks, vs, dos = (_ring_shards(t, n) for t in (q, k, v, do))

    def kernel_ring(a, b, c):
        return ra.RingFlashAttention.apply(a, b, c, causal, scale)

    def plain_ring(a, b, c):
        out = ra._ring_block_impl(*(t.transpose(2, 3) for t in (a, b, c)),
                                  causal, scale, None)
        return out.transpose(2, 3)

    def fwd_bwd(fn, inputs=(qs, ks, vs), dout=dos):
        xs = [t.detach().requires_grad_() for t in inputs]
        out = fn(*xs)
        out.backward(dout)
        return (out.detach(), *(x.grad for x in xs))

    with mesh_guard(build_mesh(sep=n, devices=["cuda:0"] * n)):
        n0 = fa.ring_flash_fwd.launches
        got = fwd_bwd(kernel_ring)
        torch.cuda.synchronize()
        launches = fa.ring_flash_fwd.launches - n0
        # the ring's f32 sums, added by the kernels, repeat bit for bit
        deterministic = all(torch.equal(a, b) for a, b in zip(
            got, fwd_bwd(kernel_ring)))
        want = fwd_bwd(plain_ring)
        public = ra.ring_attention(*(t.transpose(2, 3) for t in (qs, ks, vs)),
                                   causal=causal, scale=scale)
        public_equal = (ra.LAST_IMPL == "ring-kernel"
                        and torch.equal(public.transpose(2, 3), got[0]))
    few = _few_keys(B, S, S, hq, causal).reshape(B, n, s_loc, hq).transpose(
        0, 1).reshape(-1)
    f32 = dtype == torch.float32
    checks = {"o": row_check(got[0], want[0], True)}
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        checks[name] = row_check(g, w, f32, few if name == "dq" else None)
    del want
    # one launch on its own inputs: rank 1's diagonal (or second) visit
    # merged into a state holding its visit of rank 0's shard
    o_acc, lse_acc = fa._visit_math(qs[1], ks[0], vs[0], False, scale)
    o_acc, lse_acc = o_acc.contiguous(), lse_acc.contiguous()
    want_o, want_lse = fa._ring_merge_math(
        o_acc, lse_acc, *fa._visit_math(qs[1], ks[1], vs[1], causal, scale))
    fa.ring_flash_fwd(qs[1], ks[1], vs[1], o_acc, lse_acc, causal, scale)
    entry = {"o": row_check(o_acc.to(dtype), want_o.to(dtype), True),
             "lse_max_abs_err": float((lse_acc - want_lse).abs().max())}
    pairs = _visible_pairs(S, S, causal) * B * hq
    row = {"B": B, "sep": n, "s_local": s_loc, "S": S, "hq": hq, "hkv": hkv,
           "d": d, "causal": causal, "dtype": str(dtype),
           "visible_pairs": pairs, "launches_per_call": launches,
           "launches_expected": n * (n + 1) // 2 if causal else n * n,
           "max_abs_err": {**{k: c["max_abs_err"] for k, c in checks.items()},
                           "entry_o": entry["o"]["max_abs_err"]},
           "checks": checks, "entry": entry,
           "public_entry_equal": public_equal, "deterministic": deterministic}
    bad = [f"{name}: {c}" for name, c in (*checks.items(), ("entry o",
                                                             entry["o"]))
           if c["bad_rows"] or c["bad_elements"] or not c["finite"]]
    if entry["lse_max_abs_err"] > 1e-3:
        bad.append(f"entry lse off by {entry['lse_max_abs_err']}")
    if not public_equal:
        bad.append("the public ring_attention differs from the kernel path")
    if not deterministic:
        bad.append("two runs of the ring's backward differ")
    if launches != row["launches_expected"]:
        bad.append(f"{launches} K6 launches, expected "
                   f"{row['launches_expected']}")
    if bad:
        emit(row)
        raise AssertionError(f"ring {hq}/{hkv} causal={causal} {dtype}: "
                             + "; ".join(bad))
    if not timed:
        return row
    kern = {"fwd": cuda_ms(lambda: ra._ring_kernel_fwd_impl(
                qs, ks, vs, causal, scale)),
            "fwd_bwd": cuda_ms(lambda: fwd_bwd(kernel_ring))}
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: plain_ring(qs, ks, vs), reps=3, warmup=1)
    plain_ms = {"fwd": plain_fwd,
                "fwd_bwd": cuda_ms(lambda: fwd_bwd(plain_ring), reps=3,
                                   warmup=1)}

    def k1(a, b, c):
        return fa.FlashAttention.apply(a, b, c, causal, scale)

    k1_whole = {"fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
                "fwd_bwd": cuda_ms(lambda: fwd_bwd(k1, (q, k, v), do))}
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=causal,
                                              scale=scale,
                                              enable_gqa=hq != hkv)

    library = {"fwd": cuda_ms(lambda: sdpa(qt, kt, vt)),
               "fwd_bwd": cuda_ms(lambda: fwd_bwd(sdpa, (qt, kt, vt), dot))}
    parts = _flash_bounds(pairs, B, S, S, hq, hkv, q.element_size(), d=d)
    bounds = {}
    for name, (nbytes, ops) in (("fwd", parts["fwd"]),
                                ("fwd_bwd", (parts["fwd"][0]
                                             + parts["bwd"][0],
                                             parts["fwd"][1]
                                             + parts["bwd"][1]))):
        b_ms, b_by = bound(nbytes, ops, str(dtype))
        bounds[name] = {"bytes": nbytes, "ops": ops, "bound_ms": b_ms,
                        "bound_by": b_by}
    row.update(kernel_ms=kern, plain_ms=plain_ms, k1_whole_ms=k1_whole,
               library_ms=library, bounds=bounds)
    return row


def phase_k6(seed=12):
    """K6 on a sep-4 ring over cuda:0 at D 128, B 1, S 4 x 2048 = 8192:
    causal bf16 MHA 32/32 (LLaMA-2-7B attention) and GQA 64/8 (K2's
    widths), timed; full (non-causal) MHA, and an f32 case at S 4 x 256.
    Then the bf16 forward's edges, causal: shards of 1000 (no multiple of
    its 128-row tiles), head dim 64, and Hq 4 (fewer blocks than SMs); a
    ring visit has Sq == Sk, so causal Sq < Sk is k1's and k3's edge."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [dict(s_loc=2048, hq=HQ, hkv=HQ, causal=True,
                  dtype=torch.bfloat16, timed=True),
             dict(s_loc=2048, hq=64, hkv=8, causal=True,
                  dtype=torch.bfloat16, timed=True),
             dict(s_loc=2048, hq=HQ, hkv=HQ, causal=False,
                  dtype=torch.bfloat16, timed=False),
             dict(s_loc=256, hq=HQ, hkv=HQ, causal=True, dtype=torch.float32,
                  timed=False)]
    bf16 = dict(causal=True, dtype=torch.bfloat16, timed=False)
    cases += [dict(edge="tails", s_loc=1000, hq=HQ, hkv=HQ, **bf16),
              dict(edge="d64", s_loc=2048, hq=HQ, hkv=HQ, d=64, **bf16),
              dict(edge="few_blocks", s_loc=2048, hq=4, hkv=4, **bf16)]
    rows = []
    for c in cases:
        row = ring_case(gen, 1, c["s_loc"], c["hq"], c["hkv"], c["causal"],
                        c["dtype"], c["timed"], n=CP_SEP, d=c.get("d", D))
        if "edge" in c:
            row["edge"] = c["edge"]
        row["phase"] = "k6"
        emit(row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


SFT_LENGTHS = (64, 1024)   # conversation lengths of the packed rows


def sft_rows(seed, B, S, lengths=SFT_LENGTHS):
    """Segment ids [B, S] (int32) of rows packed greedily, in order, from
    seeded conversation lengths uniform in ``lengths``: a conversation
    that does not fit in what is left of a row opens the next row, and the
    row's tail becomes a padding segment with an id of its own. Returns the
    ids and each row's conversation lengths."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def draw():
        return int(rng.randint(lengths[0], lengths[1] + 1))

    rows, convs, n = [], [], draw()
    for _ in range(B):
        lens = []
        while sum(lens) + n <= S:
            lens.append(n)
            n = draw()
        parts = lens + ([S - sum(lens)] if sum(lens) < S else [])
        rows.append(np.concatenate([np.full(m, i, np.int32)
                                    for i, m in enumerate(parts)]))
        convs.append(lens)
    return np.stack(rows), convs


def sft_labels(ids, seg, convs):
    """Next-token labels of packed rows: -100 at each segment's last token
    (no prediction across a boundary) and on the padding tail."""
    import numpy as np

    labels = np.roll(ids, -1, axis=1).astype(np.int64)
    last = np.ones(seg.shape, bool)
    last[:, :-1] = seg[:, 1:] != seg[:, :-1]
    labels[last] = -100
    for b, lens in enumerate(convs):
        labels[b, sum(lens):] = -100
    return labels


def varlen_offsets(rng, n, pad):
    """Cumulative offsets of ``n`` seeded lengths in SFT_LENGTHS, and a
    total ``pad`` tokens past the last (tokens of the padding sequence)."""
    import numpy as np

    cu = np.zeros(n + 1, np.int64)
    cu[1:] = np.cumsum(rng.randint(SFT_LENGTHS[0], SFT_LENGTHS[1] + 1, n))
    return cu, int(cu[-1]) + pad


def phase_k3(seed=9):
    """K3 (segment-masked flash attention) on the card. Packed rows at
    LLaMA-2-7B attention (B 2, S 2048 of conversations of 64-1024 tokens,
    ``sft_rows``; bf16, causal): MHA 32/32 timed, with K1's causal forward
    and forward + backward on the same tensors beside, through the public
    ``flash_attention_packed`` too; GQA 64/8 on the same rows, timed; an
    f32 case. The varlen form (batch 1 of [total, 32, 128], total no
    multiple of 64, 5 padding tokens past the last sequence):
    self-attention causal (timed, through ``flash_attn_unpadded`` too) and
    full, a cross-offset case (each sequence's q and k lengths differ) and
    one with an empty key sequence. Then the bf16 forward's edges: packed
    rows of S 1000 (no multiple of its 128-row tiles), varlen keys twice
    each sequence's queries (causal Sq < Sk), head dim 64, one packed
    row at Hq 4 (fewer blocks than SMs), and packed rows of 1-3 token
    segments (one-token segments among them). Every case runs the backward
    too (``flash_case``)."""
    import importlib

    import numpy as np
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    tF = importlib.import_module(
        "paddle_tpu_torch.nn.functional.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    seg, _ = sft_rows(seed, 2, 2048)
    seg = torch.from_numpy(seg).cuda()
    small = torch.from_numpy(sft_rows(seed + 1, 1, 300, (20, 120))[0]).cuda()
    rng = np.random.RandomState(seed + 2)
    cu_q, tq = varlen_offsets(rng, 3, 5)
    cu_x, tx = varlen_offsets(rng, 3, 5)   # the cross-offset keys
    cu_e = cu_q.copy()
    cu_e[2:] -= cu_e[2] - cu_e[1]          # sequence 1 has no key
    te = int(cu_e[-1]) + 5
    cu_l = 2 * cu_q                        # each sequence's keys: 2x its q
    tl = int(cu_l[-1]) + 5
    seg_tails = torch.from_numpy(sft_rows(seed + 3, 2, 1000)[0]).cuda()
    seg_ones = torch.from_numpy(sft_rows(seed + 4, 2, 300, (1, 3))[0]).cuda()

    def packed_entry(rows):
        return lambda a, b, c: fa.flash_attention_packed(a, b, c, rows)

    def varlen_entry(ck, causal):
        return lambda a, b, c: tF.flash_attn_unpadded(
            a[0], b[0], c[0], torch.from_numpy(cu_q).cuda(),
            torch.from_numpy(ck).cuda(), None, None, causal=causal)[0][None]

    def varlen(ck, tk):
        return fa._varlen_segments(cu_q, ck, tq, tk, "cuda")

    cases = [
        ("packed", dict(B=2, sq=2048, sk=2048, hq=HQ, hkv=HQ, causal=True,
                        dtype=bf16, timed=True,
                        segs=fa._packed_segments(seg),
                        public=packed_entry(seg), beside_k1=True)),
        ("packed", dict(B=2, sq=2048, sk=2048, hq=64, hkv=8, causal=True,
                        dtype=bf16, timed=True,
                        segs=fa._packed_segments(seg))),
        ("packed", dict(B=1, sq=300, sk=300, hq=HQ, hkv=HQ, causal=True,
                        dtype=f32, timed=False,
                        segs=fa._packed_segments(small))),
        ("varlen", dict(B=1, sq=tq, sk=tq, hq=HQ, hkv=HQ, causal=True,
                        dtype=bf16, timed=True, segs=varlen(cu_q, tq),
                        public=varlen_entry(cu_q, True))),
        ("varlen", dict(B=1, sq=tq, sk=tq, hq=HQ, hkv=HQ, causal=False,
                        dtype=bf16, timed=False, segs=varlen(cu_q, tq),
                        public=varlen_entry(cu_q, False))),
        ("varlen_cross_offset", dict(B=1, sq=tq, sk=tx, hq=HQ, hkv=HQ,
                                     causal=True, dtype=bf16, timed=False,
                                     segs=varlen(cu_x, tx))),
        ("varlen_empty_key", dict(B=1, sq=tq, sk=te, hq=HQ, hkv=HQ,
                                  causal=True, dtype=bf16, timed=False,
                                  segs=varlen(cu_e, te))),
        ("packed_tails", dict(B=2, sq=1000, sk=1000, hq=HQ, hkv=HQ,
                              causal=True, dtype=bf16, timed=False,
                              segs=fa._packed_segments(seg_tails))),
        ("varlen_longer_keys", dict(B=1, sq=tq, sk=tl, hq=HQ, hkv=HQ,
                                    causal=True, dtype=bf16, timed=False,
                                    segs=varlen(cu_l, tl))),
        ("packed_d64", dict(B=2, sq=2048, sk=2048, hq=HQ, hkv=HQ,
                            causal=True, dtype=bf16, timed=False,
                            segs=fa._packed_segments(seg), d=64)),
        ("packed_few_blocks", dict(B=1, sq=2048, sk=2048, hq=4, hkv=4,
                                   causal=True, dtype=bf16, timed=False,
                                   segs=fa._packed_segments(seg[:1]))),
        ("packed_short_segments", dict(B=2, sq=300, sk=300, hq=HQ, hkv=HQ,
                                       causal=True, dtype=bf16, timed=False,
                                       segs=fa._packed_segments(seg_ones))),
    ]
    rows = []
    for form, c in cases:
        row = flash_case(gen, **c)
        row.update(phase="k3", form=form)
        if form.startswith("varlen"):
            row["cu_q"] = cu_q.tolist()
            row["cu_k"] = {"varlen": cu_q, "varlen_cross_offset": cu_x,
                           "varlen_empty_key": cu_e,
                           "varlen_longer_keys": cu_l}[form].tolist()
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
            e, n = _ulp_check(f"adamw {dtype} {name}", got, want, ulp)
            err, differ = max(err, e), differ + n
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
    rows.append(_adamw_master(gen))
    return rows


def _ulp_check(name, got, want, ulp):
    """``got`` within two ulps of ``want`` per element plus one ulp of the
    tensor's largest magnitude (phase_adamw's rule); returns (max abs
    error, elements differing)."""
    g32, w32 = got.float(), want.float()
    diff = (g32 - w32).abs()
    bad = diff > 4 * ulp * w32.abs() + ulp * float(w32.abs().max())
    if bad.any():
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements past tolerance, e.g. "
            f"{float(g32.flatten()[i])} vs {float(w32.flatten()[i])}")
    return float(diff.max()), int((diff > 0).sum())


# Kernel B's recipe instances that _adamw_master holds against the plain
# version: (f32 master, loss scale, clip factor, decay, dynamics epilogue).
# A bf16 gradient times the clip factor with no scale is rounded back to
# bf16 in the kernel: that is LLaMA 2's recipe in bf16 (no scaler), with
# and without the epilogue.
ADAMW_RECIPE_CASES = (
    (True, False, False, None, True),
    (True, True, True, None, True),
    (True, False, True, None, False),
    (True, False, True, None, True),
    (True, True, True, "L2", False),
    (True, False, True, "L1", True),
    (False, False, True, "L1", False),
    (False, True, False, "L2", True),
)


def _adamw_master(gen):
    """Kernel B's training-recipe instances on one LLaMA-2-7B MLP weight
    (11008 x 4096), each case (``ADAMW_RECIPE_CASES``) after three updates
    against the plain version on the same inputs: a bf16 parameter with
    f32 master, m and v (or bf16 p, m and v alone) and a bf16 gradient;
    with or without the loss scale and the clip factor (each one f32 on
    the card), the L1 or L2 decay, and the dynamics epilogue. Master, m and
    v within phase_adamw's two-ulp rule in their dtype, p the master
    rounded to bf16 and within the rule in bf16; the epilogue's sums of
    p_old^2 and of the update's squares against the same sums over the
    kernel's own p in f64, 1e-6 relative. Times, on the master instance
    with scale and factor: the kernel without and with the epilogue, the
    plain version, and the library's two calls (``torch._fused_adamw_`` on
    the master, then ``p.copy_(master)``; no single PyTorch call computes
    the update and the bf16 parameter)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import adamw
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay

    shape = (11008, 4096)
    p0 = (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(
        torch.bfloat16)
    # the unscaled gradients' size: a scaled case sees them times the scale
    raw = [0.3 * torch.randn(shape, generator=gen, device="cuda")
           for _ in range(3)]
    scale = torch.tensor(1024.0, device="cuda")
    factor = torch.tensor(0.37, device="cuda")
    args = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-5,
                factor=float(np.float32(1) - np.float32(3e-4 * 0.1)))
    regs = {"L1": L1Decay(0.1), "L2": L2Decay(4.0)}
    err, differ, dyn_err, checked, timed = 0.0, 0, 0.0, [], None
    for master_on, scaled, clipped, reg, dyn in ADAMW_RECIPE_CASES:
        grads = [(x * 1024.0 if scaled else x).to(torch.bfloat16)
                 for x in raw]
        sc, fa = (scale if scaled else None), (factor if clipped else None)
        rg = regs.get(reg)
        states = []
        for tier in ("kernel", "plain"):
            p = p0.clone()
            master = p0.float() if master_on else None
            m, v = (torch.zeros_like(master if master_on else p)
                    for _ in range(2))
            norms = adamw.UpdateNorms([p], [0], 1) if dyn else None
            for step, g in enumerate(grads, start=1):
                if tier == "plain":
                    adamw._adamw_plain(
                        p, g, m, v, (args["lr"], args["beta1"],
                                     args["beta2"], args["eps"], step,
                                     args["factor"]), master, sc, fa, rg,
                        None)
                    continue
                old = p.clone() if dyn else None
                if dyn:
                    norms.begin()
                adamw.adamw_update(p, g, m, v, step=step, master=master,
                                   scale=sc, grad_factor=fa,
                                   regularization=rg, norms=norms, **args)
                if dyn:
                    out = norms.reduce()
                    d = (p.float() - old.float()).double()
                    want = torch.stack([old.double().square().sum(),
                                        d.square().sum()])
                    got = out[:, 0].double()
                    rel = float(((got - want).abs() / want.clamp_min(
                        1e-30)).max())
                    dyn_err = max(dyn_err, rel)
                    if rel > 1e-6:
                        raise AssertionError(
                            f"adamw recipe {reg} dynamics: {got.tolist()} vs "
                            f"{want.tolist()}")
            states.append((p, master, m, v))
        torch.cuda.synchronize()
        case = (f"master={master_on} scale={scaled} factor={clipped} "
                f"reg={reg} dynamics={dyn}")
        ulp = 2 ** -24 if master_on else 2 ** -8
        for name, got, want in zip(("master", "m", "v"), states[0][1:],
                                   states[1][1:]):
            if got is None:
                continue
            e, n = _ulp_check(f"adamw {case} {name}", got, want, ulp)
            err, differ = max(err, e), differ + n
        if master_on and not torch.equal(states[0][0],
                                         states[0][1].to(torch.bfloat16)):
            raise AssertionError(f"adamw {case}: p is not its master rounded")
        e, n = _ulp_check(f"adamw {case} p", states[0][0], states[1][0],
                          2 ** -8)
        err, differ = max(err, e), differ + n
        checked.append(case)
        if master_on and scaled and clipped and reg is None:
            timed = states[0], grads[0]
        del states, grads
    (p, master, m, v), g = timed
    norms = adamw.UpdateNorms([p], [0], 1)
    ms = cuda_ms(lambda: adamw.adamw_update(
        p, g, m, v, step=4, master=master, scale=scale, grad_factor=factor,
        **args))
    ms_dyn = cuda_ms(lambda: adamw.adamw_update(
        p, g, m, v, step=4, master=master, scale=scale, grad_factor=factor,
        norms=norms, **args))
    plain_ms = cuda_ms(lambda: adamw._adamw_plain(
        p, g, m, v, (args["lr"], args["beta1"], args["beta2"], args["eps"],
                     4, args["factor"]), master, scale, factor, None, None),
        reps=5, warmup=1)
    lib_master = master.detach().clone()
    lib_grad = g.float()
    lib_m, lib_v = m.clone(), v.clone()
    lib_step = torch.tensor(4.0, device="cuda")

    def library():
        torch._fused_adamw_([lib_master], [lib_grad], [lib_m], [lib_v], [],
                            [lib_step], lr=3e-4, beta1=0.9, beta2=0.95,
                            weight_decay=0.1, eps=1e-5, amsgrad=False,
                            maximize=False)
        p.copy_(lib_master)

    lib_ms = cuda_ms(library)
    n = p0.numel()
    nbytes, ops = 28 * n, 30 * n
    b_ms, b_by = bound(nbytes, ops, "torch.float32")
    row = {"phase": "adamw", "instance": "master", "shape": list(shape),
           "dtype": "bf16 p, f32 master/m/v, bf16 g",
           "cases": checked, "max_abs_err": err,
           "elements_differing": differ, "dynamics_max_rel_err": dyn_err,
           "kernel_ms": ms,
           "kernel_ms_with_dynamics": ms_dyn, "plain_ms": plain_ms,
           "library_ms": lib_ms,
           "library": "torch._fused_adamw_ on the f32 master, then "
                      "p.copy_(master): no single call computes it",
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}
    emit(row)
    del timed, raw, lib_master, lib_grad, lib_m, lib_v
    torch.cuda.empty_cache()
    return row


def _llama_grad_shapes(layers, cfg=None):
    """{name: shape} of LLaMA-2-7B's parameters at ``layers`` layers (the
    embedding, each layer's projections and norms, the final norm, the
    head), in the model's order: the gradients a step hands kernel A."""
    h, m, v = 4096, 11008, 32000
    shapes = {"llama.embed_tokens.weight": (v, h)}
    for i in range(layers):
        pre = f"llama.layers.{i}."
        for proj in ("q", "k", "v", "o"):
            shapes[f"{pre}self_attn.{proj}_proj.weight"] = (h, h)
        shapes[f"{pre}mlp.gate_proj.weight"] = (m, h)
        shapes[f"{pre}mlp.up_proj.weight"] = (m, h)
        shapes[f"{pre}mlp.down_proj.weight"] = (h, m)
        shapes[f"{pre}input_layernorm.weight"] = (h,)
        shapes[f"{pre}post_attention_layernorm.weight"] = (h,)
    shapes["llama.norm.weight"] = (h,)
    shapes["lm_head.weight"] = (v, h)
    return shapes


def _check_sumsq(name, got, want, rel=1e-6):
    """Kernel A's outputs against its plain version's: sums, group sums,
    total and factor within ``rel`` relative (inf where the plain one is
    inf), every flag exact. Returns the largest relative and absolute
    errors."""
    import torch

    out_g, flags_g = got
    out_w, flags_w = want
    if not torch.equal(flags_g, flags_w):
        raise AssertionError(f"{name}: flags {flags_g.tolist()} vs "
                             f"{flags_w.tolist()}")
    g, w = out_g.double(), out_w.double()
    same_inf = torch.isinf(g) == torch.isinf(w)
    finite = torch.isfinite(w) & torch.isfinite(g)
    err = ((g - w).abs() / w.abs().clamp_min(1e-30))[finite]
    worst = float(err.max()) if err.numel() else 0.0
    worst_abs = float((g - w).abs()[finite].max()) if err.numel() else 0.0
    if not same_inf.all() or worst > rel or (torch.isnan(g) != torch.isnan(
            w)).any():
        raise AssertionError(f"{name}: sums apart by {worst} (limit {rel}) "
                             f"or inf/nan differ: {g.tolist()[:8]} vs "
                             f"{w.tolist()[:8]}")
    return worst, worst_abs


def phase_grad_norm(seed=15):
    """Kernel A (the multi-tensor gradient norm) against its plain version
    on the card: the gradient list of 2 layers at LLaMA-2-7B widths plus
    the embedding and the head, bf16 and f32, without a scale, with a
    power-of-two scale and with 3.0, grouped as the dynamics group them;
    edge lists (1 element, 7 elements, 1,000,003 elements, dtypes mixed);
    a planted NaN, a planted Inf and a finite 1e30 whose square overflows.
    Sums within 1e-6 relative, flags exact, two launches bit-identical.
    Times (bf16 list, no scale): the kernel, its plain version and
    ``torch._foreach_norm`` over the same list (the library call)."""
    import torch

    from paddle_tpu_torch.observability.dynamics import group_of
    from paddle_tpu_torch.ops import grad_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = _llama_grad_shapes(2)
    names = list(shapes)
    group_names = sorted({group_of(n) for n in names})
    groups = [group_names.index(group_of(n)) for n in names]
    rows, worst, worst_abs = [], 0.0, 0.0

    def run(name, tensors, scale, grp, n_groups, clip=1.0):
        nonlocal worst, worst_abs
        sc = None if scale is None else torch.tensor(
            scale, dtype=torch.float32, device="cuda")
        a = gn.grad_sumsq(tensors, scale=sc, clip_norm=clip, groups=grp,
                          n_groups=n_groups)
        ref = gn._sumsq_math(tensors, sc, clip, grp or [-1] * len(tensors),
                             n_groups)
        b = gn.grad_sumsq(tensors, scale=sc, clip_norm=clip, groups=grp,
                          n_groups=n_groups)
        torch.cuda.synchronize()
        out_a = torch.cat([a.sums, a.group_sums, a.total[None],
                           a.norm[None], a.factor[None]])
        out_b = torch.cat([b.sums, b.group_sums, b.total[None],
                           b.norm[None], b.factor[None]])
        out_r = torch.cat([ref.sums, ref.group_sums, ref.total[None],
                           ref.norm[None], ref.factor[None]])
        fl = lambda x: torch.cat([x.nonfinite, x.group_nonfinite,
                                  x.any_nonfinite[None]])
        if not torch.equal(out_a.view(torch.int32), out_b.view(torch.int32)):
            raise AssertionError(f"grad_norm {name}: two launches differ")
        rel, err = _check_sumsq(f"grad_norm {name}", (out_a, fl(a)),
                                (out_r, fl(ref)))
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
        return a

    for dtype in (torch.bfloat16, torch.float32):
        grads = [(1e-3 * torch.randn(s, generator=gen, device="cuda")).to(
            dtype) for s in shapes.values()]
        for scale in (None, 1024.0, 3.0):
            run(f"7b-2layers {dtype} scale {scale}", grads, scale, groups,
                len(group_names))
        grads[3].view(-1)[1234] = float("nan")
        grads[7].view(-1)[0] = float("inf")
        grads[-2].view(-1)[-1] = 1e30
        st = run(f"planted {dtype}", grads, 1024.0, groups, len(group_names))
        want = [int(i in (3, 7)) for i in range(len(grads))]
        if st.nonfinite.tolist() != want or not torch.isinf(st.sums[-2]):
            raise AssertionError(f"grad_norm planted {dtype}: flags "
                                 f"{st.nonfinite.tolist()}, sums {st.sums}")
        if dtype == torch.bfloat16:
            for t, i in ((grads[3], 1234), (grads[7], 0), (grads[-2], -1)):
                t.view(-1)[i] = 0.0
            n_el = sum(t.numel() for t in grads)
            nbytes = n_el * grads[0].element_size() + 4 * (3 + 2 * len(grads))
            ms = cuda_ms(lambda: gn.grad_sumsq(grads))
            plain_ms = cuda_ms(lambda: gn._sumsq_math(
                grads, None, None, [-1] * len(grads), 0), reps=5, warmup=1)
            lib_ms = cuda_ms(lambda: torch._foreach_norm(grads))
            b_ms, b_by = bound(nbytes, 3 * n_el, "torch.float32")
            row = {"phase": "grad_norm", "tensors": len(grads),
                   "elements": n_el, "dtype": str(dtype), "kernel_ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library": "torch._foreach_norm over the same list",
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            rows.append(row)
        del grads
        torch.cuda.empty_cache()
    edges = [torch.randn(1, generator=gen, device="cuda"),
             torch.randn(7, generator=gen, device="cuda").to(torch.bfloat16),
             torch.randn(1_000_003, generator=gen, device="cuda"),
             torch.randn(1_000_003, generator=gen, device="cuda").to(
                 torch.bfloat16),
             torch.randn(CHUNK_EDGE, generator=gen, device="cuda")]
    for scale in (None, 2.0 ** 15, 3.0):
        run(f"edges scale {scale}", edges, scale, [0, 1, 0, 1, 2], 3)
        run(f"edges alone scale {scale}", edges[1:2], scale, None, 0)
    rows[0].update(max_rel_err=worst, max_abs_err=worst_abs)
    emit(rows[0])
    return rows


CHUNK_EDGE = 65536 + 8      # one kernel-A chunk and one vector more


def _flash_wrappers():
    """{kernel line name: wrapper} of the training path's attention
    kernels: K1/K2's four flash entries (flash_attention_fwd, ...), K3's
    (flash_attention_seg_fwd, ...) and K6's (flash_attention_ring_fwd)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    out = {"flash_attention_" + k.__name__.removeprefix("flash_"): k
           for k in fa.KERNELS}
    out.update({"flash_attention_seg_" + k.__name__.removeprefix(
        "seg_flash_"): k for k in fa.SEG_KERNELS})
    out["flash_attention_ring_fwd"] = fa.ring_flash_fwd
    return out


def _flash_counts():
    """Launch counts of the training path's kernels: the K1/K2 and K3
    flash entries, the AdamW update, the gradient-norm kernel (kernel A)
    and the dynamics reduction of the AdamW kernel's epilogue."""
    from paddle_tpu_torch.ops.adamw import UpdateNorms, adamw_update
    from paddle_tpu_torch.ops.grad_norm import grad_sumsq

    counts = {name: k.launches for name, k in _flash_wrappers().items()}
    counts["adamw_update"] = adamw_update.launches
    counts["grad_sumsq"] = grad_sumsq.launches
    counts["adamw_dynamics_reduce"] = UpdateNorms.reduces
    counts.update(_moe_counts())
    return counts


def _reset_flash_counts():
    from paddle_tpu_torch.ops.adamw import UpdateNorms, adamw_update
    from paddle_tpu_torch.ops.grad_norm import grad_sumsq

    for k in _flash_wrappers().values():
        k.launches = 0
    adamw_update.launches = 0
    grad_sumsq.launches = 0
    UpdateNorms.reduces = 0
    _reset_moe_counts()


def _moe_wrappers():
    """{kernel line name: wrapper} of the MoE kernels: D (the dispatch and
    the combine's gradient to the expert outputs), E (the combine and the
    dispatch's gradient to the tokens) and E's weight gradient."""
    from paddle_tpu_torch.ops import moe_dispatch as md

    return {"moe_dispatch": md.dispatch_rows, "moe_combine": md.combine_rows,
            "moe_combine_dw": md.combine_dw}


def _moe_counts():
    return {name: k.launches for name, k in _moe_wrappers().items()}


def _reset_moe_counts():
    for k in _moe_wrappers().values():
        k.launches = 0


def _expected_counts(layers, steps, n_params, path="k1", sep=1,
                     updates=None, dyn_skips=None, forwards=2,
                     moe_layers=0):
    """Exact launches of ``steps`` training steps under recompute "full"
    or "dots": per layer and step two forwards (the forward and its
    recompute) and one backward, through ``path``:
    - "k1": one launch of each K1/K2 entry per forward and backward;
    - "k3" (packed rows): the same on K3's entries;
    - "ring" (context parallel over ``sep`` ranks): per forward, one K6
      launch per kept visit of the causal ring, sep (sep + 1) / 2; per
      backward, K1's delta once per rank and its dK/dV and dQ once per
      kept visit; no K1 forward;
    - "ulysses": each K1 entry once per rank (a rank's heads);
    none of the others; one AdamW update per parameter and update
    (``updates``, default ``steps``: a skipped step updates nothing); one
    gradient-norm launch a step (the non-finite guard's), one more for
    each of ``dyn_skips`` skipped steps under dynamics (the parameters'
    norms), and one dynamics reduction per update under dynamics
    (``dyn_skips`` not None). ``forwards``: 1 for a model whose layers
    skip block recompute (MoE). Each of ``moe_layers`` MoE layers launches
    per step D and E twice (forward, and the other's backward) and E's
    weight gradient once; none elsewhere."""
    visits = sep * (sep + 1) // 2
    k1 = {"flash_attention_fwd": forwards, "flash_attention_bwd_delta": 1,
          "flash_attention_bwd_dkdv": 1, "flash_attention_bwd_dq": 1}
    per = {"k1": k1,
           "k3": {n.replace("attention_", "attention_seg_"): c
                  for n, c in k1.items()},
           "ring": {"flash_attention_ring_fwd": forwards * visits,
                    "flash_attention_bwd_delta": sep,
                    "flash_attention_bwd_dkdv": visits,
                    "flash_attention_bwd_dq": visits},
           "ulysses": {n: c * sep for n, c in k1.items()}}[path]
    want = {name: per.get(name, 0) * layers * steps
            for name in _flash_wrappers()}
    updates = steps if updates is None else updates
    want["adamw_update"] = n_params * updates
    want["grad_sumsq"] = steps + (dyn_skips or 0)
    want["adamw_dynamics_reduce"] = 0 if dyn_skips is None else updates
    want.update({"moe_dispatch": 2 * moe_layers * steps,
                 "moe_combine": 2 * moe_layers * steps,
                 "moe_combine_dw": moe_layers * steps})
    return want


def _packed(model):
    """``model`` behind ``forward(ids, seg)`` -> ``model(ids,
    segment_ids=seg)``: TrainStep hands its batch to the model
    positionally, as the reference's does (paddle_tpu/jit_api.py:606)."""
    from torch import nn

    class Packed(nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, ids, seg):
            return self.model(ids, segment_ids=seg)

    return Packed()


def _trainer(cfg, seed, device="cuda", model=None, packed=False, mesh=None):
    """(model, TrainStep) with AdamW lr 1e-4, decay 0.01; ``packed``: the
    step drives ``_packed(model)`` on (ids, segment ids, labels);
    ``mesh``: a ``DistributedTrainStep`` under it instead. An MoE model
    trains with its ``make_loss_fn`` (the criterion plus the gates' aux
    loss)."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.jit_api import TrainStep
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM, LlamaPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    if model is None:
        model = LlamaForCausalLM(cfg, device=device, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01)
    loss_fn = (model.make_loss_fn() if cfg.num_experts > 1
               else LlamaPretrainingCriterion(cfg))
    if mesh is not None:
        return model, DistributedTrainStep(model, loss_fn, opt, mesh=mesh)
    return model, TrainStep(_packed(model) if packed else model, loss_fn,
                            opt, device=device)


# a gradient element within this many times its row's card-vs-CPU noise
# is indistinguishable from 0; a lone element off by D adds D / sqrt(W)
# to the noise of a row of W >= 4096, so 10x that does not excuse it
NOISE_MULT = 10


def _record_gradients(step):
    """Keep, on the card (the parameter reports run there), the gradients
    ``step`` hands its optimizer, as the update takes them (unscaled and
    clipped where the step gives a scale and a factor,
    ``transform_grad``): one {name: gradient} per update; a skipped step
    records nothing."""
    from paddle_tpu_torch.ops.adamw import transform_grad

    names = {id(p): n for n, p in step.model.named_parameters()}
    record, apply = [], step.optimizer.apply_gradients

    def recording(params_grads, skip_update=False, scale=None, factor=None,
                  **kw):
        params_grads = list(params_grads)
        if not skip_update:
            record.append({names[id(p)]: transform_grad(
                g, scale, factor).detach().to("cuda", copy=True)
                for p, g in params_grads if g is not None})
        return apply(params_grads, skip_update=skip_update, scale=scale,
                     factor=factor, **kw)

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


# the amplified rule's limit: the largest of the ~2e9 draws of a standard
# normal that 667 M elements over at most 3 steps make lies near 6
AMPLIFIED_MULT = 6
PLANTED_UPDATE_LR = 0.5   # the planted update fault: half a step of lr
PLANTED_GRAD_MULT = 9     # the planted gradient fault, in row noise


def _adam_travel(grads, beta1, beta2, eps):
    """How far AdamW's steps m_hat / (sqrt(v_hat) + eps) move elements,
    in units of lr, over the gradients ``grads`` (one tensor per step),
    in f64; the decoupled decay (1e-6 of a weight a step at lr 1e-4 and
    decay 0.01) is left out."""
    m = v = total = 0.0
    for t, g in enumerate(grads, 1):
        g = g.double()
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        total = total + (m / (1 - beta1 ** t)) / (
            (v / (1 - beta2 ** t)).sqrt() + eps)
    return total


def _travel_noise(grads, noise, beta1, beta2, eps):
    """Per element, the standard deviation (lr units) of ``_adam_travel``
    at the gradients ``grads`` when each step's gradient carries its row's
    noise ``noise`` (one tensor per step), propagated to first order:
    sqrt(sum_s (noise_s dT/dg_s)^2), each derivative a central difference
    of 1e-3 of that step's noise."""
    import torch

    var = torch.zeros(grads[0].shape, dtype=torch.float64,
                      device=grads[0].device)
    for s, nz in enumerate(noise):
        h = nz.double() * 1e-3
        moved = [[g.double() + (sign * h if t == s else 0)
                  for t, g in enumerate(grads)] for sign in (1, -1)]
        slope = (_adam_travel(moved[0], beta1, beta2, eps)
                 - _adam_travel(moved[1], beta1, beta2, eps)) / (
                     2 * h).clamp_min(1e-300)
        var += torch.where(nz > 0, nz.double() * slope, 0.0).square()
    return var.sqrt()


def _param_report(gpu_model, cpu_model, rec_gpu, rec_cpu, lr, opt, top=8,
                  amplified=False):
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
    beside their noise.

    ``amplified`` (the S 1024 phases only): an outlier rule (a) leaves is
    also explained ("explained_amplified") when its gap is at most
    AMPLIFIED_MULT times the gap's noise (``_travel_noise``): its row's
    gradient noise carried through AdamW's update at the CPU's gradients.
    Adam divides by sqrt(v_hat) + eps, so an element whose gradient lies a
    few eps from 0, or whose moment half cancels, turns a few times its
    row's noise into a tenth of lr. The card's gradients enter only
    through the row noise. Returns, beside the report, each such
    element's CPU gradients, noise and gap (``_planted_faults``)."""
    import torch

    beta1, beta2, eps = opt._beta1, opt._beta2, opt._epsilon
    per, cand, noise, amp = {}, [], {}, []
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        # the difference (exact in f32 on either device), its median, the
        # outliers and every noise below on the card, beside the recorded
        # gradients: the same elements and counts as on the CPU, where
        # sorting, scanning and the row norms over 667 M elements took
        # some 40 s a phase
        d = (p.detach()
             - cpu_params[name].detach().to(p.device)).abs().flatten()
        median = float(d.median())
        out = (d > 0.1 * lr).nonzero().flatten()
        near = torch.zeros(out.numel(), dtype=torch.bool, device=d.device)
        noise[name] = []
        mg = mc = var_m = torch.zeros(out.numel(), device=d.device)

        def within(a, b, nz):
            return (torch.maximum(a.abs(), b.abs()) <= NOISE_MULT * nz) & (
                (a != 0) | (b != 0))

        nzs = []
        for g, c in zip(rec_gpu, rec_cpu):
            rows, (width,) = _row_noise(g[name], c[name])
            noise[name].append((rows, width))
            go, co = g[name].flatten()[out], c[name].flatten()[out]
            nz = rows[out // width]
            nzs.append(nz)
            mg = beta1 * mg + (1 - beta1) * go
            mc = beta1 * mc + (1 - beta1) * co
            var_m = beta1 ** 2 * var_m + (1 - beta1) ** 2 * nz.square()
            near |= within(go, co, nz) | within(mg, mc, var_m.sqrt())
        per[name] = {"median_lr": median / lr,
                     "max_lr": float(d.max()) / lr,
                     "outliers": int(out.numel()),
                     "explained": int(near.sum())}
        if amplified:
            left = (~near).nonzero().flatten()
            cpu_g = [c[name].flatten()[out[left]] for c in rec_cpu]
            nz_left = [nz[left] for nz in nzs]
            sd = _travel_noise(cpu_g, nz_left, beta1, beta2, eps)
            gap = d[out[left]].double() / lr
            ok = gap <= AMPLIFIED_MULT * sd
            near[left[ok]] = True
            per[name]["explained"] = int(near.sum())
            per[name]["explained_amplified"] = int(ok.sum())
            amp += [{"param": name, "index": int(out[left[j]]),
                     "gap_lr": float(gap[j]), "noise_lr": float(sd[j]),
                     "grads_cpu": [float(g[j]) for g in cpu_g],
                     "row_noise": [float(nz[j]) for nz in nz_left]}
                    for j in ok.nonzero().flatten().tolist()]
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
    return per, worst, amp


def _planted_faults(amp, opt):
    """The witness that the amplified rule has a bound: for each element
    it explained (``_param_report``'s third value), two planted faults it
    must leave unexplained. An update fault: the same gradients and noise,
    the gap PLANTED_UPDATE_LR lr wider (a gap AdamW did not make). A
    gradient fault: the card's gradient PLANTED_GRAD_MULT times the row's
    noise off the CPU's at every step, within the 10x a "no lone outlier"
    bound would excuse, the gap AdamW makes of it (f64), in the direction
    that moves the parameter further (away from 0, Adam's update saturates
    at one lr a step and the gap stays as small as noise makes it; the
    gradient check is that fault's witness). Returns one row per
    element."""
    import torch

    beta1, beta2, eps = opt._beta1, opt._beta2, opt._epsilon
    rows = []
    for e in amp:
        cpu_g = [torch.tensor([g], dtype=torch.float64)
                 for g in e["grads_cpu"]]
        nz = [torch.tensor([n], dtype=torch.float64) for n in e["row_noise"]]
        base = float(_adam_travel(cpu_g, beta1, beta2, eps))
        grad_gap = max(abs(float(_adam_travel(
            [g + sign * PLANTED_GRAD_MULT * n for g, n in zip(cpu_g, nz)],
            beta1, beta2, eps)) - base) for sign in (1, -1))
        limit = AMPLIFIED_MULT * e["noise_lr"]
        update_gap = e["gap_lr"] + PLANTED_UPDATE_LR
        rows.append({"param": e["param"], "index": e["index"],
                     "limit_lr": limit, "update_fault_gap_lr": update_gap,
                     "gradient_fault_gap_lr": grad_gap,
                     "caught": update_gap > limit and grad_gap > limit})
    return rows


def _train_equal(phase, seed, batches, packed=False, rel_tol=1e-4,
                 grad_tol=1e-4, outlier_share=1e-5, context_parallel=False,
                 sep=1, oracle_tol=1e-5, amplified=False, cfg=None):
    """f32, LLaMA-2-7B widths, 1 layer, fused CE, recompute "full": one
    TrainStep per batch on the card (kernels) and on the CPU (plain
    versions) from the same weights, every gradient handed to the optimizer
    kept (``packed``: batches of ids, segment ids and labels through
    ``_packed``). Held (f32: the two differ in summation order only): the
    losses within ``rel_tol`` relative; every parameter's gradient at every
    step within ``grad_tol`` in relative norm (Adam hides a wrong
    gradient's size, so this is the backward's witness); the parameters in
    units of lr: at most ``outlier_share`` of the elements more than 0.1 lr
    apart, each explained by a gradient or a first moment within noise of
    zero (``_param_report``); and the exact kernel launches on the card.
    ``context_parallel`` (True or "ulysses"): both steps are
    ``DistributedTrainStep``s under a sep-``sep`` mesh over one device (the
    CPU's, the card's), and the reference's oracle
    (tests/test_context_parallel.py:34-57) holds on the card: the first
    step's loss equals the same model's loss with no mesh (K1) within
    ``oracle_tol`` relative. ``amplified``: ``_param_report``'s
    amplified rule explains outliers too, the count rule (a) alone leaves
    is reported beside, and every planted fault (``_planted_faults``) must
    stay unexplained. ``cfg``: another 2-layer f32 config; an MoE one
    (``phase_moe_equal``) runs no block recompute, and its routing is held
    too: every layer's slots identical card vs CPU at every step, the aux
    loss within ``MOE_AUX_TOL`` relative. Returns the row and the card's
    model."""
    import torch

    from paddle_tpu_torch.distributed import build_mesh
    from paddle_tpu_torch.models.llama import llama2_7b

    if cfg is None:
        cfg = llama2_7b(use_recompute=True, recompute_policy="full",
                        fuse_linear_cross_entropy=True,
                        context_parallel=context_parallel)
        cfg.num_hidden_layers = 2
    moe = cfg.num_experts > 1
    meshes = {d: build_mesh(sep=sep, devices=[d] * sep)
              if context_parallel else None for d in ("cpu", "cuda:0")}
    cpu_model, cpu_step = _trainer(cfg, seed, device="cpu", packed=packed,
                                   mesh=meshes["cpu"])
    gpu_model, gpu_step = _trainer(cfg, seed, packed=packed,
                                   model=copy.deepcopy(cpu_model).to("cuda"),
                                   mesh=meshes["cuda:0"])
    routes = {d: _record_routing(m) for d, m in (("cuda", gpu_model),
                                                 ("cpu", cpu_model))} \
        if moe else None
    oracle = {}
    if context_parallel:
        ids, labels = (torch.from_numpy(b).to("cuda") for b in batches[0])
        with torch.no_grad():
            oracle["no_mesh_loss"] = float(gpu_model.eval()(
                ids, labels=labels))
    rec_gpu, rec_cpu = _record_gradients(gpu_step), _record_gradients(cpu_step)
    _reset_flash_counts()
    t0 = time.perf_counter()
    gpu = [float(gpu_step(*b)) for b in batches]
    counts = _flash_counts()
    t_gpu = time.perf_counter() - t0
    cpu = [float(cpu_step(*b)) for b in batches]
    t_cpu = time.perf_counter() - t0 - t_gpu
    path = ("k3" if packed else "ulysses" if context_parallel == "ulysses"
            else "ring" if context_parallel else "k1")
    L = cfg.num_hidden_layers
    want = _expected_counts(L, len(batches), len(list(
        cpu_model.parameters())), path, sep, forwards=1 if moe else 2,
        moe_layers=L if moe else 0)
    routing = _routing_report(routes) if moe else None
    if context_parallel:
        oracle["cp_loss"] = gpu[0]
        oracle["rel"] = (abs(gpu[0] - oracle["no_mesh_loss"])
                         / abs(oracle["no_mesh_loss"]))
        oracle["tol"] = oracle_tol
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu, cpu)]
    grad_rel = _grad_report(rec_gpu, rec_cpu)
    worst_grad = max(((r, k, n) for k, step in enumerate(grad_rel, 1)
                      for n, r in step.items()))
    by_step = [{"worst": max((r, n) for n, r in step.items())[::-1],
                "median": statistics.median(step.values())}
               for step in grad_rel]
    lr = gpu_step.optimizer.get_lr()
    with torch.no_grad():
        per, worst, amp = _param_report(
            gpu_step.model, cpu_step.model, rec_gpu, rec_cpu, lr,
            gpu_step.optimizer, amplified=amplified)
    planted = _planted_faults(amp, gpu_step.optimizer)
    n_el = sum(p.numel() for p in cpu_model.parameters())
    outliers = sum(r["outliers"] for r in per.values())
    unexplained = outliers - sum(r["explained"] for r in per.values())
    row = {"phase": phase, "layers": L, "dtype": "float32",
           "B": batches[0][0].shape[0], "S": batches[0][0].shape[1],
           "context_parallel": context_parallel, "sep": sep,
           "oracle": oracle or None,
           "losses_gpu": gpu, "losses_cpu": cpu, "rel_err": rel,
           "rel_tol": rel_tol,
           "grad_rel_worst": {"rel": worst_grad[0], "step": worst_grad[1],
                              "param": worst_grad[2]},
           "grad_rel_by_step": by_step,
           "grad_tol": grad_tol, "lr": lr, "elements": n_el,
           "param_outliers": outliers, "param_unexplained": unexplained,
           "amplified_rule": amplified,
           "param_unexplained_by_rule_a": unexplained + len(amp),
           "param_explained_amplified": amp, "planted_faults": planted,
           "outlier_share_limit": outlier_share,
           "param_median_diff_lr_max": max(r["median_lr"]
                                           for r in per.values()),
           "param_diff": per, "param_diff_worst": worst, "kernels": counts,
           "expected_kernels": want, "gpu_s": t_gpu, "cpu_s": t_cpu,
           "routing": routing}
    emit(row)
    if routing is not None and not routing["ok"]:
        raise AssertionError(f"{phase}: card and CPU route differently: "
                             f"{routing}")
    if max(rel) > rel_tol:
        raise AssertionError(f"card and CPU losses differ: {gpu} vs {cpu}")
    if worst_grad[0] > grad_tol:
        raise AssertionError(f"card and CPU gradients differ: {worst_grad}")
    if outliers > outlier_share * n_el or unexplained:
        raise AssertionError(
            f"card and CPU parameters differ: {outliers} elements past "
            f"0.1 lr ({unexplained} with no gradient or moment within "
            "noise of 0)")
    if not all(f["caught"] for f in planted):
        raise AssertionError(f"{phase}: the amplified rule explains a "
                             f"planted fault: {planted}")
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, expected {want}")
    if oracle and oracle["rel"] > oracle_tol:
        raise AssertionError(f"{phase}: the context-parallel loss differs "
                             f"from the no-mesh loss: {oracle}")
    del gpu_step, rec_gpu, rec_cpu, cpu_model, cpu_step
    return row, gpu_model


def phase_train_equal(seed=4, steps=2):
    """``_train_equal`` on B 1, S 256 of seeded uniform tokens."""
    import torch

    from paddle_tpu_torch.models.llama import llama2_7b

    ids = _tokens(seed, llama2_7b().vocab_size, (steps, 1, 257))
    _, model = _train_equal("train_equal", seed,
                            [(i[:, :-1], i[:, 1:]) for i in ids])
    del model
    gc.collect()
    torch.cuda.empty_cache()


def cut_rows(seed, B, S, n_segments=(3, 5)):
    """Segment ids [B, S] (int32) of rows cut at seeded points into 3-5
    segments each, and each row's segment lengths."""
    import numpy as np

    rng = np.random.RandomState(seed)
    rows, convs = [], []
    for _ in range(B):
        n = rng.randint(n_segments[0], n_segments[1] + 1)
        cuts = np.sort(rng.choice(np.arange(1, S), n - 1, replace=False))
        lens = np.diff(np.concatenate([[0], cuts, [S]])).tolist()
        rows.append(np.concatenate([np.full(m, i, np.int32)
                                    for i, m in enumerate(lens)]))
        convs.append(lens)
    return np.stack(rows), convs


def phase_train_packed_equal(seed=10, steps=2, logit_tol=1e-4):
    """``_train_equal`` on packed rows: B 1, S 256 cut into 3-5 segments
    (``cut_rows``, a new cut and new tokens each step), labels -100 at each
    segment's end. Then the reference's oracle (tests/test_packed_training
    .py:20-40) on the card: each segment's logits from the packed row (K3)
    equal that segment's standalone forward (K1), the largest difference
    within ``logit_tol`` of the largest logit."""
    import torch

    from paddle_tpu_torch.models.llama import llama2_7b

    vocab = llama2_7b().vocab_size
    batches = []
    for i in range(steps):
        seg, convs = cut_rows(seed + i, 1, 256)
        ids = _tokens(seed + i, vocab, (1, 256))
        batches.append((ids, seg, sft_labels(ids, seg, convs)))
    row, model = _train_equal("train_packed_equal", seed, batches,
                              packed=True)
    model.eval()
    seg, _ = cut_rows(seed + steps, 1, 256)
    ids = torch.from_numpy(_tokens(seed + steps, vocab, (1, 256))).cuda()
    seg_t = torch.from_numpy(seg).cuda()
    errs = []
    with torch.no_grad():
        packed = model(ids, segment_ids=seg_t)[0]
        for s in torch.unique(seg_t[0]):
            sl = seg_t[0] == s
            alone = model(ids[:, sl])[0]
            errs.append(float((packed[sl] - alone).abs().max()
                              / alone.abs().max()))
    oracle = {"phase": "train_packed_equal_oracle",
              "segment_lengths": [int(n) for n in torch.unique(
                  seg_t[0], return_counts=True)[1]],
              "max_diff_over_max_logit": errs, "tol": logit_tol}
    emit(oracle)
    if max(errs) > logit_tol:
        raise AssertionError(f"packed logits differ from the standalone "
                             f"segments': {errs}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _tokens(seed, vocab, shape):
    """Token ids drawn uniformly by seed, as bench.py draws its batches."""
    import numpy as np

    return np.random.RandomState(seed).randint(
        0, vocab, shape).astype(np.int32)


def _timed_steps(phase, cfg, model, step, batches, warmup, path="k1", sep=1,
                 packing=None, extra=None, check_trend=True, dyn_skips=None,
                 on_timed=None):
    """``warmup`` steps, then one timed step per remaining batch with the
    kernels' counts taken over the timed steps alone (``_expected_counts``
    exactly). MFU is ``flops_per_token(cfg, S)`` (the reference's, full
    causal rows) x tokens/s / 989e12. ``packing`` (packed rows): the
    conversations' ``tokens`` of a batch and their visible (query, key)
    ``pairs`` per head are the work, so tokens/s and MFU count those alone
    (the attention term from those pairs), not the padding tail; the same
    over every token and every segment's pairs
    (``pairs_with_padding``) is kept beside, named as counting padding.
    ``check_trend``: the loss must not rise over the steps. ``dyn_skips``:
    ``_expected_counts``'s, for a step under dynamics. An MoE config
    (no block recompute) expects one forward a layer and the MoE
    kernels' launches; ``on_timed`` is called once the warm-up is done."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    losses = [step(*b) for b in batches[:warmup]]
    torch.cuda.synchronize()
    if on_timed is not None:
        on_timed()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    t0 = time.perf_counter()
    losses += [step(*b) for b in batches[warmup:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()
    losses = [float(x) for x in losses]
    steps = len(batches) - warmup
    B, S = batches[0][0].shape
    tok_s = B * S * steps / wall
    L = cfg.num_hidden_layers
    flops = LlamaForCausalLM.flops_per_token(cfg, seq_len=S)
    moe = cfg.num_experts > 1
    want = _expected_counts(L, steps, len(list(model.parameters())), path,
                            sep, dyn_skips=dyn_skips,
                            forwards=1 if moe else 2,
                            moe_layers=L if moe else 0)
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
           "kernels": counts, "expected_kernels": want, **(extra or {})}
    if packing is not None:
        def packed_flops(pairs, tokens):
            return (LlamaForCausalLM.flops_per_token(cfg)
                    + 12 * L * cfg.hidden_size * pairs / tokens)

        work_tok_s = packing["tokens"] * steps / wall
        work_flops = packed_flops(packing["pairs"], packing["tokens"])
        pad_flops = packed_flops(packing["pairs_with_padding"], B * S)
        row.update(work_tokens_per_batch=packing["tokens"],
                   tokens_per_s=work_tok_s,
                   flops_per_token_packed=work_flops,
                   flops_formula="6 N + 12 L hidden (visible pairs per "
                                 "head / tokens), conversations only",
                   mfu=work_flops * work_tok_s / 989e12,
                   tokens_per_s_with_padding=tok_s,
                   mfu_with_padding=pad_flops * tok_s / 989e12,
                   mfu_if_full_causal_rows_with_padding=(
                       flops * tok_s / 989e12))
    emit(row)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, expected {want}")
    if check_trend:
        # uniform tokens hold the loss near its floor ln(vocab) at this lr,
        # so "not rising" is read against the step-to-step spread
        half = len(losses) // 2
        if np.mean(losses[half:]) > np.mean(losses[:half]) + np.std(losses):
            raise AssertionError(f"{phase}: loss rose {losses}")
    return row


def _token_batches(seed, vocab, n, B, S):
    """n batches of (ids, next-token labels) of seeded uniform tokens."""
    ids = _tokens(seed, vocab, (n, B, S + 1))
    return [(i[:, :-1], i[:, 1:]) for i in ids]


def phase_train(seed=0):
    """The slice: LLaMA-2-7B at full width and depth, bf16, as bench.py
    configures it (recompute "full", fused linear CE, AdamW lr 1e-4 and
    weight decay 0.01); B 2, S 2048, 2 warm-up and 8 timed steps.
    Returns the row, the model, its step and its batches."""
    from paddle_tpu_torch.models.llama import llama2_7b

    cfg = llama2_7b(dtype="bfloat16", use_recompute=True,
                    recompute_policy="full", fuse_linear_cross_entropy=True)
    model, step = _trainer(cfg, seed)
    batches = _token_batches(seed, cfg.vocab_size, 10, 2, 2048)
    row = _timed_steps("train", cfg, model, step, batches, warmup=2)
    return row, model, step, batches


CP_SEP = 4          # the context-parallel phases' sep ring (one card)
CP_SEQ = 4096       # train_cp's sequence: LLaMA-2's context


def _cp_equal_batches(seed, steps, S):
    """train_cp_equal's batches: B 1 x S of seeded uniform tokens."""
    from paddle_tpu_torch.models.llama import llama2_7b

    ids = _tokens(seed, llama2_7b().vocab_size, (steps, 1, S + 1))
    return [(i[:, :-1], i[:, 1:]) for i in ids]


def phase_train_equal_s1024(seed=13, steps=2, S=1024):
    """The witness of the amplified rule: ``_train_equal`` on K1's path
    (no mesh) at train_cp_equal's size, seed and tokens, B 1 x S 1024.
    Rule (a) alone, set at S 256, leaves outliers unexplained here on K1's
    unchanged path too; the row reports them beside what the amplified
    rule explains and the planted faults it must catch."""
    import torch

    _, model = _train_equal("train_equal_s1024", seed,
                            _cp_equal_batches(seed, steps, S),
                            amplified=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_cp_equal(seed=13, steps=2, S=1024):
    """``_train_equal`` under context parallelism: B 1 x S 1024 of seeded
    uniform tokens, sep 4 (S_local 256), the ring and then Ulysses, each
    with the no-mesh oracle on the card and the amplified rule, as
    `train_equal_s1024` holds K1 at this size."""
    import torch

    batches = _cp_equal_batches(seed, steps, S)
    for cp in (True, "ulysses"):
        _, model = _train_equal("train_cp_equal", seed, batches,
                                context_parallel=cp, sep=CP_SEP,
                                amplified=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def phase_train_cp(model, step, train_row, seed=14, warmup=2, timed=5):
    """Context-parallel training on `train`'s model and AdamW, continued
    (LLaMA-2-7B bf16, 32 layers, recompute "full", fused linear CE; the
    config's ``context_parallel`` set for this phase and cleared before
    the no-mesh run): B 2 x S 4096 of seeded uniform
    tokens through ``DistributedTrainStep`` under ``build_mesh(sep=4,
    devices=["cuda:0"] * 4)``, 2 warm-up and 5 timed steps, the ring's
    exact launch counts (K6 per kept visit, K1's backward entries, no K1
    forward). Then the same model with no mesh through ``TrainStep`` (K1
    over the whole sequence), the same shapes and step counts. Step ms,
    tokens/s, MFU (``flops_per_token(cfg, 4096)``) and peak memory of both;
    two more steps of each under torch.profiler. Returns the row (the
    no-mesh run's under "no_mesh")."""
    from paddle_tpu_torch.distributed import DistributedTrainStep, build_mesh
    from paddle_tpu_torch.jit_api import TrainStep

    cfg = model.config
    cfg.context_parallel = True
    n = warmup + timed
    mesh = build_mesh(sep=CP_SEP, devices=["cuda:0"] * CP_SEP)
    cstep = DistributedTrainStep(model, step.loss_fn, step.optimizer,
                                 mesh=mesh)
    batches = _token_batches(seed, cfg.vocab_size, n, 2, CP_SEQ)
    row = _timed_steps(
        "train_cp", cfg, model, cstep, batches, warmup=warmup, path="ring",
        sep=CP_SEP,
        extra={"context_parallel": cfg.context_parallel, "sep": CP_SEP,
               "s_local": CP_SEQ // CP_SEP,
               "train_step_ms_s2048": train_row["step_ms"]})

    def two_steps():
        for b in batches[:2]:
            cstep(*b)

    row["profile"] = _device_profile("train_cp_profile", two_steps)
    cfg.context_parallel = False
    nstep = TrainStep(model, step.loss_fn, step.optimizer, device="cuda")
    plain_batches = _token_batches(seed + 1, cfg.vocab_size, n, 2, CP_SEQ)
    plain = _timed_steps(
        "train_cp_no_mesh", cfg, model, nstep, plain_batches,
        warmup=warmup, extra={"train_cp_step_ms": row["step_ms"]})

    def two_plain_steps():
        for b in plain_batches[:2]:
            nstep(*b)

    # the same two-step window with no mesh: K1 over the whole sequence,
    # against which the ring profile's K6, f32 sums and shard copies read
    row["no_mesh_profile"] = _device_profile("train_cp_no_mesh_profile",
                                             two_plain_steps)
    row["no_mesh"] = {k: plain[k] for k in ("step_ms", "tokens_per_s", "mfu",
                                            "peak_mem_gb")}
    if max(row["peak_mem_gb"], plain["peak_mem_gb"]) >= 80:
        raise AssertionError(f"train_cp: peak memory {row['peak_mem_gb']} "
                             f"/ {plain['peak_mem_gb']} GB")
    return row


PACKING_SEED = 9   # k3's and train_packed's packed rows


def phase_train_packed(model, step, train_row, seed=11):
    """SFT packing on `train`'s model and optimizer (LLaMA-2-7B bf16, 32
    layers, recompute "full", fused linear CE, AdamW lr 1e-4), continued
    after `train`: B 2 x S 2048 of k3's packed rows (``sft_rows``,
    conversations of 64-1024 tokens, a padding tail with its own id), new
    seeded tokens each step, labels -100 at each segment's last token and
    on the padding; 2 warm-up and 8 timed steps, K3's exact launch counts
    and none of K1's; tokens/s and MFU over the conversations' tokens and
    pairs (the padding tail is no work; the figures counting it beside);
    `train`'s step ms beside. Then two steps under torch.profiler. Returns
    the row."""
    import numpy as np

    from paddle_tpu_torch.jit_api import TrainStep

    seg, convs = sft_rows(PACKING_SEED, 2, 2048)
    ids = _tokens(seed, model.config.vocab_size, (10, 2, 2048))
    batches = [(i, seg, sft_labels(i, seg, convs)) for i in ids]
    lens = [np.unique(r, return_counts=True)[1] for r in seg]
    pairs = int(sum((n * (n + 1) // 2).sum() for n in lens))
    # the work: the conversations' tokens and pairs, not the padding tail
    work = {"tokens": sum(sum(c) for c in convs),
            "pairs": sum(n * (n + 1) // 2 for c in convs for n in c),
            "pairs_with_padding": pairs}
    # train's loss and AdamW (its moments carry on) over the packed model
    pstep = TrainStep(_packed(model), step.loss_fn, step.optimizer,
                      device="cuda")
    packing = {"conversation_lengths": list(SFT_LENGTHS),
               "segments_per_row": [len(n) for n in lens],
               "padding_tokens": [2048 - sum(c) for c in convs],
               "visible_pairs_per_head": pairs,
               "visible_share_of_causal": pairs / (2 * 2048 * 2049 // 2)}
    row = _timed_steps("train_packed", model.config, model, pstep, batches,
                       warmup=2, path="k3", packing=work,
                       extra={"packing": packing,
                              "train_step_ms": train_row["step_ms"]})

    def two_steps():
        for b in batches[:2]:
            pstep(*b)

    row["profile"] = _device_profile("train_packed_profile", two_steps)
    return row


RECIPE_PEAK_LR = 3e-4    # LLaMA 2's 7B peak lr (Touvron et al. 2023, 2.2)
RECIPE_CLIP = 1.0
OVERFLOW = 2.0 ** 127    # multiplies a loss past f32's range (see below)


def _no_norm_decay(name):
    """LLaMA 2's decay spares the norms' weights."""
    return "norm" not in name


def _recipe_optimizer(model, peak_lr=RECIPE_PEAK_LR, warmup=2000,
                      total=100000, clip=RECIPE_CLIP, master=True):
    """LLaMA 2's recipe (Touvron et al. 2023, section 2.2): AdamW beta2
    0.95, eps 1e-5, weight decay 0.1 off the norms, gradients clipped at
    global norm ``clip``, ``warmup`` linear warm-up steps then a cosine
    decay to 10% of the peak over ``total``; f32 master weights."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(peak_lr, T_max=total, eta_min=peak_lr / 10),
        warmup_steps=warmup, start_lr=0.0, end_lr=peak_lr)
    return AdamW(learning_rate=sched, beta2=0.95, epsilon=1e-5,
                 weight_decay=0.1, apply_decay_param_fun=_no_norm_decay,
                 parameters=model.named_parameters(),
                 grad_clip=ClipGradByGlobalNorm(clip), multi_precision=master)


def _overflowing_loss(cfg):
    """The criterion times the batch's last array, one f32: 1 on a normal
    step, OVERFLOW on the step that must overflow. The loss scaler's point
    is fp16's range; f32 and bf16 share f32's, where the largest gradient
    of this model is about 1e-2 of the loss scale, so no finite scale
    overflows them. A loss multiplied by 2^127 does, scale or no scale:
    the loss becomes inf and every gradient inf or NaN, on both tiers
    alike."""
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    crit = LlamaPretrainingCriterion(cfg)

    def loss_fn(h, w, labels, mult):
        return crit(h, w, labels) * mult.reshape(())

    return loss_fn


def _close(name, got, want, rel):
    """Lists of numbers (or lists of lists) equal where non-finite and
    within ``rel`` relative elsewhere; returns the largest relative
    error."""
    import numpy as np

    g, w = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                         dtype=np.float64)
    if g.shape != w.shape or not np.array_equal(np.isnan(g), np.isnan(w)) \
            or not np.array_equal(np.isinf(g), np.isinf(w)):
        raise AssertionError(f"{name}: {got} vs {want}")
    ok = np.isfinite(w)
    err = np.abs(g[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-30)
    worst = float(err.max()) if err.size else 0.0
    if worst > rel:
        raise AssertionError(f"{name}: apart by {worst} (limit {rel}): "
                             f"{got} vs {want}")
    return worst


def phase_train_recipe_equal(seed=16, steps=4, S=256):
    """The training recipe, card against CPU: f32, LLaMA-2-7B widths, 2
    layers, recompute "full", fused CE, B 1 x S 256, 4 TrainSteps from
    the same weights and batches: LLaMA 2's AdamW (beta2 0.95, eps 1e-5,
    decay 0.1 off the norms), LinearWarmup(CosineAnnealingDecay) with 2
    warm-up steps, ClipGradByGlobalNorm at 1e-3 (below every step's norm,
    so that it clips), f32 master weights off (f32 parameters), a
    dynamic GradScaler (2^15, halved after one bad step, doubled after two
    good ones) whose first step overflows (``_overflowing_loss``), and
    PADDLE_DYNAMICS=1 spilling every step. Held: the losses (steps 2-4),
    gradients and parameters to train_equal's limits with rule (a); the
    lr sequence, the skip pattern and the scale sequence identical; the
    clip factor within 1e-5; the dynamics spills' grad_sq and upd_sq per
    group within 1e-4 relative; exact launches: K1, kernel A once a step
    and once more on the skipped step (the parameters' norms), kernel B
    once per parameter of each update, one dynamics reduction an
    update."""
    import os

    import numpy as np
    import torch

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit_api import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

    os.environ["PADDLE_DYNAMICS"] = "1"
    os.environ["PADDLE_DYNAMICS_EVERY_STEPS"] = "1"
    cfg = llama2_7b(use_recompute=True, recompute_policy="full",
                    fuse_linear_cross_entropy=True)
    cfg.num_hidden_layers = 2
    ids = _tokens(seed, cfg.vocab_size, (steps, 1, S + 1))
    mult = [np.array([OVERFLOW if i == 0 else 1.0], np.float32)
            for i in range(steps)]
    batches = [(i[:, :-1], i[:, 1:], m) for i, m in zip(ids, mult)]
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    runs = {}
    for tier, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        opt = _recipe_optimizer(model, peak_lr=1e-4, warmup=2, total=10,
                                clip=1e-3, master=False)
        scaler = GradScaler(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
                            decr_every_n_nan_or_inf=1)
        step = TrainStep(model, _overflowing_loss(cfg), opt, n_labels=2,
                         scaler=scaler, device=tier)
        rec = _record_gradients(step)
        if tier == "cuda":
            _reset_flash_counts()
        out = {"losses": [], "lr": [], "skipped": [], "scale": [],
               "factor": [], "grad_sq": [], "upd_sq": [], "rec": rec,
               "step": step, "t0": time.perf_counter()}
        for b in batches:
            out["lr"].append(opt.get_lr())
            out["losses"].append(float(step(*b)))
            out["skipped"].append(step.last_skipped)
            out["scale"].append(float(step._scaler_state["scale"]))
            out["factor"].append(float(step.last_stats.factor))
            out["grad_sq"].append(step._dynamics.last["grad_sq"])
            out["upd_sq"].append(step._dynamics.last["upd_sq"])
        if tier == "cuda":
            torch.cuda.synchronize()
            out["kernels"] = _flash_counts()
        out["s"] = time.perf_counter() - out["t0"]
        runs[tier] = out
    del os.environ["PADDLE_DYNAMICS"], os.environ["PADDLE_DYNAMICS_EVERY_STEPS"]
    g, c = runs["cuda"], runs["cpu"]
    n_params = len(list(cpu_model.parameters()))
    want = _expected_counts(2, steps, n_params, updates=steps - 1,
                            dyn_skips=1)
    rel = [abs(a - b) / abs(b) for a, b in zip(g["losses"][1:],
                                              c["losses"][1:])]
    grad_rel = _grad_report(g["rec"], c["rec"])
    worst_grad = max(((r, k, n) for k, st in enumerate(grad_rel, 2)
                      for n, r in st.items()))
    peak = max(c["lr"])
    with torch.no_grad():
        per, worst, _ = _param_report(gpu_model, cpu_model, g["rec"],
                                      c["rec"], peak, g["step"].optimizer)
    n_el = sum(p.numel() for p in cpu_model.parameters())
    outliers = sum(r["outliers"] for r in per.values())
    unexplained = outliers - sum(r["explained"] for r in per.values())
    row = {"phase": "train_recipe_equal", "layers": 2, "dtype": "float32",
           "B": 1, "S": S, "losses_gpu": g["losses"], "losses_cpu": c["losses"],
           "rel_err": rel, "lr": g["lr"], "skipped": g["skipped"],
           "scale": g["scale"], "factor_gpu": g["factor"],
           "factor_cpu": c["factor"],
           "grad_rel_worst": {"rel": worst_grad[0], "step": worst_grad[1],
                              "param": worst_grad[2]},
           "param_outliers": outliers, "param_unexplained": unexplained,
           "elements": n_el, "param_diff_worst": worst[:4],
           "kernels": g["kernels"], "expected_kernels": want,
           "gpu_s": g["s"], "cpu_s": c["s"]}
    try:
        if not all(np.isinf(x) or np.isnan(x)
                   for x in (g["losses"][0], c["losses"][0])):
            raise AssertionError(f"the first step did not overflow: "
                                 f"{g['losses'][0]}, {c['losses'][0]}")
        if g["skipped"] != c["skipped"] or g["skipped"] != [True] + [
                False] * (steps - 1):
            raise AssertionError(f"skips {g['skipped']} vs {c['skipped']}")
        if g["lr"] != c["lr"] or g["scale"] != c["scale"]:
            raise AssertionError(f"lr {g['lr']} vs {c['lr']}, scale "
                                 f"{g['scale']} vs {c['scale']}")
        if not max(g["scale"][:1]) < 2.0 ** 15:
            raise AssertionError(f"the scale did not fall: {g['scale']}")
        row["factor_rel_err"] = _close("clip factor", g["factor"][1:],
                                       c["factor"][1:], 1e-5)
        if not max(g["factor"][1:]) < 1.0:
            raise AssertionError(f"the clip did not clip: {g['factor']}")
        row["grad_sq_rel_err"] = _close("dynamics grad_sq", g["grad_sq"],
                                        c["grad_sq"], 1e-4)
        row["upd_sq_rel_err"] = _close("dynamics upd_sq", g["upd_sq"],
                                       c["upd_sq"], 1e-4)
        if max(rel) > 1e-4:
            raise AssertionError(f"losses differ: {g['losses']} vs "
                                 f"{c['losses']}")
        if worst_grad[0] > 1e-4:
            raise AssertionError(f"gradients differ: {worst_grad}")
        if outliers > 1e-5 * n_el or unexplained:
            raise AssertionError(f"parameters differ: {outliers} past 0.1 "
                                 f"lr, {unexplained} unexplained")
        if g["kernels"] != want:
            raise AssertionError(f"launches {g['kernels']}, expected {want}")
    finally:
        emit(row)
    del runs, g, c, gpu_model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return row


RECIPE_LAYERS = 16   # depth cut: 16 bytes a parameter at 32 layers = 108 GB


def phase_train_recipe(seed=17, warmup=2, timed=5):
    """LLaMA-2-7B widths, bf16, recompute "full", fused CE, B 2 x S 2048,
    depth cut from 32 to RECIPE_LAYERS layers (master weights, f32 moments
    and bf16 gradients take 16 bytes a parameter: 108 GB at 32 layers),
    first on `train`'s plain recipe (AdamW lr 1e-4 constant, decay 0.01,
    no clip, bf16 moments), then, that optimizer freed, on LLaMA 2's recipe
    (``_recipe_optimizer``: warm-up then cosine, clip 1.0, beta2 0.95,
    f32 master weights) with StepMetricsBus(peak_flops=989e12) and
    PADDLE_DYNAMICS=1 as bench.py sets them; 2 warm-up and 5 timed steps
    each. Step ms, tokens/s, MFU (the bus's beside chip_smoke's), peak
    memory (under 80 GB), exact launches (K1; kernel A once a
    step; kernel B once per parameter a step; one dynamics reduction a
    step), and one forced dynamics spill after the timed steps. The bus
    times the host's window between its on_step calls, chip_smoke the
    device's between two synchronisations, so the two MFUs agree within
    5%, not exactly."""
    import os

    import torch

    from paddle_tpu_torch.jit_api import TrainStep
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM, LlamaPretrainingCriterion, llama2_7b,
    )
    from paddle_tpu_torch.utils.metrics_bus import StepMetricsBus

    cfg = llama2_7b(dtype="bfloat16", use_recompute=True,
                    recompute_policy="full", fuse_linear_cross_entropy=True)
    cfg.num_hidden_layers = RECIPE_LAYERS
    model, step = _trainer(cfg, seed)
    batches = _token_batches(seed, cfg.vocab_size, warmup + timed, 2, 2048)
    plain = _timed_steps("train_recipe_plain", cfg, model, step, batches,
                         warmup=warmup, check_trend=False)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["PADDLE_DYNAMICS"] = "1"
    flops = LlamaForCausalLM.flops_per_token(
        cfg, seq_len=batches[0][0].shape[1])
    bus = StepMetricsBus(tokens_per_step=batches[0][0].size,
                         flops_per_token=flops,
                         peak_flops=989e12, log_every=timed,
                         skip_first=warmup)
    records = []
    bus.subscribe(records.append)
    step = TrainStep(model, LlamaPretrainingCriterion(cfg),
                     _recipe_optimizer(model), metrics_bus=bus)
    del os.environ["PADDLE_DYNAMICS"]
    # batches the model has not seen: one AdamW step at 3.5 B parameters
    # all but learns a batch of uniform tokens, so a batch seen again
    # reads a loss far below ln(vocab)
    batches = _token_batches(seed + 1, cfg.vocab_size, warmup + timed, 2,
                             2048)
    row = _timed_steps("train_recipe", cfg, model, step, batches,
                       warmup=warmup, check_trend=False, dyn_skips=0,
                       extra={"recipe": "LLaMA 2: AdamW beta2 0.95, eps "
                                        "1e-5, decay 0.1 off the norms, "
                                        "clip 1.0, 2000 warm-up steps then "
                                        "cosine to 10%, f32 master weights",
                              "depth_cut": f"32 -> {RECIPE_LAYERS} layers"})
    spill = step._dynamics.spill(step._dyn_state, step=step._calls)
    row.update(bus=records[-1] if records else None,
               bus_summary=bus.summary(), plain_step_ms=plain["step_ms"],
               plain_peak_mem_gb=plain["peak_mem_gb"],
               recipe_minus_plain_ms=row["step_ms"] - plain["step_ms"],
               dynamics_grad_norm=spill["grad_norm"],
               lr_last=step.optimizer.get_lr(),
               clip_factor_last=float(step.last_stats.factor))
    emit(row)
    bus_mfu = row["bus_summary"].get("mfu", 0.0)
    if not records or abs(bus_mfu - row["mfu"]) > 0.05 * row["mfu"]:
        raise AssertionError(f"the bus's MFU {bus_mfu} is not chip_smoke's "
                             f"{row['mfu']}")
    if row["peak_mem_gb"] >= 80:
        raise AssertionError(f"train_recipe peak {row['peak_mem_gb']} GB")
    del model, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return row, plain


def phase_train_gqa(seed=5):
    """llama2_70b widths (hidden 8192, Hq 64 / Hkv 8, intermediate 28672)
    at 2 layers, bf16, recompute "dots"; B 1, S 2048, 1 warm-up and 3
    timed steps."""
    import torch

    from paddle_tpu_torch.models.llama import llama2_70b

    cfg = llama2_70b(dtype="bfloat16", use_recompute=True,
                     recompute_policy="dots", fuse_linear_cross_entropy=True)
    cfg.num_hidden_layers = 2   # depth cut: 80 layers do not fit one card
    model, step = _trainer(cfg, seed)
    row = _timed_steps("train_gqa", cfg, model, step,
                       _token_batches(seed, cfg.vocab_size, 4, 1, 2048),
                       warmup=1, check_trend=False)
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
    # the profiler's raw device events: building its event tree
    # (prof.events()) takes minutes for a serve's tens of thousands of
    # kernels, and the tree is not needed here
    cuda = torch.autograd.DeviceType.CUDA
    spans, by_name = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        start, dur = ev.start_ns(), ev.duration_ns()
        spans.append((start, start + dur))
        name = ev.name()
        by_name[name] = by_name.get(name, 0) + dur
    by_family, other = {}, {}
    for name, dur in by_name.items():   # a serve launches ~100 kernels
        fam = _family(name)
        by_family[fam] = by_family.get(fam, 0.0) + dur / 1e9
        if fam == "other":
            other[name[:96]] = other.get(name[:96], 0.0) + dur / 1e9
    busy, end = 0.0, None
    for s, e in sorted(spans):   # union of the kernels' intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy /= 1e9
    row = {"phase": phase, "wall_s": wall, "device_events": len(spans),
           "device_busy_s": busy if spans else None,
           "idle_share": 1 - busy / wall if spans else None,
           "device_s": by_family,
           "copy_kernels_s": sum(dur for name, dur in by_name.items()
                                 if "copy_kernel" in name) / 1e9,
           "top_other": sorted(other.items(), key=lambda kv: -kv[1])[:6]}
    emit(row)
    return row


def phase_train_profile(step, batches):
    """Two more steps of `train` under torch.profiler."""
    def two_steps():
        for b in batches[:2]:
            step(*b)

    return _device_profile("train_profile", two_steps)


# -- slice 11: weight-only products and generation on the dense caches ------

WO_SHAPES = (("q_k_v_o", 4096, 4096), ("gate_up", 4096, 11008),
             ("down", 11008, 4096))    # (projection, K, N) of LLaMA-2-7B
WO_ROWS = (1, 8, 24, 32, 40, 64)   # decode B 1 and 8, beam B 2 x K 4 = 8,
#                                   verify B 8 x gamma 4 = 32, engine slots
WO_MAIN = ("gate_up", "int8", 8)   # the kernel line's row: B 8 decode


def _wo_counts():
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul

    return {"weight_only_linear": weight_only_matmul.launches,
            "weight_only_linear_plain_route": weight_only_matmul.plain_calls}


def _reset_wo_counts():
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul

    weight_only_matmul.launches = 0
    weight_only_matmul.plain_calls = 0


def _wo_case(gen, codes, scale, int4, k, rows, dtype, timed, w_bf16=None):
    """Kernel C on one x against its plain version (TOLERANCE per element,
    finite), two launches bit for bit; ``timed``: CUDA-event ms of one
    call, device ms with the L2 flushed (a decode step finds its weights
    cold), the plain version's ms, torch.matmul over the bf16 weight
    ``w_bf16`` beside, and the bound (codes, scales, x and y bytes over
    the HBM rate; 2 rows N K operations)."""
    import torch

    from paddle_tpu_torch.ops import weight_only as wo

    n = codes.shape[0]
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    before = wo.weight_only_matmul.launches
    got = wo.weight_only_matmul(x, codes, scale, int4, k)
    again = wo.weight_only_matmul(x, codes, scale, int4, k)
    if wo.weight_only_matmul.launches != before + 2:
        raise AssertionError(f"wo_linear rows {rows}: the kernel did not run")
    want = wo._wo_math(x, codes, scale, int4, k)
    label = (f"wo_linear {'int4' if int4 else 'int8'} {k}->{n} rows {rows} "
             f"{str(dtype)[6:]}")
    row = {"K": k, "N": n, "rows": rows, "weight": "int4" if int4 else "int8",
           "dtype": str(dtype),
           "max_abs_err": compare(label, got, want, rows),
           "max_abs_want": float(want.float().abs().max()),
           "same_bits": same_bits(label, lambda: wo.weight_only_matmul(
               x, codes, scale, int4, k)) and torch.equal(got, again)}
    if not timed:
        return row
    nbytes = (codes.numel() + 4 * n + (rows * k + rows * n)
              * x.element_size())
    b_ms, b_by = bound(nbytes, 2 * rows * n * k, str(dtype))
    dev_ms, per = device_ms(lambda: wo.weight_only_matmul(x, codes, scale,
                                                          int4, k))
    # one call is one launch of the one kernel: the split over K stays
    # inside it (no second pass, no partial buffer)
    if len(per) != 1 or "wo_hopper_kernel" not in next(iter(per)):
        raise AssertionError(f"{label}: one call launched {sorted(per)}")
    row.update(kernel_ms=cuda_ms(lambda: wo.weight_only_matmul(
        x, codes, scale, int4, k)), device_ms=dev_ms, device_kernels=per,
        bound_ms=b_ms, bound_by=b_by,
        plain_ms=cuda_ms(lambda: wo._wo_math(x, codes, scale, int4, k),
                         reps=5, warmup=1),
        plan=wo.plan(rows, n, k, int4)._asdict())
    if w_bf16 is not None:
        xb = x.to(torch.bfloat16)
        row["bf16_matmul_ms"] = cuda_ms(lambda: torch.matmul(xb, w_bf16.t()))
        row["bf16_matmul_device_ms"] = device_ms(
            lambda: torch.matmul(xb, w_bf16.t()))[0]
        if rows == 8:   # the dirty L2's write-back apart (device_ms)
            row["device_ms_clean"] = device_ms(lambda: wo.weight_only_matmul(
                x, codes, scale, int4, k), clean=True)[0]
            row["bf16_matmul_device_ms_clean"] = device_ms(
                lambda: torch.matmul(xb, w_bf16.t()), clean=True)[0]
    return row


def phase_wo_linear(seed=18):
    """Kernel C against its plain version at LLaMA-2-7B's projection
    shapes (4096 -> 4096, 4096 -> 11008, 11008 -> 4096), int8 and int4
    codes, bf16 and f32 x of 1, 8, 24, 32, 40 and 64 rows, two launches
    bit for bit; the codes and scales quantized on the card equal the
    CPU's bit for bit; the bf16 rows timed beside torch.matmul over the
    bf16 weight (device time with the L2 flushed by writes; at 8 rows
    also by reads), each call one launch of the one kernel. Then the
    edges: odd K (int4 pairs a padding nibble; int8 rows no multiple of
    16 bytes: the producer's copies instead of TMA), N no multiple of the
    64-channel tile, and 65 rows, which take the plain form (dequantize,
    then torch.mm) and no launch."""
    import torch

    from paddle_tpu_torch.nn.quant import quantize_rows
    from paddle_tpu_torch.ops import weight_only as wo

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows_out = []
    for proj, k, n in WO_SHAPES:
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        w_bf16 = w.to(torch.bfloat16)
        w_cpu = w.cpu()
        for int4 in (False, True):
            codes, scale = quantize_rows(w, int4)
            c_cpu, s_cpu = quantize_rows(w_cpu, int4)
            if not (torch.equal(codes.cpu(), c_cpu)
                    and torch.equal(scale.cpu().view(torch.int32),
                                    s_cpu.view(torch.int32))):
                raise AssertionError(
                    f"wo_linear {proj}: codes or scales quantized on the "
                    "card differ from the CPU's")
            for dtype in (torch.bfloat16, torch.float32):
                for rows in WO_ROWS:
                    row = _wo_case(gen, codes, scale, int4, k, rows, dtype,
                                   timed=dtype == torch.bfloat16,
                                   w_bf16=w_bf16)
                    row.update(phase="wo_linear", projection=proj,
                               codes_equal_cpu=True)
                    emit(row)
                    rows_out.append(row)
            del codes, scale
        del w, w_bf16, w_cpu
    edges = []
    for k, n, rows, int4 in ((4095, 4100, 8, True), (4095, 4100, 8, False),
                             (4096, 4100, 64, True), (4097, 33, 3, False)):
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        codes, scale = quantize_rows(w, int4)
        for dtype in (torch.bfloat16, torch.float32):
            edges.append(_wo_case(gen, codes, scale, int4, k, rows, dtype,
                                  timed=False))
    x = torch.randn((65, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    codes, scale = quantize_rows(torch.randn((4096, 4096), generator=gen,
                                             device="cuda"), False)
    before = _wo_counts()
    got = wo.weight_only_matmul(x, codes, scale, False, 4096)
    after = _wo_counts()
    if (after["weight_only_linear"] != before["weight_only_linear"]
            or after["weight_only_linear_plain_route"]
            != before["weight_only_linear_plain_route"] + 1
            or not torch.equal(got, wo._wo_math(x, codes, scale, False,
                                                 4096))):
        raise AssertionError(f"wo_linear: 65 rows did not take the plain "
                             f"form alone: {before} -> {after}")
    emit({"phase": "wo_linear_edges", "cases": edges,
          "rows_65_plain_route": True})
    rows_out[0]["edge_max_abs_err"] = max(r["max_abs_err"] for r in edges)
    return rows_out


def _gen_counts():
    """Kernel launches a generate reaches: K1's forward (the growing
    cache's causal attention) and kernel C's two routes."""
    from paddle_tpu_torch.ops.flash_attention import flash_fwd

    return {"flash_attention_fwd": flash_fwd.launches, **_wo_counts()}


def _reset_gen_counts():
    from paddle_tpu_torch.ops.flash_attention import flash_fwd

    flash_fwd.launches = 0
    _reset_wo_counts()


def _generate_logits(model, ids):
    """f32 logits of the token after each row of ``ids`` (the whole prefix
    through the no-cache forward)."""
    import torch

    dev = next(model.parameters()).device
    with torch.no_grad():
        return model(torch.as_tensor(ids, device=dev))[:, -1].float().cpu()


def explain_generate_divergences(gpu_model, cpu_model, got, want, prompt_len):
    """Each row's first differing generated token, with the logits of the
    shared prefix on the card and on the CPU; ``explained`` at a near tie
    (``explain_divergences``'s NEAR_TIE rule)."""
    import numpy as np

    out = []
    for r, (g, w) in enumerate(zip(got, want)):
        diff = np.nonzero(g != w)[0]
        if len(diff) == 0:
            continue
        pos = int(diff[0])
        lg = _generate_logits(gpu_model, w[None, :pos])[0]
        lc = _generate_logits(cpu_model, w[None, :pos])[0]
        noise = float((lg - lc).abs().max())
        gap = float(lc[int(w[pos])] - lc[int(g[pos])])
        out.append({"row": r, "position": pos - prompt_len,
                    "card": int(g[pos]), "cpu": int(w[pos]),
                    "cpu_gap": gap, "logits_max_diff": noise,
                    "explained": noise <= NEAR_TIE and abs(gap) <= NEAR_TIE})
    return out


GEN_EQUAL_NEW = 32


def phase_generate_equal(seed=19):
    """f32, LLaMA-2-7B widths, 1 layer (the draft too): the card's tokens
    equal the CPU's in every generate path: greedy at B 4 with prompts of
    100 tokens and 32 new, an attention_mask batch (rows of 60-100
    tokens, padded right and left), sampled (temperature 0.8, top-k 40,
    top-p 0.9) with the same noise, beam search K 4 at B 2, speculative
    with a 1-layer draft and gamma 4 (equal to each device's greedy), and
    greedy on int8 and int4 weight-only copies (all projections and the
    head quantized; codes and scales bit-identical to the CPU's). Kernel
    C's launches are exact: each decode forward of the quantized models
    launches it for the 2 x 7 projections and the head, and the prefill
    (400 rows) takes the plain form. Then a growing-cache decode (a
    100-token prefill, 8 tokens one at a time): K1's launches exactly 2 a
    forward, the logits the CPU's within 1e-4 relative, and the last
    step's equal to the fixed cache's on the card."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    cfg = llama2_7b()
    cfg.num_hidden_layers = EQUAL_LAYERS
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    dcfg = llama2_7b()
    dcfg.num_hidden_layers = 1
    cpu_draft = LlamaForCausalLM(dcfg, device="cpu", seed=seed + 1)
    gpu_draft = copy.deepcopy(cpu_draft).to("cuda")
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (4, 100)).astype(np.int32)
    ragged = rng.randint(1, cfg.vocab_size, (4, 100)).astype(np.int32)
    mask = np.zeros((4, 100), np.int32)
    for r, (n, left) in enumerate(((100, False), (60, False), (77, True),
                                   (91, True))):
        if left:
            mask[r, 100 - n:] = 1
        else:
            mask[r, :n] = 1
    new = GEN_EQUAL_NEW
    runs = (
        ("greedy", None, lambda m, d: m.generate(ids, max_new_tokens=new)),
        ("attention_mask", None, lambda m, d: m.generate(
            ragged, max_new_tokens=16, attention_mask=mask)),
        ("sampled", None, lambda m, d: m.generate(
            ids, max_new_tokens=16, do_sample=True, temperature=0.8,
            top_k=40, top_p=0.9, seed=0)),
        ("beam", None, lambda m, d: m.generate(
            ids[:2], max_new_tokens=16, num_beams=4, length_penalty=1.0)),
        ("speculative", None, lambda m, d: m.generate_speculative(
            ids, d, max_new_tokens=16, gamma=4)),
        ("int8_greedy", "int8", lambda m, d: m.generate(
            ids, max_new_tokens=8)),
        ("int4_greedy", "int4", lambda m, d: m.generate(
            ids, max_new_tokens=8)),
    )
    rows, greedy = [], {}
    for name, quant, run in runs:
        models = [(gpu_model, gpu_draft), (cpu_model, cpu_draft)]
        if quant is not None:
            models = [(quantize_for_inference(copy.deepcopy(m), quant), d)
                      for m, d in models]
            codes_equal = all(
                torch.equal(a.cpu(), b) for a, b in zip(
                    models[0][0].buffers(), models[1][0].buffers()))
        outs, secs = [], []
        for i, (m, d) in enumerate(models):
            if i == 0:
                _reset_gen_counts()
            t0 = time.perf_counter()
            outs.append(run(m, d).cpu().numpy())
            if i == 0:
                torch.cuda.synchronize()
                counts = _gen_counts()
            secs.append(time.perf_counter() - t0)
        got, want = outs
        same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
        row = {"phase": "generate_equal", "run": name,
               "layers": EQUAL_LAYERS,
               "dtype": "float32", "B": got.shape[0],
               "new_tokens": got.shape[1] - ids.shape[1],
               "identical": same, "kernels": counts, "gpu_s": secs[0],
               "cpu_s": secs[1]}
        if name == "greedy":
            greedy = {"card": got, "cpu": want}
        if name == "speculative":
            n = got.shape[1]
            row["equal_to_greedy"] = [
                bool(np.array_equal(got, greedy["card"][:, :n])),
                bool(np.array_equal(want, greedy["cpu"][:, :n]))]
        if quant is not None:
            row["codes_and_scales_equal_cpu"] = codes_equal
            # a decode forward launches kernel C for every projection and
            # the head; the 4 x 128 prefill takes the plain form
            per_forward = 7 * cfg.num_hidden_layers + 1
            row["expected_kernels"] = {
                "weight_only_linear": per_forward * (row["new_tokens"] - 1),
                "weight_only_linear_plain_route": per_forward}
        if not all(same):
            row["divergences"] = explain_generate_divergences(
                models[0][0], models[1][0], got, want, ids.shape[1])
            same = [s or any(d["row"] == r and d["explained"]
                             for d in row["divergences"])
                    for r, s in enumerate(same)]
            row["identical_or_near_tie"] = same
        emit(row)
        rows.append(row)
        if not all(same):
            raise AssertionError(
                f"generate_equal {name}: card and CPU generated different "
                f"tokens beyond near ties: {row['divergences']}")
        if name == "speculative" and not all(row["equal_to_greedy"]):
            raise AssertionError("generate_equal: speculative decoding "
                                 "differs from its device's greedy")
        if quant is not None:
            if not codes_equal:
                raise AssertionError(f"generate_equal {name}: codes or "
                                     "scales differ between card and CPU")
            for key, want_n in row["expected_kernels"].items():
                if counts[key] != want_n:
                    raise AssertionError(
                        f"generate_equal {name}: {key} {counts[key]} "
                        f"launches, expected {want_n}")
        elif counts["weight_only_linear"] or counts["flash_attention_fwd"]:
            raise AssertionError(f"generate_equal {name}: unexpected "
                                 f"launches {counts}")
        if quant is not None:
            del models
    rows.append(_growing_cache_equal(gpu_model, cpu_model, ids))
    del gpu_model, gpu_draft
    torch.cuda.empty_cache()
    return rows


def _growing_cache_equal(gpu_model, cpu_model, ids, steps=8):
    """The growing (concat) cache on the card: a 100-token prefill and
    ``steps`` single tokens at their absolute positions (the card's greedy
    tokens, fed to the CPU too), each forward's attention K1 (causal, Sq 1
    against Sk 101..), exactly 2 launches a forward; the logits the CPU's
    within 1e-4 of their largest, and the last step's the fixed cache's on
    the card."""
    import torch

    from paddle_tpu_torch.generation import prompt_bucket

    cfg = gpu_model.config
    B, S = ids.shape
    empty = (B, 0, cfg.num_key_value_heads, cfg.head_dim)
    fed, outs = [], []
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        caches = [(torch.zeros(empty, device=dev),) * 2
                  for _ in range(cfg.num_hidden_layers)]
        logits = []
        if dev == "cuda":
            _reset_gen_counts()
        with torch.no_grad():
            lg, caches = model(torch.as_tensor(ids, device=dev).long(),
                               past_key_values=caches, use_cache=True)
            for t in range(steps):
                if dev == "cuda":
                    fed.append(lg[:, -1].argmax(-1).cpu())
                pos = torch.full((B, 1), S + t, device=dev)
                lg, caches = model(fed[t][:, None].to(dev), position_ids=pos,
                                   past_key_values=caches, use_cache=True)
                logits.append(lg[:, -1].float().cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = _gen_counts()
        outs.append(torch.stack(logits, 1))
    got, want = outs
    rel = float((got - want).abs().max() / want.abs().max())
    seq = torch.cat([torch.as_tensor(ids).long(), torch.stack(fed, 1)], 1)
    with torch.no_grad():
        lf, _ = gpu_model(seq.cuda(), past_key_values=gpu_model.init_cache(
            B, prompt_bucket(seq.shape[1])), cache_position=0,
            use_cache=True)
    fixed_rel = float((lf[:, -1].float().cpu() - got[:, -1]).abs().max()
                      / got[:, -1].abs().max())
    row = {"phase": "generate_equal", "run": "growing_cache", "B": B,
           "prefill": S, "steps": steps, "kernels": counts,
           "logits_rel_err_vs_cpu": rel,
           "last_step_rel_err_vs_fixed_cache": fixed_rel}
    emit(row)
    want_k1 = cfg.num_hidden_layers * (1 + steps)
    if counts["flash_attention_fwd"] != want_k1:
        raise AssertionError(f"generate_equal growing cache: K1 launched "
                             f"{counts['flash_attention_fwd']} times, "
                             f"expected {want_k1}")
    if not (rel <= 1e-4 and fixed_rel <= 1e-4):
        raise AssertionError(f"generate_equal growing cache: logits off by "
                             f"{rel} (CPU), {fixed_rel} (fixed cache)")
    return row


GEN_B, GEN_PROMPT, GEN_NEW = 8, 512, 256   # bench.py run_decode's traffic
SPEC_DRAFT_LAYERS, SPEC_GAMMA = 8, 4       # run_spec_decode: layers // 4


def _weight_bytes(model):
    """Bytes of the weights one decode step reads: every projection and
    the head (bf16 weights, or codes and scales) and the norms; the
    embedding gives B rows only."""
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear

    total = 0
    for name, m in model.named_modules():
        if isinstance(m, WeightOnlyLinear):
            total += (m.quant_weight.numel()
                      + 4 * m.weight_scale.numel())
        elif "embed" not in name:
            total += sum(p.numel() * p.element_size()
                         for p in m.parameters(recurse=False))
    return total


def _timed_generate(model, ids, new, **kw):
    """(output, wall seconds, peak GB) of one generate on the card."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (
        torch.cuda.max_memory_allocated() / 1e9)


def _decode_row(phase, model, ids, **kw):
    """bench.py run_decode's measurement on the card: a warm-up, the
    prefill alone (1 new token), then the whole generate; tokens/s, decode
    ms a step, the share of HBM bandwidth the weights' reads take
    (weight bytes a step x steps/s / 3.35 TB/s) and peak memory; kernel
    C's launches over the timed generate alone."""
    new = GEN_NEW
    model.generate(ids[:, :16], max_new_tokens=4, **kw)
    _, prefill_s, _ = _timed_generate(model, ids, 1, **kw)
    _reset_gen_counts()
    out, wall, peak = _timed_generate(model, ids, new, **kw)
    counts = _gen_counts()
    decode_ms = (wall - prefill_s) / (new - 1) * 1e3
    wbytes = _weight_bytes(model)
    row = {"phase": phase, "B": ids.shape[0], "prompt": ids.shape[1],
           "new_tokens": new, "wall_s": wall,
           "tokens_per_s": ids.shape[0] * new / wall,
           "prefill_s": prefill_s, "decode_ms_per_step": decode_ms,
           "weight_bytes_per_step": wbytes,
           "hbm_share": wbytes / (decode_ms / 1e3) / HBM_BYTES_PER_S,
           "peak_mem_gb": peak, "kernels": counts}
    vocab = model.config.vocab_size
    if out.shape != (ids.shape[0], ids.shape[1] + new) or not bool(
            ((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"{phase}: output {tuple(out.shape)} or ids "
                             "out of range")
    return row, out.cpu()


def phase_generate(seed=0):
    """LLaMA-2-7B bf16 at GEN_LAYERS of 32 layers, bench.py run_decode's
    traffic: B 8, prompts of 512, 256 new tokens, greedy: tokens/s, decode
    ms a step, HBM share, peak memory. Then speculative with an 8-layer
    draft of the same widths (run_spec_decode's layers // 4) and gamma 4:
    tokens/s, accepted tokens a round, the share of tokens equal to the
    greedy run's; beam search K 4 at B 2; int8 and int4 weight-only with
    the head kept bf16 (bench.py:350): kernel C launches exactly 7 a layer
    per decode forward, the prefill takes the plain form, and one short
    decode is profiled for the idle share and kernel C's share of the
    device time, the prefill alone beside it (each dtype's copy kernels
    by where they run)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    def build():
        cfg = llama2_7b(dtype="bfloat16")
        cfg.num_hidden_layers = GEN_LAYERS
        return LlamaForCausalLM(cfg, device="cuda", seed=seed)

    model = build()
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, model.config.vocab_size,
                      (GEN_B, GEN_PROMPT)).astype(np.int32)
    rows = {}
    row, greedy = _decode_row("generate", model, ids)
    row["profile"] = _device_profile(
        "generate_profile", lambda: model.generate(ids, max_new_tokens=8))
    row["prefill_profile"] = _device_profile(
        "generate_prefill_profile",
        lambda: model.generate(ids, max_new_tokens=1))
    emit(row)
    rows["bf16"] = row
    dcfg = llama2_7b(dtype="bfloat16")
    dcfg.num_hidden_layers = SPEC_DRAFT_LAYERS
    draft = LlamaForCausalLM(dcfg, device="cuda", seed=seed + 1)
    model.generate_speculative(ids[:, :16], draft, max_new_tokens=8,
                               gamma=SPEC_GAMMA)
    # the target's forwards: the prefill, then one verify a round
    forwards, fwd = [], model._fwd
    model._fwd = lambda *a, **k: forwards.append(1) or fwd(*a, **k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec = model.generate_speculative(ids, draft, max_new_tokens=GEN_NEW,
                                      gamma=SPEC_GAMMA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del model._fwd
    rounds = len(forwards) - 1
    spec = spec.cpu()
    row = {"phase": "generate_speculative", "draft_layers": SPEC_DRAFT_LAYERS,
           "gamma": SPEC_GAMMA, "B": GEN_B, "new_tokens": GEN_NEW,
           "wall_s": wall, "tokens_per_s": GEN_B * GEN_NEW / wall,
           "rounds": rounds,
           "accepted_tokens_per_round": (GEN_NEW - 1) / rounds,
           "tokens_equal_to_greedy_share": float(
               (spec[:, GEN_PROMPT:] == greedy[:, GEN_PROMPT:]).float()
               .mean()),
           "greedy_tokens_per_s": rows["bf16"]["tokens_per_s"]}
    emit(row)
    rows["speculative"] = row
    del draft
    torch.cuda.empty_cache()
    beam_ids = ids[:2]
    model.generate(beam_ids[:, :16], max_new_tokens=4, num_beams=4)
    out, wall, peak = _timed_generate(model, beam_ids, GEN_NEW, num_beams=4)
    row = {"phase": "generate_beam", "B": 2, "num_beams": 4,
           "prompt": GEN_PROMPT, "new_tokens": GEN_NEW, "wall_s": wall,
           "tokens_per_s": 2 * GEN_NEW / wall, "peak_mem_gb": peak}
    emit(row)
    rows["beam"] = row
    for quant in ("int8", "int4"):
        if quant == "int4":
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = build()
        quantize_for_inference(model, quant,
                               skip=lambda name, layer: "lm_head" in name)
        row, out = _decode_row(f"generate_{quant}", model, ids)
        layers = model.config.num_hidden_layers
        want = {"weight_only_linear": 7 * layers * (GEN_NEW - 1),
                "weight_only_linear_plain_route": 7 * layers}
        row.update(weight=quant, expected_kernels=want,
                   tokens_equal_to_bf16_share=float(
                       (out[:, GEN_PROMPT:] == greedy[:, GEN_PROMPT:])
                       .float().mean()))
        row["profile"] = _device_profile(
            f"generate_{quant}_profile",
            lambda: model.generate(ids, max_new_tokens=8))
        # the prefill alone: its plain form (dequantize, then the product)
        # against the 7 decode steps' kernel C
        row["prefill_profile"] = _device_profile(
            f"generate_{quant}_prefill_profile",
            lambda: model.generate(ids, max_new_tokens=1))
        row["kernel_c_device_share"] = (
            row["profile"]["device_s"].get("weight_only_linear", 0.0)
            / row["profile"]["device_busy_s"])
        row["decode_ms_per_step_bf16"] = rows["bf16"]["decode_ms_per_step"]
        emit(row)
        rows[quant] = row
        for key, n in want.items():
            if row["kernels"][key] != n:
                raise AssertionError(f"generate_{quant}: {key} "
                                     f"{row['kernels'][key]}, expected {n}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def growing_cache_edges(gen):
    """K1's forward at the growing cache's decode shapes: causal Sq 1 and
    7 against Sk 1000 (B 8, 32 heads of 128, bf16), each output row held
    against the plain version (``row_check``) and the saved lse within
    LSE_TOL; the public scaled_dot_product_attention gives the same bits."""
    import torch

    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    from paddle_tpu_torch.ops import flash_attention as fa

    rows = []
    for sq in (1, 7):
        q = torch.randn((8, sq, HQ, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((8, 1000, HQ, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        scale = D ** -0.5
        out, lse = fa.flash_fwd(q, k, v, True, scale)
        check = row_check(out, fa._attention_math(q, k, v, True, scale),
                          True)
        lse_err = lse_error(lse, _plain_lse(q, k, fa._causal_mask(q, k, True),
                                            scale))
        public = torch.equal(scaled_dot_product_attention(
            q, k, v, is_causal=True, training=False), out)
        row = {"phase": "k1", "edge": f"growing_cache_sq{sq}", "B": 8,
               "sq": sq, "sk": 1000, "hq": HQ, "hkv": HQ, "d": D,
               "causal": True, "dtype": "torch.bfloat16",
               "max_abs_err": {"o": check["max_abs_err"], "lse": lse_err},
               "checks": {"o": check}, "public_entry_equal": public}
        emit(row)
        if (check["bad_rows"] or check["bad_elements"] or not check["finite"]
                or not lse_err <= LSE_TOL or not public):
            raise AssertionError(f"k1 growing-cache edge Sq {sq}: {row}")
        rows.append(row)
    return rows


# -- slice 12: mixture of experts (kernels D and E, the MoE LLaMA) -----------

# Mixtral-8x7B's widths (Jiang et al. 2024, "Mixtral of Experts", table 1)
MIXTRAL = dict(hidden_size=4096, intermediate_size=14336,
               num_attention_heads=32, num_key_value_heads=8, num_experts=8,
               moe_top_k=2, rope_theta=1e6, vocab_size=32000,
               max_position_embeddings=4096)
# bench.py's MOE_RUNG widths (bench.py:49-50), its only MoE workload
MOE_RUNG_WIDTHS = dict(hidden_size=1024, intermediate_size=2816,
                       num_attention_heads=16, num_experts=8, moe_top_k=2,
                       vocab_size=32000, max_position_embeddings=2048)
MOE_TRAIN_LAYERS = 4      # depth cut from 32: 1.45 B parameters a layer
MOE_AUX_TOL = 1e-5        # the aux loss, card vs CPU (f32, relative)
# kernel D/E token counts: Mixtral's training step (B 2 x S 2048) and
# its B 8 decode step
MOE_TRAIN_T, MOE_DECODE_T = 2 * 2048, 8


def moe_shape(T):
    """(T, M, E, k, C) that ``moe_train``'s MoE layers give kernels D and
    E for T tokens: C as the model's gate computes it (its default
    capacity factor; 1228 at T 4096, _capacity's floor of 4 at T 8)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.incubate.distributed.models.moe.gate import (
        _capacity)

    cfg = _moe_cfg(MIXTRAL, MOE_TRAIN_LAYERS)
    gate = MoELayer(cfg.hidden_size, gate={
        "type": cfg.moe_gate, "num_expert": cfg.num_experts,
        "top_k": cfg.moe_top_k}, device="meta").gate
    E, k = gate.tot_expert, gate.top_k
    return (T, cfg.hidden_size, E, k,
            _capacity(T, E, k, gate.capacity_factor))


def _record_routing(model):
    """Per gate forward of ``model``, in order: (layer, slots on the CPU,
    aux loss); and the hooks' handles."""
    seen, handles = [], []
    for i, layer in enumerate(model.llama.layers):
        def hook(module, args, r, i=i):
            seen.append((i, r.slot.detach().cpu(), float(r.aux.detach())))

        handles.append(layer.mlp.gate.register_forward_hook(hook))
    return seen, handles


def _routing_report(routes):
    """Card vs CPU routing over the same forwards: slots identical, aux
    within MOE_AUX_TOL."""
    (card, hc), (cpu, hp) = routes["cuda"], routes["cpu"]
    for h in hc + hp:
        h.remove()
    differing = [int((g[1] != c[1]).sum()) for g, c in zip(card, cpu)]
    aux = [abs(g[2] - c[2]) / abs(c[2]) for g, c in zip(card, cpu)]
    dropped = [int((c[1] < 0).sum()) for c in cpu]
    ok = (len(card) == len(cpu) and not any(differing)
          and max(aux) <= MOE_AUX_TOL)
    return {"gate_calls": [len(card), len(cpu)],
            "slots_differing": differing, "aux_rel": aux,
            "aux_tol": MOE_AUX_TOL, "dropped_choices_cpu": dropped,
            "ok": ok}


def _recorded_draws(fn):
    """``fn()`` with every sampler ``generation._make_sampler`` makes
    recording its (logits, tokens) on the CPU, in draw order: (fn's
    result, draws)."""
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.inference import continuous

    draws, make = [], generation._make_sampler

    def recording(*a, **kw):
        sample = make(*a, **kw)

        def rec(logits, *rest):
            out = sample(logits, *rest)
            draws.append((logits.float().cpu(), out.cpu()))
            return out

        return rec

    generation._make_sampler = continuous._make_sampler = recording
    try:
        return fn(), draws
    finally:
        generation._make_sampler = continuous._make_sampler = make


def explain_moe_divergence(card_draws, cpu_draws):
    """The first draw at which any row's token differs card vs CPU (an MoE
    layer routes over the whole batch, so every later draw of every row
    follows from it): ``explained`` when, at that draw, the differing
    rows' logits agree within NEAR_TIE and the CPU's logits for its token
    and the card's are within NEAR_TIE of each other (a near tie)."""
    if len(card_draws) != len(cpu_draws):
        return {"draws": [len(card_draws), len(cpu_draws)],
                "explained": False}
    for i, ((lg, tg), (lc, tc)) in enumerate(zip(card_draws, cpu_draws)):
        rows = (tg != tc).nonzero().flatten().tolist()
        if not rows:
            continue
        noise = float((lg[rows] - lc[rows]).abs().max())
        gaps = [float(lc[r, int(tc[r])] - lc[r, int(tg[r])]) for r in rows]
        return {"draw": i, "of": len(cpu_draws), "rows": rows,
                "card": [int(tg[r]) for r in rows],
                "cpu": [int(tc[r]) for r in rows], "cpu_gaps": gaps,
                "logits_max_diff": noise,
                "explained": noise <= NEAR_TIE
                and max(abs(g) for g in gaps) <= NEAR_TIE}
    return None


def _moe_probs(gen, T, E, kind):
    """[T, E] f32 routing probabilities of an edge ``kind`` on the card."""
    import torch

    logits = torch.randn(T, E, generator=gen, device="cuda")
    if kind == "zero_weight":          # one-hot rows: the 2nd choice is 0
        return torch.nn.functional.one_hot(logits.argmax(-1), E).float()
    if kind in ("one_expert", "dropped_both"):
        logits[:, 0] += 8.0            # every first choice is expert 0
    if kind == "dropped_both":
        logits[:, 1] += 4.0            # and every second choice expert 1
    if kind == "empty_expert":
        logits[:, E - 1] = -float("inf")
    return torch.softmax(logits, -1)


def _moe_bytes(r, T, M, elt):
    """The bytes each entry must move on this routing (each input row
    read once, each output row written once, indices and weights)."""
    import torch

    R, k = r.num_slots, r.top_k
    occ = r.occupied_slot >= 0
    kept = r.slot >= 0
    n_occ, n_kept = int(occ.sum()), int(kept.sum())
    tok_occ, tok_kept = int(occ.any(-1).sum()), int(kept.any(-1).sum())
    row = M * elt
    return {"dispatch": (tok_occ + R) * row + R * 4,
            "combine": (n_kept + T) * row + T * k * 8,
            "dispatch_scaled": (tok_occ + R) * row + R * 8,
            "combine_unit": (n_occ + T) * row + T * k * 4,
            "combine_dw": (tok_kept + n_kept) * row + T * k * 8}, {
                "dispatch": 0, "combine": 2 * n_kept * M,
                "dispatch_scaled": n_occ * M, "combine_unit": n_occ * M,
                "combine_dw": 2 * n_kept * M}, {
                "occupied_slots": n_occ, "kept_choices": n_kept,
                "dropped_choices": T * k - n_kept,
                "tokens_fully_dropped": int((~kept.any(-1)).sum()),
                "empty_experts": int((~(r.dispatch_src.view(
                    r.num_expert, -1) >= 0).any(-1)).sum())}


def _moe_case(gen, shape, dtype, kind="random", timed=False):
    """Kernels D and E, forward and backward, against their plain versions
    (the reference's einsums over the dense routing) on one routing.
    Exact: the dispatched rows and the expert outputs' gradient (a copy,
    one product), and in bf16 at k <= 2 the combine and the tokens'
    gradient (two exact f32 products or bf16 values summed and rounded
    once); else the dtype's TOLERANCE against the plain version run in
    f64 on the same inputs (at M 4096 the f32 einsum's own summation
    error passes f32's TOLERANCE; ``plain_err`` is its distance from the
    f64 run). The weights' gradient (row dot products) likewise. Two
    launches of each entry give the same bits. ``timed``: each entry's
    kernel ms, device ms (L2 flushed), bound, plain ms and the library's
    dense einsum (D: index_select too)."""
    import torch

    from paddle_tpu_torch.incubate.distributed.models.moe import route
    from paddle_tpu_torch.ops import moe_dispatch as md

    T, M, E, k, C = shape
    r = route(_moe_probs(gen, T, E, kind).to(dtype), k, C)
    R = E * C

    def randn(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dtype)

    tok, xo, d_disp, dout = (randn(T, M), randn(E, C, M), randn(E, C, M),
                             randn(T, M))

    def run(dispatch, combine, dt=dtype):
        t = tok.to(dt, copy=True).requires_grad_()
        x = xo.to(dt, copy=True).requires_grad_()
        w = r.weight.detach().to(dt).requires_grad_()
        rt = md.Routing(r.expert, r.pos, r.slot, w, r.aux, E, C)
        d, o = dispatch(t, rt), combine(x, rt)
        torch.autograd.backward((d, o), (d_disp.to(dt), dout.to(dt)))
        return {"dispatched": d.detach(), "out": o.detach(),
                "d_tokens": t.grad, "d_expert_out": x.grad,
                "d_weight": w.grad}

    _reset_moe_counts()
    got = run(md.moe_dispatch, md.moe_combine)
    torch.cuda.synchronize()
    launches = _moe_counts()
    want = run(md._dispatch_math, md._combine_math)
    want64 = run(md._dispatch_math, md._combine_math, torch.float64)
    torch.cuda.synchronize()
    sums_exact = dtype == torch.bfloat16 and k <= 2
    exact_keys = ("dispatched", "d_expert_out") + (
        ("out", "d_tokens") if sums_exact else ())
    label = f"moe_dispatch {kind} {dtype} T{T} k{k} C{C}"
    errs, plain_err = {}, {}
    for key in got:
        g, w = got[key], want[key]
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{label} {key}: non-finite kernel output")
        if key in exact_keys:    # equal values (the sign of a 0 aside)
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{label} {key}: {int((g != w).sum())} elements differ "
                    "from the plain version (exact expected)")
            errs[key] = 0.0
        else:
            g2, w64 = g.reshape(-1, g.shape[-1]), want64[key]
            errs[key] = compare(f"{label} {key}", g2,
                                w64.reshape(g2.shape), g2.shape[0])
            plain_err[key] = float((w.double() - w64).abs().max())
    if launches != {"moe_dispatch": 2, "moe_combine": 2,
                    "moe_combine_dw": 1}:
        raise AssertionError(f"{label}: launches {launches}")
    x2, d2 = xo.reshape(R, M), d_disp.reshape(R, M)
    w32 = r.weight.detach().float().contiguous()
    idx = torch.where(r.slot >= 0, r.slot, R).long().reshape(-1)
    w_slot = torch.zeros(R + 1, device="cuda").scatter_(
        0, idx, w32.reshape(-1))[:R].contiguous()
    entries = {
        "dispatch": lambda: md.dispatch_rows(tok, r.dispatch_src),
        "combine": lambda: md.combine_rows(x2, r.slot, w32),
        "dispatch_scaled": lambda: md.dispatch_rows(dout, r.dispatch_src,
                                                    w_slot),
        "combine_unit": lambda: md.combine_rows(d2, r.occupied_slot),
        "combine_dw": lambda: md.combine_dw(dout, x2, r.slot)}
    for name, fn in entries.items():
        same_bits(f"{label} {name}", fn)
    nbytes, ops, stats = _moe_bytes(r, T, M, tok.element_size())
    row = {"phase": "moe_dispatch", "kind": kind, "dtype": str(dtype),
           "T": T, "M": M, "E": E, "k": k, "C": C, "max_abs_err": errs,
           "plain_err": plain_err, "exact": list(exact_keys),
           "launches": launches, **stats}
    if timed:
        combine_d, dispatch_d = (t.detach() for t in r.dense())
        tok_pad = torch.cat([torch.zeros_like(tok[:1]), tok])
        src1 = (r.dispatch_src + 1).long()
        plain = {
            "dispatch": lambda: md._dispatch_math(tok, r),
            "combine": lambda: md._combine_math(xo, r),
            "dispatch_scaled": lambda: torch.einsum(
                "tec,tm->ecm", r.dense()[0], dout),
            "combine_unit": lambda: torch.einsum(
                "tec,ecm->tm", r.dense()[1], d_disp),
            "combine_dw": lambda: torch.einsum("tm,ecm->tec", dout, xo)}
        library = {
            "dispatch": lambda: torch.einsum("tec,tm->ecm", dispatch_d, tok),
            "combine": lambda: torch.einsum("tec,ecm->tm", combine_d, xo),
            "dispatch_scaled": lambda: torch.einsum(
                "tec,tm->ecm", combine_d, dout),
            "combine_unit": lambda: torch.einsum(
                "tec,ecm->tm", dispatch_d, d_disp),
            "combine_dw": lambda: torch.einsum("tm,ecm->tec", dout, xo)}
        with torch.no_grad():
            timing = {}
            for name, fn in entries.items():
                b_ms, b_by = bound(nbytes[name], ops[name], str(dtype))
                timing[name] = {
                    "kernel_ms": cuda_ms(fn),
                    "device_ms": device_ms(fn)[0],
                    "plain_ms": cuda_ms(plain[name]),
                    "library_ms": cuda_ms(library[name]),
                    "bytes": nbytes[name], "bound_ms": b_ms,
                    "bound_by": b_by}
            timing["dispatch"]["index_select_ms"] = cuda_ms(
                lambda: torch.index_select(tok_pad, 0, src1))
        einsum_ms, einsum_by = bound(0, 2 * T * E * C * M, str(dtype))
        row.update(timing=timing, library="torch.einsum over the dense "
                   "[T, E, C] routing tensors (built beforehand)",
                   einsum_bound_ms=einsum_ms, einsum_bound_by=einsum_by)
    emit(row)
    return row


MOE_EDGES = (  # (kind, T, k, C): drops, dropped twice, a zero weight, an
    # empty expert, k 1 and 4, and 21 (token, choice) pairs
    ("one_expert", 64, 2, 20), ("dropped_both", 64, 2, 4),
    ("zero_weight", 64, 2, 20), ("empty_expert", 256, 2, 80),
    ("random", 256, 1, 40), ("random", 256, 4, 160), ("random", 7, 3, 4))


def phase_moe_dispatch(seed=20):
    """Kernels D and E, forward and backward, against their plain versions
    at Mixtral's training shape (timed, bf16; f32 too) and decode shape,
    then the edges (``MOE_EDGES``) in bf16 and f32; the operands the
    kernels refuse raise. Matmuls in bf16 run without reduced-precision
    reductions here, so the plain einsum sums in f32 as the kernels do."""
    import torch

    from paddle_tpu_torch.ops import moe_dispatch as md

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        train, decode = moe_shape(MOE_TRAIN_T), moe_shape(MOE_DECODE_T)
        rows = [_moe_case(gen, train, bf16, timed=True),
                _moe_case(gen, train, f32),
                _moe_case(gen, decode, bf16),
                _moe_case(gen, decode, f32)]
        M, E = train[1], train[2]
        for kind, T, k, C in MOE_EDGES:
            for dtype in (bf16, f32):
                rows.append(_moe_case(gen, (T, M, E, k, C), dtype, kind))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    src = torch.zeros(4, dtype=torch.int32, device="cuda")
    refusals = {
        "M * itemsize not a multiple of 16": lambda: md.dispatch_rows(
            torch.zeros(4, 12, dtype=bf16, device="cuda"), src),
        "fp16 rows": lambda: md.dispatch_rows(
            torch.zeros(4, 16, dtype=torch.float16, device="cuda"), src),
        "9 choices": lambda: md.combine_rows(
            torch.zeros(4, 16, device="cuda"),
            torch.zeros(2, 9, dtype=torch.int32, device="cuda"))}
    for what, fn in refusals.items():
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError(f"moe_dispatch: {what} was not refused")
    emit({"phase": "moe_dispatch", "refused": sorted(refusals)})
    return rows


def _moe_cfg(widths, layers, **kw):
    from paddle_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(num_hidden_layers=layers, **widths, **kw)


def phase_moe_equal(seed=21, steps=2, S=256):
    """f32, bench.py MOE_RUNG's widths at 2 layers, card vs CPU: two
    TrainSteps with ``make_loss_fn`` at B 1 x S 256 by ``_train_equal``'s
    rules, with every layer's slots identical and the aux loss within
    MOE_AUX_TOL; then greedy ``generate`` (B 4 prompts of 100, 16 new) and
    the engine's greedy serve (4 requests of 32-200 tokens, 16 new, f32
    pools): tokens identical, or the first differing draw at an explained
    near tie (``explain_moe_divergence``). D and E launch exactly once a
    layer per forward (gate calls), E's weight gradient never."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine

    cfg = _moe_cfg(MOE_RUNG_WIDTHS, 2, fuse_linear_cross_entropy=True)
    ids = _tokens(seed, cfg.vocab_size, (steps, 1, S + 1))
    row, gpu_model = _train_equal("moe_equal", seed,
                                  [(i[:, :-1], i[:, 1:]) for i in ids],
                                  cfg=cfg)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cpu_model = LlamaForCausalLM(cfg, device="cpu")  # the card's weights
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in gpu_model.state_dict().items()})
    for m in (gpu_model, cpu_model):
        m.eval()
    rng = np.random.RandomState(seed)
    prompts = rng.randint(1, cfg.vocab_size, (4, 100)).astype(np.int32)
    requests = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
                for n in (32, 77, 140, 200)]
    kw = dict(max_seqs=4, page_size=BS, max_len=512, decode_block=8)
    runs = {
        "generate": lambda m, dev: m.generate(prompts, max_new_tokens=16),
        "engine": lambda m, dev: ContinuousBatchingEngine(
            m, device=dev, **kw).serve(requests, max_new_tokens=16)}
    rows = [row]
    for name, run in runs.items():
        calls = []
        hooks = [layer.mlp.gate.register_forward_hook(
            lambda *a: calls.append(1)) for layer in gpu_model.llama.layers]
        _reset_moe_counts()
        _reset_counts()
        t0 = time.perf_counter()
        got, card_draws = _recorded_draws(lambda: run(gpu_model, "cuda"))
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        counts = {**_moe_counts(), **_counts()}
        for h in hooks:
            h.remove()
        t0 = time.perf_counter()
        want, cpu_draws = _recorded_draws(lambda: run(cpu_model, "cpu"))
        cpu_s = time.perf_counter() - t0
        same = [bool(np.array_equal(np.asarray(g.cpu() if torch.is_tensor(g)
                                               else g), np.asarray(w)))
                for g, w in zip(got, want)]
        div = explain_moe_divergence(card_draws, cpu_draws)
        want_moe = {"moe_dispatch": len(calls), "moe_combine": len(calls),
                    "moe_combine_dw": 0}
        r = {"phase": "moe_equal", "run": name, "identical": same,
             "divergence": div, "gate_calls": len(calls), "kernels": counts,
             "draws": len(card_draws), "gpu_s": gpu_s, "cpu_s": cpu_s}
        emit(r)
        rows.append(r)
        if not all(same) and not (div and div["explained"]):
            raise AssertionError(f"moe_equal {name}: card and CPU tokens "
                                 f"differ beyond a near tie: {div}")
        if {k: counts[k] for k in want_moe} != want_moe or not calls:
            raise AssertionError(f"moe_equal {name}: launches {counts}, "
                                 f"expected {want_moe}")
        if name == "generate" and len(calls) != 2 * 16:
            raise AssertionError(f"moe_equal generate: {len(calls)} gate "
                                 "calls, expected 2 layers x 16 forwards")
        if name == "engine":
            check_launches(counts, int8=False)
    del gpu_model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _moe_flops(cfg, S, T, C):
    """Training FLOPs per token of the MoE model, attention term included:
    ``active`` counts attention, the gate and k of E experts per token;
    ``slots`` the experts' products over all E x C capacity slots (what
    the expert bank computes, empty slots included)."""
    h, L, E, k = (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_experts,
                  cfg.moe_top_k)
    kv = cfg.num_key_value_heads * cfg.head_dim
    attn_n = 2 * h * h + 2 * h * kv + h * E
    expert_n = 3 * h * cfg.intermediate_size
    head = cfg.vocab_size * h * (1 if cfg.tie_word_embeddings else 2)
    quad = 12.0 * L * h * S * 0.5
    active = 6 * (head + L * (attn_n + k * expert_n)) + quad
    slots = 6 * (head + L * (attn_n + expert_n * E * C / T)) + quad
    return active, slots


def phase_moe_train(seed=22, warmup=2, timed=5):
    """Mixtral-8x7B's widths cut to MOE_TRAIN_LAYERS layers, bf16, B 2 x S
    2048, fused CE, no block recompute (MoE layers skip it), AdamW lr 1e-4
    and decay 0.01 through ``make_loss_fn``: 2 warm-up and 5 timed steps;
    step ms, tokens/s, MFU with the reference's flops_per_token (a dense
    MLP of intermediate_size a layer) and with the active count (k of E
    experts) and the slots computed, peak memory under 80 GB, dropped
    choices per layer, exact launches (K2 fwd and bwd entries, D and E per
    layer per step, kernel A once a step); then two steps profiled.
    Returns the row and the model."""
    import torch

    cfg = _moe_cfg(MIXTRAL, MOE_TRAIN_LAYERS, dtype="bfloat16",
                   fuse_linear_cross_entropy=True)
    model, step = _trainer(cfg, seed)
    batches = _token_batches(seed, cfg.vocab_size, warmup + timed, 2, 2048)
    L, T = cfg.num_hidden_layers, 2 * 2048
    slots, caps = [[] for _ in range(L)], []
    counting = []

    def hook(module, args, r, i):
        # only a reference in the timed window: counted after it
        if counting:
            slots[i].append(r.slot)
            caps.append(r.capacity)

    hooks = [layer.mlp.gate.register_forward_hook(
        lambda m, a, r, i=i: hook(m, a, r, i))
        for i, layer in enumerate(model.llama.layers)]
    row = _timed_steps("moe_train", cfg, model, step, batches, warmup,
                       on_timed=lambda: counting.append(1), extra={
                           "depth_cut": f"{MOE_TRAIN_LAYERS} of 32 layers",
                           "block_recompute": False,
                           "experts": cfg.num_experts,
                           "top_k": cfg.moe_top_k})
    for h in hooks:
        h.remove()
    dropped = [sum(int((s < 0).sum()) for s in layer) for layer in slots]
    full = [sum(int((s < 0).all(-1).sum()) for s in layer)
            for layer in slots]
    C = caps[0]
    if set(caps) != {moe_shape(T)[4]}:
        raise AssertionError(f"moe_train: capacities {sorted(set(caps))}, "
                             f"moe_dispatch timed C {moe_shape(T)[4]}")
    active, slots = _moe_flops(cfg, 2048, T, C)
    row.update(
        capacity=C, slots=cfg.num_experts * C,
        flops_per_token_active=active, mfu_active=active * row[
            "tokens_per_s"] / 989e12,
        flops_per_token_slots=slots, mfu_slots=slots * row[
            "tokens_per_s"] / 989e12,
        mfu_of="flops_per_token: the reference's (bench's accounting, one "
               "dense MLP of intermediate_size a layer); active: attention "
               "+ gate + k of E experts; slots: the experts over all E x C "
               "slots",
        dropped_choices_per_layer=[d / timed for d in dropped],
        tokens_fully_dropped_per_layer=[f / timed for f in full],
        choices_per_step=T * cfg.moe_top_k)
    emit({"phase": "moe_train", **{k: row[k] for k in (
        "capacity", "slots", "mfu_active", "mfu_slots",
        "dropped_choices_per_layer", "tokens_fully_dropped_per_layer",
        "peak_mem_gb")}})
    if row["peak_mem_gb"] >= 80:
        raise AssertionError(f"moe_train: peak {row['peak_mem_gb']} GB")
    row["profile"] = _device_profile("moe_train_profile", lambda: [
        step(*b) for b in batches[:2]])
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return row, model


def phase_moe_generate(model, seed=23):
    """``moe_train``'s model, greedy: bench.py run_decode's traffic (B 8,
    prompts of 512, 256 new), decode ms a step and tokens/s; then the
    engine serving 8 requests of 32-1024 tokens with 64 new: tokens/s,
    with K4/K5 and D/E launches."""
    import torch

    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine

    model.eval()
    ids = _tokens(seed, model.config.vocab_size, (GEN_B, GEN_PROMPT))
    _reset_moe_counts()
    row, _ = _decode_row("moe_generate", model, ids)
    row["kernels"].update(_moe_counts())
    emit(row)
    eng = ContinuousBatchingEngine(model, max_seqs=MAX_SEQS, page_size=BS,
                                   max_len=MAX_LEN, prefill_chunk=CHUNK,
                                   device="cuda")
    prompts = slice_prompts(seed, model.config.vocab_size)
    _reset_moe_counts()
    _, wall, ttft, counts = _timed_serve(eng, prompts, 64)
    counts.update(_moe_counts())
    serve = {"phase": "moe_generate", "run": "engine",
             "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
             "wall_s": wall, "tokens_per_s": 64 * len(prompts) / wall,
             "ttft_median_s": ttft, "kernels": counts}
    emit(serve)
    check_launches(counts, int8=False)
    for name in ("moe_dispatch", "moe_combine"):
        if row["kernels"][name] < 1 or counts[name] < 1:
            raise AssertionError(f"moe_generate: no {name} launch")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"generate": row, "engine": serve}


FE_NEW = 16            # frontend_equal's new tokens a request
FE_ENGINE = dict(max_seqs=4, page_size=BS, max_len=512, decode_block=8)
FE_CHUNK = 64


def _handoff_counts():
    from paddle_tpu_torch.observability.metrics import registry

    return {k: int(getattr(registry.get(f"serving.handoff.{k}"), "value", 0)
                   or 0)
            for k in ("published", "adopted", "corrupt", "stale",
                      "initiated")}


def _serving_counter(name):
    from paddle_tpu_torch.observability.metrics import registry

    return int(getattr(registry.get(name), "value", 0) or 0)


def _thread_counts(ident):
    """K4's and K5's launches (float and int8 pools) made by thread
    ``ident``: a replica's dispatcher."""
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    out = {}
    for fn in (ragged_paged_attention, paged_decode_attention):
        for attr, sfx in (("launches", ""), ("launches_int8", "_int8")):
            out[fn.__name__ + sfx] = fn.launches_by_thread.get(
                (attr, ident), 0)
    return out


def fe_load(seed, vocab):
    """frontend_equal's open-loop load: 4 `batch` prompts of 100-300 tokens
    and 4 `interactive` of 8-24, interleaved (batch first)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    batch = [rng.randint(1, vocab, int(rng.randint(100, 301)))
             .astype(np.int32) for _ in range(4)]
    inter = [rng.randint(1, vocab, int(rng.randint(8, 25)))
             .astype(np.int32) for _ in range(4)]
    load = []
    for b, i in zip(batch, inter):
        load += [(b, "batch"), (i, "interactive")]
    return load


def fe_engines(model, device, n=2, **kw):
    from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine

    knobs = dict(FE_ENGINE, prefill_chunk=FE_CHUNK, **kw)
    return [ContinuousBatchingEngine(model, device=device, **knobs)
            for _ in range(n)]


def fe_run(engines, load, new=FE_NEW, before_start=None, timeout=60,
           **fe_kw):
    """Serve ``load`` through a ServingFrontend over ``engines``: submit
    every request open loop, then wait for each result (``timeout`` s
    bound each). ``before_start(frontend)`` runs after the submits and before
    the dispatchers start (with it the frontend is built stopped).
    Returns (outputs, per-replica rows, frontend report)."""
    from paddle_tpu_torch.serving import ServingFrontend

    start = before_start is None
    with ServingFrontend(engines, heartbeat_deadline_s=fe_kw.pop(
            "heartbeat_deadline_s", 120.0), start=start, **fe_kw) as fe:
        handles = [fe.submit(p, new, slo_class=slo) for p, slo in load]
        if not start:
            before_start(fe)
            fe.start()
        outs = [h.result(timeout=timeout) for h in handles]
        reps = {r.name: {"state": r.state,
                         "completed": sum(h.replica == r.name
                                          for h in handles),
                         "thread": r.thread_ident}
                for r in fe.replicas}
        report = fe.serving_report()
    for rep in reps.values():
        rep["kernels"] = _thread_counts(rep.pop("thread"))
    return outs, reps, report


def _near_tie_check(name, got, want, gpu_model, cpu_model):
    """Requests of ``got`` equal to ``want``, or differing first at an
    explained near tie (``explain_divergences``); raises otherwise."""
    import numpy as np

    same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
    div = (explain_divergences(gpu_model, cpu_model, got, want, None)
           if not all(same) else [])
    ok = [s or any(d["request"] == i and d["explained"] for d in div)
          for i, s in enumerate(same)]
    if not all(ok):
        raise AssertionError(
            f"frontend_equal {name}: tokens differ beyond near ties {div}: "
            + json.dumps([[g.tolist(), w.tolist()]
                          for g, w, s in zip(got, want, ok) if not s]))
    return {"identical": same, "divergences": div}


def fe_cold_build(load, gpu_model, cpu_model, want, build_s):
    """A frontend whose replicas build both paged libraries themselves:
    the build directory is a fresh, empty one, so each replica's first
    dispatch waits for `nvcc` under `_COMPILE_LOCK`, one library after the
    other. The heartbeat deadline is 1.5x the longer build (``build_s``:
    each library's seconds in the build phase; where that phase found a
    library built already, both are built once more to time them): every
    single hold of the lock stays younger than the deadline while a
    replica's beat goes stale past it (the two builds' sum), so the
    monitor must spare the replicas through its lock probe (the frontend's
    default misses and a 1 s check), kill none, and the requests complete
    with (a)'s tokens."""
    import tempfile
    from pathlib import Path

    from paddle_tpu_torch.observability import compilemem
    from paddle_tpu_torch.ops import _build

    libs = ("ragged_paged_attention", "paged_attention")
    old_dir = _build.BUILD_DIR
    try:
        if not all(build_s.get(n) for n in libs):
            _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="build_probe_"))
            build_s = {n: b["seconds"] for n, b in _build.build(libs).items()}
        _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="build_cold_"))
        for n in libs:
            _build._LIBS.pop(n, None)
        deadline = 1.5 * max(build_s[n] for n in libs)
        dead0 = _serving_counter("serving.replica_dead")
        spared0 = _serving_counter("serving.replica_spared")
        builds0 = {n: compilemem.ledger.report()["by_key"].get(
            f"build.{n}", {}).get("count", 0) for n in libs}
        t0 = time.perf_counter()
        outs, reps, _ = fe_run(fe_engines(gpu_model, "cuda"), load,
                               timeout=600, heartbeat_deadline_s=deadline,
                               monitor_interval_s=1.0)
        wall = time.perf_counter() - t0
    finally:
        _build.BUILD_DIR = old_dir
    builds = {n: compilemem.ledger.report()["by_key"][f"build.{n}"]
              ["count"] - builds0[n] for n in libs}
    row = {"run": "cold_build",
           "build_phase_s": {n: build_s[n] for n in libs},
           "heartbeat_deadline_s": deadline, "wall_s": wall,
           "builds": builds,
           "replicas_dead": _serving_counter("serving.replica_dead") - dead0,
           "stale_checks_spared":
               _serving_counter("serving.replica_spared") - spared0,
           "replicas": reps,
           **_near_tie_check("cold_build", outs, want, gpu_model, cpu_model)}
    if row["replicas_dead"] or any(b != 1 for b in builds.values()):
        raise AssertionError(f"frontend_equal cold_build: {row}")
    if not row["stale_checks_spared"]:
        raise AssertionError(
            "frontend_equal cold_build: no stale heartbeat was spared, so "
            f"the run did not exercise the lock probe: {row}")
    return row


def phase_frontend_equal(build_s, seed=3):
    """f32, LLaMA-2-7B widths, 2 layers, serve_equal's seed: the port's
    ServingFrontend on the card against the same frontend on the CPU.
    (a) blended over 2 ragged engines (async, prefill_chunk 64), 8
    requests (4 interactive of 8-24 tokens, 4 batch of 100-300) of 16 new
    tokens: equal to the CPU frontend's and to each device's single-engine
    serve; each replica completes a request and launches K4 and K5. (b)
    roles prefill/decode over the spool transport and over the wire: (a)'s
    tokens, handoffs published == adopted > 0, none corrupt or stale. (c)
    serving.replica_kill armed once mid-stream: (a)'s tokens, >= 1
    reroute. (d) a queue bound of 2: the excess submits get Overloaded,
    the admitted requests (a)'s tokens. (e) ``fe_cold_build``. The CPU
    side of (a) runs on a thread of its own during (e), whose replicas
    mostly wait for `nvcc` (after (c), whose chaos plan is process-wide),
    with two cores left to the builds. Every comparison passes a
    differing request only at an explained near tie: the schedule decides
    who shares a batch."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.serving import (
        HandoffManager, Overloaded, SLOScheduler, make_transport,
    )
    from paddle_tpu_torch.testing import chaos

    cfg = llama2_7b()
    cfg.num_hidden_layers = 2
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    load = fe_load(seed, cfg.vocab_size)
    prompts = [p for p, _ in load]
    rows = []

    # (a) blended on the card, and the card's single-engine serve; the CPU
    # side comes after (d)
    _reset_counts()
    t0 = time.perf_counter()
    card, reps, report = fe_run(fe_engines(gpu_model, "cuda"), load)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card_serve = fe_engines(gpu_model, "cuda", n=1)[0].serve(prompts,
                                                             FE_NEW)
    blended = {"phase": "frontend_equal", "run": "blended", "layers": 2,
               "dtype": "float32",
               "prompt_lens": [len(p) for p in prompts],
               "classes": [c for _, c in load], "new_tokens": FE_NEW,
               "card_s": card_s, "replicas": reps,
               "vs_card_serve": _near_tie_check(
                   "blended vs card serve", card, card_serve, gpu_model,
                   cpu_model),
               "report_keys": sorted(report),
               "counters": report["counters"]}
    for name, rep in reps.items():
        k = rep["kernels"]
        if (rep["completed"] < 1 or k["ragged_paged_attention"] < 1
                or k["paged_decode_attention"] < 1):
            raise AssertionError(f"frontend_equal blended: replica {name} "
                                 f"completed or launched nothing: {reps}")

    # (b) role split over the spool and the wire
    for kind in ("spool", "wire"):
        h0 = _handoff_counts()
        tr = (HandoffManager(spool_dir=tempfile.mkdtemp(prefix="handoff_"))
              if kind == "spool" else make_transport("wire"))
        # decode_block 4: a request's first readback leaves it tokens to
        # hand off (with 8, async decode finishes 16 on the prefill side)
        outs, reps_b, _ = fe_run(
            fe_engines(gpu_model, "cuda", decode_block=4), load,
            roles=["prefill", "decode"], handoff=tr)
        h = {k: v - h0[k] for k, v in _handoff_counts().items()}
        row = {"phase": "frontend_equal", "run": f"roles_{kind}",
               "handoff": h, "replicas": reps_b,
               **_near_tie_check(f"roles_{kind}", outs, card, gpu_model,
                                 cpu_model)}
        emit(row)
        rows.append(row)
        if not (h["published"] == h["adopted"] > 0
                and h["corrupt"] == h["stale"] == 0):
            raise AssertionError(f"frontend_equal roles_{kind}: {h}")

    # (c) a replica killed mid-stream
    rerouted0 = _serving_counter("serving.rerouted")
    dead0 = _serving_counter("serving.replica_dead")
    plan = chaos.FaultPlan().fail("serving.replica_kill", after=4, times=1)
    try:
        outs, reps_c, _ = fe_run(fe_engines(gpu_model, "cuda"), load,
                                 before_start=lambda fe: chaos.arm(plan))
    finally:
        chaos.disarm()
    row = {"phase": "frontend_equal", "run": "replica_kill",
           "rerouted": _serving_counter("serving.rerouted") - rerouted0,
           "replicas_dead": _serving_counter("serving.replica_dead") - dead0,
           "fired": plan.rules[0].fired, "replicas": reps_c,
           **_near_tie_check("replica_kill", outs, card, gpu_model,
                             cpu_model)}
    emit(row)
    rows.append(row)
    if row["rerouted"] < 1 or row["replicas_dead"] != 1:
        raise AssertionError(f"frontend_equal replica_kill: {row}")

    # (d) overload: a queue bound of 2, submitted before the dispatchers
    # start, so the bound is met deterministically
    from paddle_tpu_torch.serving import ServingFrontend

    shed, admitted = [], []
    with ServingFrontend(fe_engines(gpu_model, "cuda"),
                         scheduler=SLOScheduler(max_queue_depth=2),
                         heartbeat_deadline_s=120.0, start=False) as fe:
        for i, (p, slo) in enumerate(load):
            try:
                admitted.append((i, fe.submit(p, FE_NEW, slo_class=slo)))
            except Overloaded as e:
                shed.append({"request": i, "slo_class": e.slo_class,
                             "step": e.step,
                             "retry_after_s": e.retry_after_s})
        fe.start()
        outs = [h.result(timeout=60) for _, h in admitted]
    row = {"phase": "frontend_equal", "run": "overload",
           "admitted": [i for i, _ in admitted], "shed": shed,
           **_near_tie_check("overload", outs, [card[i] for i, _ in admitted],
                             gpu_model, cpu_model)}
    emit(row)
    rows.append(row)
    if len(admitted) != 2 or len(shed) != len(load) - 2:
        raise AssertionError(f"frontend_equal overload: {row}")

    # (a)'s CPU side, the CPU frontend and the CPU single-engine serve, on
    # a thread of its own while (e)'s replicas build their kernels
    cpu = {}

    def cpu_side():
        try:
            t0 = time.perf_counter()
            cpu["frontend"], _, _ = fe_run(fe_engines(cpu_model, "cpu"),
                                           load, timeout=600)
            cpu["frontend_s"] = time.perf_counter() - t0
            cpu["serve"] = fe_engines(cpu_model, "cpu", n=1)[0].serve(
                prompts, FE_NEW)
        except Exception as e:  # noqa: BLE001 - raised below
            cpu["error"] = e

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 2))
    worker = threading.Thread(target=cpu_side, name="frontend-equal-cpu")
    worker.start()
    try:
        # (e) replicas that build their kernels themselves
        cold = fe_cold_build(load, gpu_model, cpu_model, card, build_s)
    finally:
        worker.join(900)
        torch.set_num_threads(threads)
    if worker.is_alive() or "error" in cpu:
        raise AssertionError(f"frontend_equal: the CPU side failed: "
                             f"{cpu.get('error', 'still running')}")
    blended.update(
        cpu_s=cpu["frontend_s"],
        vs_cpu_frontend=_near_tie_check(
            "blended vs CPU frontend", card, cpu["frontend"], gpu_model,
            cpu_model),
        cpu_frontend_vs_cpu_serve=_near_tie_check(
            "CPU frontend vs CPU serve", cpu["frontend"], cpu["serve"],
            gpu_model, cpu_model))
    emit(blended)
    rows.insert(0, blended)
    row = {"phase": "frontend_equal", **cold}
    emit(row)
    rows.append(row)
    del gpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return rows


#: bench_serving.py's TPU serving configuration (:524-527), at LLaMA-2-7B
ONLINE = dict(max_seqs=4, page_size=64, max_len=2048, decode_block=32,
              prefill_chunk=512, n_replicas=2, n_batch=4, n_interactive=12,
              n_probe=6, long_lo=1024, long_hi=1536, batch_new=64,
              inter_new=32)


def _percentile(xs, q):
    """bench_serving.py's nearest-rank percentile."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]


def online_load(rng, vocab, knobs=ONLINE):
    """bench_serving.py's ``_mixed_load``: ``n_batch`` long `batch` prompts
    and ``n_interactive`` short `interactive` ones, interleaved."""
    reqs = [(rng.randint(1, vocab, (int(rng.randint(
        knobs["long_lo"], knobs["long_hi"])),)).astype("int32"),
        knobs["batch_new"], "batch") for _ in range(knobs["n_batch"])]
    inter = [(rng.randint(1, vocab, (int(rng.randint(8, 24)),))
              .astype("int32"), knobs["inter_new"], "interactive")
             for _ in range(knobs["n_interactive"])]
    out, bi, ii = [], 0, 0
    while bi < len(reqs) or ii < len(inter):
        if bi < len(reqs):
            out.append(reqs[bi])
            bi += 1
        for _ in range(max(1, len(inter) // max(1, len(reqs)))):
            if ii < len(inter):
                out.append(inter[ii])
                ii += 1
    return out


def online_engines(model, mode, n, knobs=ONLINE):
    """bench_serving.py's ``_make_engines``: `baseline` is sync decode,
    monolithic prefill, the legacy ladder (ragged=False) and one dispatch
    lock shared by the replicas; `pipelined` the defaults (ragged, async,
    chunked prefill, a lock per engine)."""
    from paddle_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine, _StampedRLock,
    )

    kw = dict(max_seqs=knobs["max_seqs"], page_size=knobs["page_size"],
              max_len=knobs["max_len"], decode_block=knobs["decode_block"],
              device="cuda")
    if mode == "baseline":
        shared = _StampedRLock()
        return [ContinuousBatchingEngine(
            model, async_decode=False, prefill_chunk=None,
            dispatch_lock=shared, ragged=False, **kw) for _ in range(n)]
    return [ContinuousBatchingEngine(
        model, async_decode=True, prefill_chunk=knobs["prefill_chunk"], **kw)
        for _ in range(n)]


def online_run(fe, requests):
    """bench_serving.py's ``_run_load``: submit open loop, join in order;
    latency from the engine's own stamps. (records, wall)."""
    records = []
    t0 = time.monotonic()
    handles = [(fe.submit(p, n, slo_class=slo), p, slo)
               for p, n, slo in requests]
    for h, prompt, slo in handles:
        rec = {"slo": slo, "n": 0, "ttft": None, "tpot": None,
               "error": None}
        try:
            out = h.result(timeout=600)
            req = h._req
            rec["n"] = len(out) - len(prompt)
            rec["ttft"] = req.t_first_token - req.t_enqueue
            if rec["n"] > 1:
                rec["tpot"] = ((req.t_done - req.t_first_token)
                               / (rec["n"] - 1))
        except Exception as e:  # noqa: BLE001 - a failure is data here
            rec["error"] = f"{type(e).__name__}: {e}"
        records.append(rec)
    return records, time.monotonic() - t0


def online_summary(records, wall):
    """bench_serving.py's ``_summarize``."""
    ttft = [r["ttft"] for r in records if r["ttft"] is not None]
    inter = [r["ttft"] for r in records
             if r["ttft"] is not None and r["slo"] == "interactive"]
    tpot = [r["tpot"] for r in records if r["tpot"] is not None]
    tokens = sum(r["n"] for r in records)
    return {"tokens": tokens, "tokens_per_sec": tokens / max(wall, 1e-9),
            "wall_s": wall, "ttft_p50_s": _percentile(ttft, 0.5),
            "ttft_p99_s": _percentile(ttft, 0.99),
            "ttft_interactive_p50_s": _percentile(inter, 0.5),
            "tpot_p50_s": _percentile(tpot, 0.5),
            "errors": sum(1 for r in records if r["error"]),
            "error_messages": [r["error"] for r in records if r["error"]]}


def online_mode(model, mode, seed, knobs=ONLINE):
    """One configuration: warmed engines under the mixed load over two
    replicas (the launches and peak memory of that run, and the frontend's
    goodput, devprof and memory blocks), then the TTFT-under-prefill probe
    on the first of them: a long prompt alone, the shorts submitted once
    its prefill has been admitted. The pipelined mode's engines then run
    the role-split block (``online_roles``)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import ServingFrontend

    vocab = model.config.vocab_size
    rng = np.random.RandomState(seed)
    load = online_load(rng, vocab, knobs)
    long_p = rng.randint(1, vocab, (knobs["long_hi"],)).astype(np.int32)
    shorts = [(rng.randint(1, vocab, (int(rng.randint(8, 24)),))
               .astype(np.int32), knobs["inter_new"], "interactive")
              for _ in range(knobs["n_probe"])]
    gc.collect()
    engines = online_engines(model, mode, knobs["n_replicas"], knobs)
    t0 = time.perf_counter()
    for e in engines:
        e.warmup(buckets=sorted({len(p) for p, _, _ in load}
                                | {len(long_p)}
                                | {len(p) for p, _, _ in shorts}))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with ServingFrontend(engines, heartbeat_deadline_s=600.0) as fe:
        records, wall = online_run(fe, load)
        torch.cuda.synchronize()
        counts = _counts()
        per_replica = {r.name: _thread_counts(r.thread_ident)
                       for r in fe.replicas}
        report = fe.serving_report()
    del fe
    row = {"phase": "slice_online", "mode": mode,
           "requests": len(load), "warmup_s": warmup_s,
           **online_summary(records, wall), "kernels": counts,
           "replica_kernels": per_replica,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_steps": [e.stats["decode_steps"] for e in engines],
           "goodput": report["goodput"], "devprof": report["devprof"],
           "memory": {k: v for k, v in report["memory"].items()
                      if k != "programs"},
           "cost_rows": report["memory"]["programs"],
           "compile_events": report["compile"]["events"]}
    # the TTFT-under-prefill probe, one replica
    with ServingFrontend(engines[:1], heartbeat_deadline_s=600.0) as fe:
        h_long = fe.submit(long_p, knobs["batch_new"], slo_class="batch")
        t1 = time.monotonic()
        while (any(r.pending for r in fe.replicas)
               and time.monotonic() - t1 < 10):
            time.sleep(0.0005)
        recs, _ = online_run(fe, shorts)
        h_long.result(timeout=600)
    del fe
    ttfts = [r["ttft"] for r in recs if r["ttft"] is not None]
    row["ttft_under_prefill_p50_s"] = _percentile(ttfts, 0.5)
    row["probe_errors"] = sum(1 for r in recs if r["error"])
    roles = online_roles(engines, seed, knobs) if mode == "pipelined" else None
    engines.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return row, roles


def online_roles(engines, seed, knobs=ONLINE):
    """bench_serving.py's role-split block (:326-370) on the pipelined
    engines: 4 interactive prompts, generations long enough to outlive
    the first decode blocks, through one prefill and one decode replica;
    the handoff counters."""
    import numpy as np

    from paddle_tpu_torch.serving import ServingFrontend

    rng = np.random.RandomState(seed + 29)
    vocab = engines[0].model.config.vocab_size
    new = max(knobs["inter_new"], 4 * knobs["decode_block"] + 2)
    shorts = [(rng.randint(1, vocab, (int(rng.randint(8, 24)),))
               .astype(np.int32), new, "interactive") for _ in range(4)]
    h0 = _handoff_counts()
    with ServingFrontend(engines, roles=["prefill", "decode"],
                         heartbeat_deadline_s=600.0) as fe:
        records, wall = online_run(fe, shorts)
    ttfts = [r["ttft"] for r in records if r["ttft"] is not None]
    return {"phase": "slice_online", "mode": "roles",
            "tokens": sum(r["n"] for r in records),
            "errors": sum(1 for r in records if r["error"]),
            "error_messages": [r["error"] for r in records if r["error"]],
            "wall_s": wall, "ttft_p50_s": _percentile(ttfts, 0.5),
            "handoff": {k: v - h0[k] for k, v in _handoff_counts().items()}}


def phase_slice_online(model, seed=0):
    """LLaMA-2-7B bf16, 32 layers (nothing cut), served online through
    the port's ServingFrontend at bench_serving.py's TPU load shape: 2
    replicas sharing the model (max_seqs 4, page_size 64, max_len 2048,
    decode_block 32, prefill_chunk 512), 4 batch prompts of 1024-1536
    tokens with 64 new and 12 interactive of 8-24 with 32 new,
    interleaved, once in each mode (`baseline`, `pipelined`), each with
    its TTFT-under-prefill probe on the mode's first engine; then the
    role-split block on the pipelined engines. Telemetry is on throughout
    (spans, request traces, goodput, devprof at its default cadence), for
    both modes alike. No limit: bring-up."""
    from paddle_tpu_torch.observability import devprof, tracing

    tracing.enable()
    devprof.enable()
    try:
        rows = {}
        rows["baseline"], _ = online_mode(model, "baseline", seed)
        rows["pipelined"], rows["roles"] = online_mode(model, "pipelined",
                                                       seed)
    finally:
        devprof.disable()
        tracing.disable()
    for r in rows.values():
        emit(r)
    base, pipe = rows["baseline"], rows["pipelined"]
    ratio = pipe["tokens_per_sec"] / max(base["tokens_per_sec"], 1e-9)
    emit({"phase": "slice_online", "pipelined_vs_baseline": ratio})
    errors = [(m, r.get("error_messages")) for m, r in rows.items()
              if r["errors"] or r.get("probe_errors")]
    if errors:
        raise AssertionError(f"slice_online: requests failed: {errors}")
    k = base["kernels"]
    if not (k["paged_decode_attention"] > 0
            and k["ragged_paged_attention"] == 0):
        raise AssertionError(f"slice_online baseline launches: {k}")
    k = pipe["kernels"]
    if not (k["paged_decode_attention"] > 0
            and k["ragged_paged_attention"] > 0):
        raise AssertionError(f"slice_online pipelined launches: {k}")
    h = rows["roles"]["handoff"]
    if not (h["published"] == h["adopted"] > 0
            and h["corrupt"] == h["stale"] == 0):
        raise AssertionError(f"slice_online roles handoff: {h}")
    rows["ratio"] = ratio
    return rows


def kernel_table(rows):
    """The contract's kernel line, from the phases that ran: every entry's
    launches over the main path (serving's `slice`, `slice_int8` for the
    int8 variants, training's `train`, `train_packed` for K3, `train_cp`
    for K6)."""
    table = []
    for name, phase, src, ref, main_phase in (
            ("ragged_paged_attention", "k4",
             "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/ragged_paged_attention.py:258", "slice"),
            ("paged_decode_attention", "k5",
             "paddle_tpu_torch/ops/csrc/paged_common.cuh",
             "paddle_tpu/ops/paged_attention.py:155", "slice"),
            ("ragged_paged_attention_int8", "k4_int8",
             "paddle_tpu_torch/ops/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/ragged_paged_attention.py:258 (int8 pool, "
             "dequantized at :228-230)", "slice_int8"),
            ("paged_decode_attention_int8", "k5_int8",
             "paddle_tpu_torch/ops/csrc/paged_common.cuh",
             "paddle_tpu/ops/paged_attention.py:155 (int8 pool, q bf16 at "
             ":175)", "slice_int8")):
        if phase not in rows:
            continue
        # MHA with a bf16 q: the shapes LLaMA-2-7B gives it
        main_row = rows[phase][0]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": ref,
                      "launches": rows.get(main_phase, {}).get(
                          "kernels", {}).get(name),
                      "max_abs_err": max(r["max_abs_err"]
                                         for r in rows[phase]),
                      "ms": main_row["kernel_ms"],
                      "plain_ms": main_row["plain_ms"],
                      "bound_ms": main_row["bound_ms"],
                      "bound_by": main_row["bound_by"],
                      "library_ms": None,
                      "device_ms": main_row["device_ms"],
                      "gqa_device_ms": next(
                          r["device_ms"] for r in rows[phase]
                          if r["hkv"] != HQ and r["dtype"] == main_row[
                              "dtype"]),
                      # f32 q (over f32 pools for K4 and K5)
                      "f32_device_ms": [
                          r["device_ms"] for r in rows[phase]
                          if r["dtype"] == "torch.float32"],
                      # the legacy ladder (K5 alone), warmup and LoRA
                      "slice_surface_launches": {
                          r["run"]: r["kernels"][name]
                          for r in rows.get("slice_surface", [])},
                      # the online serve's two modes, through the frontend
                      "slice_online_launches": {
                          m: rows["slice_online"][m]["kernels"][name]
                          for m in ("baseline", "pipelined")
                          if "slice_online" in rows}})
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
        if entry != "fwd":
            # F.sdpa computes no entry of the backward alone: its whole
            # backward beside the kernels' (delta, dK/dV, dQ)
            row["bwd_ms"] = main_row["kernel_ms"]["bwd"]
            row["library_bwd_ms"] = main_row["library_ms"]["bwd"]
        if entry != "fwd" and "train_cp" in rows:
            # the ring's backward runs these entries once per visit
            row["ring_launches"] = rows["train_cp"]["kernels"][name]
        table.append(row)
    # K3: the timed cases are packed MHA (the main path's shape), packed
    # GQA 64/8 and varlen
    timed = {(r["form"], r["hkv"]): r for r in rows.get("k3", [])
             if "kernel_ms" in r}
    for entry, keys in errs.items():
        if "k3" not in rows:
            break
        name = "flash_attention_seg_" + entry
        main_row = timed[("packed", HQ)]
        row = {"name": name, "route": "cuda",
               "source": "paddle_tpu_torch/ops/csrc/flash_attention_"
                         + ("fwd.cu" if entry == "fwd" else "bwd.cu"),
               "replaces": "paddle_tpu/ops/flash_attention.py:277 "
                           "(flash_attention_packed: splash with "
                           "SegmentIds)",
               "launches": rows.get("train_packed", {}).get(
                   "kernels", {}).get(name),
               "max_abs_err": max(r["max_abs_err"][k] for r in rows["k3"]
                                  for k in keys),
               "ms": main_row["kernel_ms"][entry],
               "plain_ms": main_row["plain_ms"][entry],
               "bound_ms": main_row["bounds"][entry]["bound_ms"],
               "bound_by": main_row["bounds"][entry]["bound_by"],
               "library_ms": (main_row["library_ms"]["fwd"]
                              if entry == "fwd" else None),
               "also_replaces": "paddle_tpu/ops/flash_attention.py:227 "
                                "(_splash_varlen)",
               "gqa_ms": timed[("packed", 8)]["kernel_ms"][entry],
               "varlen_ms": timed[("varlen", HQ)]["kernel_ms"][entry]}
        if entry == "fwd":
            row["k1_causal_fwd_ms"] = main_row["k1_causal_ms"]["fwd"]
        else:
            row["bwd_ms"] = main_row["kernel_ms"]["bwd"]
            row["library_bwd_ms"] = main_row["library_ms"]["bwd"]
        table.append(row)
    if "k6" in rows:
        # MHA 32/32, B 1, S 4 x 2048, causal, bf16: the whole sep-4 ring
        # forward (10 launches) against the bound of the function
        main_row = rows["k6"][0]
        table.append({
            "name": "flash_attention_ring_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "replaces": "paddle_tpu/ops/ring_attention.py:125",
            "launches": rows.get("train_cp", {}).get("kernels", {}).get(
                "flash_attention_ring_fwd"),
            "max_abs_err": max(max(r["max_abs_err"]["o"],
                                   r["max_abs_err"]["entry_o"])
                               for r in rows["k6"]),
            "ms": main_row["kernel_ms"]["fwd"],
            "plain_ms": main_row["plain_ms"]["fwd"],
            "bound_ms": main_row["bounds"]["fwd"]["bound_ms"],
            "bound_by": main_row["bounds"]["fwd"]["bound_by"],
            "library_ms": main_row["library_ms"]["fwd"],
            "ms_of": "the sep-4 ring's forward over S 8192 "
                     f"({main_row['launches_per_call']} launches)",
            "k1_whole_sequence_ms": main_row["k1_whole_ms"]["fwd"],
            "fwd_bwd_ms": main_row["kernel_ms"]["fwd_bwd"],
            "gqa_ms": rows["k6"][1]["kernel_ms"]["fwd"]})
    if "grad_norm" in rows:
        # the gradient list of 2 layers at 7B widths plus embedding and
        # head, bf16, no scale
        main_row = rows["grad_norm"][0]
        table.append({
            "name": "grad_sumsq", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/grad_norm.cu",
            "replaces": "paddle_tpu/jit_api.py:328 (unscale, finite check "
                        "and nn/clip.py:55 global norm, XLA-fused in the "
                        "compiled step; no Pallas kernel)",
            "launches": rows.get("train_recipe", {}).get("kernels", {}).get(
                "grad_sumsq"),
            "max_abs_err": main_row["max_abs_err"],
            "max_rel_err": main_row["max_rel_err"],
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library": main_row["library"]})
    if "wo_linear" in rows:
        # LLaMA-2-7B's gate/up projection (4096 -> 11008), int8 codes, B 8
        # decode rows of bf16 x; int4 and the other shapes beside
        timed = {(r["projection"], r["weight"], r["rows"]): r
                 for r in rows["wo_linear"] if "kernel_ms" in r}
        main_row = timed[WO_MAIN]
        table.append({
            "name": "weight_only_linear", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/weight_only_linear.cu",
            "replaces": "paddle_tpu/nn/quant/__init__.py:70 "
                        "(weight_only_linear: XLA fuses the dequantization "
                        "into the product; no Pallas kernel)",
            "launches": rows.get("generate", {}).get("int8", {}).get(
                "kernels", {}).get("weight_only_linear"),
            "int4_launches": rows.get("generate", {}).get("int4", {}).get(
                "kernels", {}).get("weight_only_linear"),
            "max_abs_err": max(
                max(r["max_abs_err"] for r in rows["wo_linear"]),
                rows["wo_linear"][0]["edge_max_abs_err"]),
            "ms": main_row["kernel_ms"], "device_ms": main_row["device_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "library": "none: no PyTorch call takes int8 or packed int4 "
                       "codes with per-channel scales",
            "bf16_matmul_ms": main_row["bf16_matmul_ms"],
            "bf16_matmul_device_ms": main_row["bf16_matmul_device_ms"],
            "device_ms_clean": main_row["device_ms_clean"],
            "bf16_matmul_device_ms_clean":
                main_row["bf16_matmul_device_ms_clean"],
            "ms_of": "x [8, 4096] bf16 @ int8 [11008, 4096]",
            "device_ms_by_shape": {
                f"{p} {w} rows {n}": r["device_ms"]
                for (p, w, n), r in sorted(timed.items())}})
    if "moe_dispatch" in rows:
        # Mixtral's training shape as moe_train's gate gives it, bf16
        main_row = rows["moe_dispatch"][0]
        shape = ", ".join(f"{k} {main_row[k]}" for k in "TMEkC")
        launches = rows.get("moe_train", {}).get("kernels", {})
        site = "paddle_tpu/incubate/distributed/models/moe/moe_layer.py"
        for name, entry, bwd, keys, ref in (
                ("moe_dispatch", "dispatch", "dispatch_scaled",
                 ("dispatched", "d_expert_out"),
                 f"{site}:149 (einsum 'tec,tm->ecm' over the dense dispatch, "
                 "XLA; no Pallas kernel)"),
                ("moe_combine", "combine", "combine_unit",
                 ("out", "d_tokens"),
                 f"{site}:163 (einsum 'tec,ecm->tm' over the dense combine, "
                 "XLA; no Pallas kernel)"),
                ("moe_combine_dw", "combine_dw", None, ("d_weight",),
                 f"{site}:163 (the combine einsum's gradient to the gate "
                 "values, XLA; no Pallas kernel)")):
            t = main_row["timing"][entry]
            row = {"name": name, "route": "cuda",
                   "source": "paddle_tpu_torch/ops/csrc/moe_dispatch.cu",
                   "replaces": ref, "launches": launches.get(name),
                   "max_abs_err": max(r["max_abs_err"][k]
                                      for r in rows["moe_dispatch"]
                                      if "max_abs_err" in r for k in keys),
                   "ms": t["kernel_ms"], "device_ms": t["device_ms"],
                   "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"],
                   "library_ms": t["library_ms"],
                   "library": main_row["library"],
                   "ms_of": f"{shape}, bf16"}
            if bwd is not None:
                b = main_row["timing"][bwd]
                row.update(bwd_ms=b["kernel_ms"], bwd_device_ms=b["device_ms"],
                           bwd_bound_ms=b["bound_ms"],
                           bwd_library_ms=b["library_ms"],
                           bwd_of=("the combine's gradient to the expert "
                                   "outputs" if bwd == "dispatch_scaled"
                                   else "the dispatch's gradient to the "
                                   "tokens"))
            if entry == "dispatch":
                row["index_select_ms"] = t["index_select_ms"]
            table.append(row)
    if "adamw" in rows:
        main_row = next(r for r in rows["adamw"]
                        if r.get("instance") == "master")
        table.append({
            "name": "adamw_update_master", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/adamw.cu",
            "replaces": "paddle_tpu/optimizer/optimizer.py:161 (AdamW on "
                        "f32 master weights with the step's unscale and "
                        "clip, XLA-fused; no Pallas kernel)",
            "launches": rows.get("train_recipe", {}).get("kernels", {}).get(
                "adamw_update"),
            "max_abs_err": main_row["max_abs_err"],
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library": main_row["library"],
            "ms_with_dynamics": main_row["kernel_ms_with_dynamics"]})
    if "adamw" in rows:
        main_row = rows["adamw"][0]    # bf16, as the 7B step runs it
        table.append({
            "name": "adamw_update", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/adamw.cu",
            "replaces": "paddle_tpu/optimizer/optimizers.py:51 (XLA-fused "
                        "in the compiled step; no Pallas kernel)",
            "launches": rows.get("train", {}).get("kernels", {}).get(
                "adamw_update"),
            "max_abs_err": max(r["max_abs_err"] for r in rows["adamw"]
                               if "instance" not in r),
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
    if runs("k3"):
        rows["k3"] = phase_k3(seed=PACKING_SEED)
    if runs("k6"):
        rows["k6"] = phase_k6()
    if runs("adamw"):
        rows["adamw"] = phase_adamw()
    if runs("grad_norm"):
        rows["grad_norm"] = phase_grad_norm()
    if runs("wo_linear"):
        rows["wo_linear"] = phase_wo_linear()
    if runs("moe_dispatch"):
        rows["moe_dispatch"] = phase_moe_dispatch()
    if runs("codec"):
        phase_codec()
    if runs("k4"):
        rows["k4"] = phase_k4()
    if runs("k5"):
        rows["k5"] = phase_k5()
    if runs("k4_int8"):
        rows["k4_int8"] = phase_k4(quant=True)
    if runs("k5_int8"):
        rows["k5_int8"] = phase_k5(quant=True)
    if runs("serve_equal"):
        phase_serve_equal()
    if runs("serve_surface_equal"):
        rows["serve_surface_equal"] = phase_serve_surface_equal()
    if runs("frontend_equal"):
        rows["frontend_equal"] = phase_frontend_equal(
            {n: b["seconds"] for n, b in built.items()})
    serving = [p for p in ("slice", "profile", "slice_int8",
                           "slice_sampled_prefix", "slice_surface",
                           "slice_online") if runs(p)]
    if serving:
        from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b

        cfg = llama2_7b(dtype="bfloat16")
        cfg.num_hidden_layers = SLICE_LAYERS
        model = LlamaForCausalLM(cfg, device="cuda", seed=0)
        ref = None
        if runs("slice") or runs("profile") or runs("slice_surface"):
            # slice_surface continues slice's model and outputs
            rows["slice"], eng, prompts, out = phase_slice(model)
            ref = (rows["slice"], out)
            if runs("profile"):
                phase_profile(eng, prompts)
            del eng
        if runs("slice_int8"):
            rows["slice_int8"], eng, _, _ = phase_slice(
                model, kv_cache_dtype="int8", reference=ref)
            del eng
        if runs("slice_sampled_prefix"):
            rows["slice_sampled_prefix"] = phase_slice_sampled_prefix(model)
        if runs("slice_surface"):
            rows["slice_surface"] = phase_slice_surface(model, ref)
        if runs("slice_online"):
            # the whole depth: slice_online serves LLaMA-2-7B uncut
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = LlamaForCausalLM(llama2_7b(dtype="bfloat16"),
                                     device="cuda", seed=0)
            rows["slice_online"] = phase_slice_online(model)
        # free the serving model and engines before training; cuBLAS
        # keeps a workspace for each (thread handle, stream) it ran on,
        # in the caching allocator (every engine runs on a stream of its
        # own, from a dispatcher thread): a cache, cleared like the
        # allocator's own
        del model
        gc.collect()
        cached = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        emit({"phase": "free_serving", "allocated_gb": held / 1e9,
              "cublas_workspaces_gb": (cached - held) / 1e9})
        if held >= 1e9:
            blocks = sorted(
                ((b["size"], seg["stream"]) for seg in
                 torch.cuda.memory_snapshot() for b in seg["blocks"]
                 if b["state"] == "active_allocated"), reverse=True)[:20]
            raise AssertionError(f"serving left {held / 1e9:.2f} GB "
                                 f"allocated; largest blocks {blocks}")
    if runs("generate_equal"):
        rows["generate_equal"] = phase_generate_equal()
    if runs("generate"):
        rows["generate"] = phase_generate()
    if runs("train_equal"):
        phase_train_equal()
    if runs("train_packed_equal"):
        phase_train_packed_equal()
    if runs("train_equal_s1024"):
        phase_train_equal_s1024()
    if runs("train_cp_equal"):
        phase_train_cp_equal()
    if runs("train_recipe_equal"):
        rows["train_recipe_equal"] = phase_train_recipe_equal()
    if runs("moe_equal"):
        rows["moe_equal"] = phase_moe_equal()
    if runs("train") or runs("train_packed") or runs("train_cp"):
        rows["train"], model, step, batches = phase_train()
        if runs("train_profile"):
            phase_train_profile(step, batches)
        if runs("train_packed"):
            rows["train_packed"] = phase_train_packed(model, step,
                                                      rows["train"])
        if runs("train_cp"):
            rows["train_cp"] = phase_train_cp(model, step, rows["train"])
        del model, step, batches
        gc.collect()
        torch.cuda.empty_cache()
    if runs("train_gqa"):
        rows["train_gqa"] = phase_train_gqa()
    if runs("train_recipe"):
        rows["train_recipe"], rows["train_recipe_plain"] = \
            phase_train_recipe()
    if runs("moe_train") or runs("moe_generate"):
        gc.collect()
        torch.cuda.empty_cache()
        rows["moe_train"], model = phase_moe_train()
        if runs("moe_generate"):
            rows["moe_generate"] = phase_moe_generate(model)
        del model

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
