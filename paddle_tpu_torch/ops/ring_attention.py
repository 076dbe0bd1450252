"""Ring attention and Ulysses attention over the sep axis (counterpart of
``paddle_tpu/ops/ring_attention.py``; K6).

The reference runs inside ``shard_map``: each device of the sep ring holds
its query shard, and the KV shards walk the ring by ``lax.ppermute`` while
every device merges one visiting shard per step into its online-softmax
state. The port keeps that single-controller model in one process: the
mesh (``distributed.mesh``) lists the ring's devices, the ranks' shards are
stacked on a leading rank dimension ``[n, ...]`` (shard r on the mesh's
device r), each step runs every rank's visit, and the KV rotation is one
function, ``_ring_shift``, the counterpart of ``lax.ppermute(back_perm)``.
Over a mesh that names one device n times it rotates the list of shards;
it is the one place a ring over separate cards replaces.

Causal masking is by global position: at step i rank ``my`` holds the
shard of ``src = (my + i) % n``; src < my is a full visit, src == my the
diagonal (local causal), src > my is skipped.

Two tiers, as in the reference:

- kernel (``_ring_kernel_fwd_impl``, ``RingFlashAttention``): each kept
  visit is one ``ring_flash_fwd`` (K6: the flash forward of the resident
  query shard over the visiting KV shard, merged into the rank's running
  (o, lse) state in the kernel's epilogue). The backward runs K1's
  hand-written backward entries per visit, given the merged output's delta
  and the merged lse, which add their gradients in their epilogue into f32
  sums: dQ on the resident rank, dK/dV beside their shard, travelling the
  ring with it back to its owner.
  Layout [n, B, S_local, H, D], the kernels' own. On a CPU tensor every
  kernel entry runs its plain version, so the tier's control flow runs
  there too.
- blockwise math (``_ring_block_impl``): the visiting shard consumed in
  ``block_k`` chunks with online softmax, through autograd; K6's plain
  version on the card. Layout [n, B, H, S_local, D].

``ring_attention`` keeps the reference's signature and [B, H, S_local, D]
shards (stacked: [n, B, H, S_local, D]); on a CUDA tensor it takes the
kernel tier, and a kernel that cannot launch raises: there is no fallback
to the math tier. ``ulysses_attention`` regroups heads and shards (the
all-to-all pair) and runs full-sequence attention per rank.
"""
import math

import torch

from ..distributed.mesh import get_mesh, has_mesh
from .flash_attention import (
    _attention_math, _causal_mask, flash_bwd_delta, flash_bwd_dkdv,
    flash_bwd_dq, ring_flash_fwd,
)

# which tier the last call took ("ring-kernel" | "ring-block"), as the
# reference records it
LAST_IMPL = None

# the port's own copy of the reference's flash block config
# (ops/flash_attention.py:_BLOCK_CONFIG); only block_k is read here
_BLOCK_CONFIG = {"block_q": None, "block_k": None}


def _pick_block_k(S, block_k=None):
    """The chunk of a visiting shard the math tier consumes at once: block_k
    (default 512) cut to S and halved until it divides S (reference :42)."""
    bk = min(block_k or _BLOCK_CONFIG["block_k"] or 512, S)
    while S % bk:
        bk //= 2
    return max(bk, 1)


def _ring_shift(shards):
    """The KV rotation, ``lax.ppermute(back_perm)`` of the reference: rank j
    sends its shard to rank j - 1, so rank j next holds rank j + 1's. Over
    a one-device mesh the shards stay where they are and the list
    rotates."""
    return shards[1:] + shards[:1]


def _visits(n, causal):
    """The ring's kept visits in order, one list per step i: (my, src,
    diag) with src = (my + i) % n; a causal ring skips src > my."""
    steps = []
    for i in range(n):
        keep = []
        for my in range(n):
            src = (my + i) % n
            if not causal or src <= my:
                keep.append((my, src, causal and src == my))
        steps.append(keep)
    return steps


def sep_ring(axis_name="sep", n=None, device=None):
    """The current mesh's ring over ``axis_name``: its size, checked
    against ``n`` shards on ``device`` when given. Raises without a mesh:
    ring and Ulysses attention run inside one, as the reference's run
    inside ``shard_map``."""
    if not has_mesh():
        raise ValueError(
            f"ring attention over {axis_name!r} needs a mesh: run it under "
            f"mesh_guard(build_mesh({axis_name}=n, devices=...))")
    mesh = get_mesh()
    size = mesh.shape.get(axis_name, 1)
    if n is not None and n != size:
        raise ValueError(f"{n} shards on a {axis_name} axis of {size}")
    if device is not None:
        for d in mesh.axis_devices(axis_name):
            if d != device:
                raise ValueError(
                    f"the shards lie on {device}, the mesh's {axis_name} "
                    f"axis on {d}")
    return size


# -- the blockwise math tier (K6's plain version) -----------------------------

def _ring_block_impl(q, k, v, causal, scale, block_k):
    """Blockwise-math ring (reference :62): q [n, B, H, S, D], k/v [n, B,
    Hkv, S, D] stacked rank shards (GQA: the ring carries the Hkv heads
    unexpanded), differentiable by autograd. Scores in f32 from the inputs
    as they are (the kernels' arithmetic), chunks of ``block_k`` keys, a
    running max that is detached (the online softmax does not depend on it,
    so no gradient flows through it, and autograd keeps nothing for it).
    Returns [n, B, H, S, D] in q's dtype."""
    n, B, H, S, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    bk = _pick_block_k(S, block_k)
    qg = [q[my].float().reshape(B, Hkv, G, S, D) for my in range(n)]
    state = [(q.new_zeros((B, Hkv, G, S, D), dtype=torch.float32),
              q.new_zeros((B, Hkv, G, S, 1), dtype=torch.float32),
              q.new_full((B, Hkv, G, S, 1), -1e30, dtype=torch.float32))
             for _ in range(n)]
    pos = torch.arange(S, device=q.device)
    kv = [(k[j], v[j]) for j in range(n)]
    for step in _visits(n, causal):
        for my, src, _ in step:
            o, l, m = state[my]
            k_cur, v_cur = (t.float() for t in kv[my])
            for j in range(S // bk):
                kb = k_cur[:, :, j * bk:(j + 1) * bk]
                vb = v_cur[:, :, j * bk:(j + 1) * bk]
                s = torch.einsum("bhgqd,bhkd->bhgqk", qg[my], kb) * scale
                if causal:
                    seen = (my * S + pos[:, None]
                            >= src * S + j * bk + pos[None, :bk])
                    s = s.masked_fill(~seen, -1e30)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True)).detach()
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                o = o * corr + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
                m = m_new
            state[my] = (o, l, m)
        kv = _ring_shift(kv)
    out = [(o / l.clamp_min(1e-30)).reshape(B, H, S, D) for o, l, _ in state]
    return torch.stack(out).to(q.dtype)


# -- the kernel tier ----------------------------------------------------------

def _ring_kernel_fwd_impl(q, k, v, causal, scale):
    """Kernel-tier forward (reference :125): q [n, B, S, Hq, D], k/v [n, B,
    S, Hkv, D] stacked rank shards, contiguous. Each kept visit is one
    ``ring_flash_fwd`` into its rank's state; a rank's first visit reads no
    state and its last writes the merged output in q's dtype. Returns (out
    [n, B, S, Hq, D], lse [n, B, Hq, S] f32, the merged log-sum-exp the
    backward needs)."""
    n, B, S, H, _ = q.shape
    steps = _visits(n, causal)
    kept = [[i for i, step in enumerate(steps)
             if any(my == r for my, _, _ in step)] for r in range(n)]
    out = torch.empty_like(q)
    lse = torch.empty((n, B, H, S), dtype=torch.float32, device=q.device)
    o_acc = [torch.empty(q.shape[1:], dtype=torch.float32, device=q.device)
             if len(kept[r]) > 1 else None for r in range(n)]
    kv = [(k[j], v[j]) for j in range(n)]
    for i, step in enumerate(steps):
        for my, _, diag in step:
            k_cur, v_cur = kv[my]
            ring_flash_fwd(q[my], k_cur, v_cur, o_acc[my], lse[my], diag,
                           scale, first=i == kept[my][0],
                           out=out[my] if i == kept[my][-1] else None)
        kv = _ring_shift(kv)
    return out, lse


def _visit_bwd_math(q, k, v, dout, lse, delta, causal, scale):
    """Plain version of one visit's backward given the ring's merged lse
    and delta (what K1's dK/dV and dQ entries compute from them): P =
    exp(scale q k^T - lse) under the visit's mask, dS = P (dO V^T - delta),
    dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO, KV heads summed over
    their group. Paddle layout in, (dq, dk, dv) f32 out."""
    qt, kt, vt, dot = (x.transpose(1, 2).float() for x in (q, k, v, dout))
    hkv, group = kt.shape[1], qt.shape[1] // kt.shape[1]
    if group > 1:
        kt = kt.repeat_interleave(group, dim=1)
        vt = vt.repeat_interleave(group, dim=1)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    mask = _causal_mask(q, k, causal)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(dot, vt.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kt) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qt) * scale
    dv = torch.matmul(p.transpose(-1, -2), dot)
    if group > 1:
        dk = dk.unflatten(1, (hkv, group)).sum(2)
        dv = dv.unflatten(1, (hkv, group)).sum(2)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _visit_bwd(q, k, v, dout, lse, delta, causal, scale, dq, dk, dv):
    """Add one visit's gradients into the ring's f32 sums ``dq``, ``dk``,
    ``dv``: K1's dK/dV and dQ kernels on a CUDA tensor (the bf16 kernels add
    in their epilogue), their plain version on a CPU tensor."""
    if q.device.type == "cpu":
        for acc, g in zip((dq, dk, dv), _visit_bwd_math(
                q, k, v, dout, lse, delta, causal, scale)):
            acc += g
        return
    flash_bwd_dkdv(q, k, v, dout, lse, delta, causal, scale, acc=(dk, dv))
    flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, acc=dq)


def _delta(out, dout):
    """delta = rowsum(dout * out) in f32, [B, Hq, S]: K1's delta kernel on
    a CUDA tensor."""
    if out.device.type == "cpu":
        return (out.float() * dout.float()).sum(-1).transpose(1, 2)
    return flash_bwd_delta(out, dout)


def _ring_kernel_bwd_impl(q, k, v, out, lse, dout, causal, scale):
    """The kernel tier's backward: per rank, delta from the merged output;
    per kept visit, the visit's gradients from the merged lse (the global
    softmax), added into f32 sums by the kernels themselves: dQ on the
    resident rank, dK/dV beside the visiting shard, which carries them round
    the ring back to its owner. Cast once at the end."""
    n = q.shape[0]
    delta = [_delta(out[my], dout[my]) for my in range(n)]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kv = [(k[j], v[j], dk[j], dv[j]) for j in range(n)]
    for step in _visits(n, causal):
        for my, _, diag in step:
            k_cur, v_cur, dk_cur, dv_cur = kv[my]
            _visit_bwd(q[my], k_cur, v_cur, dout[my], lse[my], delta[my],
                       diag, scale, dq[my], dk_cur, dv_cur)
        kv = _ring_shift(kv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingFlashAttention(torch.autograd.Function):
    """The kernel tier: ``apply(q, k, v, causal, scale)`` on stacked rank
    shards [n, B, S_local, H, D] (contiguous) -> [n, B, S_local, Hq, D].
    Forward: ``_ring_kernel_fwd_impl`` (K6 per visit); backward:
    ``_ring_kernel_bwd_impl`` (K1's backward entries per visit)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        out, lse = _ring_kernel_fwd_impl(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_kernel_bwd_impl(q, k, v, out, lse, dout.contiguous(),
                                      ctx.causal, ctx.scale)
        return (*grads, None, None)


def ring_flash_attention(q, k, v, causal=True, scale=None, axis_name="sep"):
    """The model's ring core: stacked rank shards [n, B, S_local, H, D] in
    the kernels' layout -> [n, B, S_local, Hq, D] through
    ``RingFlashAttention``, on the current mesh's ``axis_name`` ring."""
    sep_ring(axis_name, q.shape[0], q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return RingFlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, scale)


def ring_attention(q, k, v, axis_name="sep", causal=False, scale=None,
                   block_k=None, impl=None):
    """q/k/v: every sep rank's local shard [B, H, S_local, D], stacked [n,
    B, H, S_local, D] (the logical sequence is S_local x n, rank r holding
    positions r S_local ...); returns the stacked outputs in that layout.
    Runs under a mesh whose ``axis_name`` axis has n ranks.

    impl: None (the kernel tier on a CUDA tensor, the blockwise math tier
    on a CPU tensor), "kernel" or "block" (either tier on any device; the
    kernel tier on the CPU runs each kernel's plain version)."""
    global LAST_IMPL
    sep_ring(axis_name, q.shape[0], q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl not in (None, "kernel", "block"):
        raise ValueError(f"impl must be None, 'kernel' or 'block', got "
                         f"{impl!r}")
    if impl == "kernel" or (impl is None and q.device.type == "cuda"):
        LAST_IMPL = "ring-kernel"
        out = RingFlashAttention.apply(
            *(x.transpose(2, 3).contiguous() for x in (q, k, v)), causal,
            scale)
        return out.transpose(2, 3)
    LAST_IMPL = "ring-block"
    return _ring_block_impl(q, k, v, causal, scale, block_k)


def _to_heads(x, n):
    """The first all-to-all on one process: stacked sequence shards [n, B,
    S_local, H, D] -> stacked head groups [n, B, S, H / n, D] (rank r: heads
    r H/n ... of the whole sequence)."""
    _, B, s_loc, H, D = x.shape
    if H % n:
        raise ValueError(f"ulysses attention needs a head count divisible "
                         f"by the axis size {n}, got {H}")
    # contiguous: at B 1 the reshape is a strided view, and the kernels take
    # each rank's [B, S, H / n, D] whole (the all-to-all moves it anyway)
    return x.reshape(n, B, s_loc, n, H // n, D).permute(
        3, 1, 0, 2, 4, 5).reshape(n, B, n * s_loc, H // n, D).contiguous()


def _to_shards(y, n):
    """The second all-to-all: stacked head groups [n, B, S, H / n, D] ->
    stacked sequence shards [n, B, S / n, H, D]."""
    _, B, S, h_loc, D = y.shape
    return y.reshape(n, B, n, S // n, h_loc, D).permute(
        2, 1, 3, 0, 4, 5).reshape(n, B, S // n, n * h_loc, D)


def ulysses_attention(q, k, v, axis_name="sep", causal=False, scale=None,
                      attn_impl=None):
    """Ulysses/sep attention (reference :236): q/k/v every rank's local
    shard [B, S_local, H, D], stacked [n, B, S_local, H, D], H (and the KV
    head count) divisible by n. The first all-to-all gives each rank H / n
    heads of the whole sequence, ``attn_impl(q, k, v)`` ([B, S, H / n, D];
    default the dense softmax, the plain version of K1/K2) runs on each
    rank, and the second brings the outputs back to sequence shards. In one
    process both all-to-alls are regroupings of heads and shards."""
    n = sep_ring(axis_name, q.shape[0], q.device)
    if attn_impl is None:
        sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])

        def attn_impl(qq, kk, vv):
            return _attention_math(qq, kk, vv, causal, sc)

    qf, kf, vf = (_to_heads(x, n) for x in (q, k, v))
    out = torch.stack([attn_impl(qf[r], kf[r], vf[r]) for r in range(n)])
    return _to_shards(out, n)
