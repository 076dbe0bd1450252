"""Fused functionals of the training path (counterpart of
``paddle_tpu/incubate/nn/functional.py``).

``rope_rotate``, ``fused_rotary_position_embedding`` and ``swiglu`` keep
the reference's signatures; ``paddle_tpu_torch.nn.functional`` re-exports
them. ``fused_linear_cross_entropy`` computes the LM loss straight from
hidden states. The reference computes all of them in XLA, outside any
Pallas kernel, so the port's are plain PyTorch (its products ``torch.mm``,
cuBLAS on the card), with the reference's arithmetic: f32 inside, cast
back to the input dtype.
"""
import torch
import torch.nn.functional as F


def rope_tables(n_positions, head_dim, base=10000.0, device=None):
    """(cos, sin) tables [n_positions, head_dim] in f32, rotate-half form."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    freqs = torch.outer(torch.arange(n_positions, dtype=torch.float32,
                                     device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rope_rotate(x, cos, sin):
    """Rotate-half rope on [B, S, H, D]."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0):
    """Rope on [batch, seq, heads, head_dim] tensors. cos/sin tables,
    [S_tab, D] or [1, S_tab, 1, D], are built from ``rotary_emb_base`` when
    not given; ``position_ids`` [B, S] gathers their rows. Math in f32,
    results in each input's dtype. ``use_neox_rotary_style`` is accepted
    and, as in the reference, selects nothing: the rotation is always
    rotate-half."""
    B, S, H, D = q.shape
    if sin is None or cos is None:
        cos, sin = rope_tables(S, D, rotary_emb_base, device=q.device)
    if cos.dim() == 4:   # [1, S_tab, 1, D] -> [S_tab, D]
        cos, sin = cos[0, :, 0, :], sin[0, :, 0, :]
    if position_ids is not None:
        pid = position_ids.long()
        cos_a, sin_a = cos[pid][:, :, None, :], sin[pid][:, :, None, :]
    else:
        cos_a, sin_a = cos[None, :, None, :], sin[None, :, None, :]
    return tuple(None if t is None
                 else rope_rotate(t.float(), cos_a, sin_a).to(t.dtype)
                 for t in (q, k, v))


def swiglu(x, y=None, name=None):
    """LLaMA MLP gate: silu(x) * y; with y None, x is split in halves.
    ``name`` is accepted, as in the reference, and unused."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def _mm_f32(a, b):
    """a @ b with an f32 result. bf16 operands multiply exactly in f32 and
    sum in f32, as the reference's ``preferred_element_type=f32`` product:
    on the card cuBLAS does it in one call with an f32 output; on the CPU
    the operands are widened first (the same numbers)."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _ChunkedLinearCE(torch.autograd.Function):
    """Per-row cross-entropy of ``hidden @ weight`` against ``labels``, one
    chunk of rows at a time; the backward recomputes each chunk's logits
    (the reference's ``checkpoint_chunks=True``), so only one chunk of
    [chunk, V] f32 logits is ever live."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, ignore_index, chunk):
        n = hidden.shape[0]
        losses = torch.empty(n, dtype=torch.float32, device=hidden.device)
        for s in range(0, n, chunk):
            logits = _mm_f32(hidden[s:s + chunk], weight)
            lab = labels[s:s + chunk]
            lse = torch.logsumexp(logits, dim=-1)
            safe = lab.clamp(0, logits.shape[-1] - 1)
            picked = logits.gather(1, safe[:, None])[:, 0]
            losses[s:s + chunk] = torch.where(lab != ignore_index,
                                              lse - picked, 0.0)
            del logits
        ctx.save_for_backward(hidden, weight, labels)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return losses

    @staticmethod
    def backward(ctx, grad_losses):
        hidden, weight, labels = ctx.saved_tensors
        chunk = ctx.chunk
        dh = torch.empty_like(hidden) if ctx.needs_input_grad[0] else None
        dw = None
        for s in range(0, hidden.shape[0], chunk):
            hc = hidden[s:s + chunk]
            lab = labels[s:s + chunk]
            valid = lab != ctx.ignore_index
            # softmax(logits) - onehot(label), times the row's cotangent
            g = _mm_f32(hc, weight)
            g = g.sub_(torch.logsumexp(g, dim=-1, keepdim=True)).exp_()
            rows = torch.arange(g.shape[0], device=g.device)
            g[rows, lab.clamp(0, g.shape[-1] - 1)] -= 1.0
            g.mul_(torch.where(valid, grad_losses[s:s + chunk].float(),
                               0.0)[:, None])
            gc = g.to(hidden.dtype)
            del g
            if dh is not None:
                dh[s:s + chunk] = torch.mm(gc, weight.t())
            if ctx.needs_input_grad[1]:
                part = _mm_f32(hc.t(), gc)
                dw = part if dw is None else dw.add_(part)
                del part
            del gc
        if dw is not None:
            dw = dw.to(weight.dtype)
        return dh, dw, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               chunk_size=None, reduction="mean",
                               checkpoint_chunks=True, name=None):
    """Cross-entropy from hidden states without the [N, vocab] logits.

    hidden [..., H], weight [H, V] (the reference's layout; pass
    ``lm_head.weight.t()`` for an ``nn.Linear``), labels [...] int. Logits
    are f32, one chunk of ``chunk_size`` rows (default 4096) at a time, and
    recomputed per chunk in the backward. Rows labelled ``ignore_index``
    count zero and are left out of the mean. ``reduction`` is "mean",
    "sum" or "none" (per-token losses shaped as ``labels``). The reference
    pads the rows to a multiple of the chunk with ignored rows; here the
    last chunk is shorter, which adds the same nothing. Here the chunk
    logits are always recomputed in the backward; ``checkpoint_chunks`` is
    kept for the reference's signature and changes no result."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    chunk = 4096 if chunk_size is None else int(chunk_size)
    if chunk < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    hs = hidden.reshape(-1, hidden.shape[-1])
    ls = labels.reshape(-1).long()
    if ls.shape[0] != hs.shape[0]:
        raise ValueError(f"{hs.shape[0]} hidden rows but {ls.shape[0]} "
                         "labels")
    losses = _ChunkedLinearCE.apply(hs, weight, ls, ignore_index, chunk)
    if reduction == "none":
        return losses.reshape(labels.shape)
    total = losses.sum()
    if reduction == "sum":
        return total
    count = (ls != ignore_index).sum()
    return total / torch.clamp(count, min=1)
