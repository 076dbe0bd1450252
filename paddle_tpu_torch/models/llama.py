"""LLaMA for serving, generation and training (counterpart of
``paddle_tpu/models/llama.py``).

Three paths:
- serving: the attention takes the two paged cache protocols of the ragged
  continuous-batching engine, ``PagedLayerCache`` (one decode token per
  row) and ``RaggedLayerCache`` (a packed mixed prefill+decode stream);
- generation (``generation.GenerationMixin``): the dense caches, a
  fixed-shape ``(k_cache, v_cache)`` pair per layer written at
  ``cache_position`` and attended under an absolute-position mask, or a
  growing ``(k, v)`` pair that each forward extends;
- training: with no cache, causal attention through
  ``F.scaled_dot_product_attention`` (the flash kernels on the card) or,
  for SFT-packed rows given ``segment_ids``, through
  ``flash_attention_packed`` (K3 on the card: attention stays within each
  segment, and rope restarts at each segment's start), optional per-layer
  recompute, and the fused linear cross-entropy. With
  ``context_parallel`` set and a mesh whose sep axis exceeds 1 (under
  ``distributed.mesh_guard``, as ``DistributedTrainStep`` runs its step),
  attention runs over the sep ranks' sequence shards: the ring (K6 per
  visit on the card, K1's backward entries) or Ulysses' head regrouping
  around K1/K2.
With ``num_experts > 1`` every decoder layer's MLP is a mixture of SwiGLU
experts behind a gshard/switch gate (``incubate.distributed.models.moe``,
every expert on the one card; the dispatch and combine are kernels D and E
on the card), its load-balancing loss added to the labeled forward's loss
and to ``make_loss_fn``'s. Sequence parallelism raises NotImplementedError
until a later slice of the port (see ROADMAP.md).
Parameter names match the reference's ``named_parameters()``, so
``models.convert.load_paddle_tpu_state`` maps a reference checkpoint one
to one.
"""
import torch
from torch import nn

from ..device import resolve
from ..distributed.fleet.recompute import recompute
from ..generation import GenerationMixin
from ..incubate.distributed.models.moe import MoELayer, SwiGLUExpertStack
from ..incubate.distributed.models.moe.gate import xavier_uniform_
from ..distributed.mesh import get_mesh, has_mesh
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..nn.functional import (
    fused_rotary_position_embedding, rope_tables, scaled_dot_product_attention,
    swiglu,
)
from ..nn.functional.common import linear
from ..nn.norm import RMSNorm
from ..ops.flash_attention import (
    flash_attention_fwd, flash_attention_packed, pack_segments,
)
from ..ops.paged_attention import (
    PagedLayerCache, paged_decode_attention, write_token_kv,
)
from ..ops.ragged_paged_attention import (
    RaggedLayerCache, ragged_paged_attention, write_ragged_kv,
)
from ..ops.ring_attention import ring_flash_attention, ulysses_attention

_LATER = "comes in a later slice of the port (see ROADMAP.md)"
_PACKED_CACHE = ("packed segment_ids do not compose with a decode cache — "
                 "packing is a training path")
_PACKED_CP = ("packed segment_ids do not compose with context_parallel: "
              "a packed row's segments do not follow the sep shards")
_CP_MASK = ("context_parallel attention is causal-only: padding masks are "
            "not supported on the ring path (pack sequences instead)")
_PACKED_MASK = ("packed segment_ids and attention_mask are exclusive — give "
                "padding its own segment id instead")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class LlamaConfig:
    """The reference's config, field for field. ``dtype`` ("float32",
    "bfloat16" or "float16") is the parameter dtype of the port's model.
    ``context_parallel``: False, True or "ring" (ring attention over the
    mesh's sep axis), or "ulysses" (the all-to-all pair); inert without a
    mesh whose sep axis exceeds 1. ``num_experts > 1`` makes every MLP a
    mixture of ``num_experts`` SwiGLU experts (top ``moe_top_k`` behind a
    ``moe_gate`` gate, "gshard", "naive" or "switch"), whose aux loss
    joins the loss weighted by ``moe_aux_loss_weight``.
    ``sequence_parallel`` is accepted but raises when set."""

    def __init__(
        self,
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=None,
        max_position_embeddings=4096,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        tie_word_embeddings=False,
        use_recompute=False,
        recompute_policy="full",
        sequence_parallel=False,
        fuse_linear_cross_entropy=False,
        ce_chunk_size=None,
        dtype="float32",
        seq_length=2048,
        num_experts=0,
        moe_top_k=2,
        moe_gate="gshard",
        moe_aux_loss_weight=0.01,
        context_parallel=False,
    ):
        if sequence_parallel:
            raise NotImplementedError(
                f"LlamaConfig: sequence_parallel {_LATER}")
        if context_parallel not in (False, True, "ring", "ulysses"):
            raise ValueError(
                f"context_parallel must be False/True/'ring'/'ulysses', "
                f"got {context_parallel!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.use_recompute = use_recompute
        self.recompute_policy = recompute_policy
        self.sequence_parallel = sequence_parallel
        self.fuse_linear_cross_entropy = fuse_linear_cross_entropy
        self.ce_chunk_size = ce_chunk_size
        self.dtype = dtype
        self.seq_length = seq_length
        self.num_experts = num_experts
        self.moe_top_k = moe_top_k
        self.moe_gate = moe_gate
        self.moe_aux_loss_weight = moe_aux_loss_weight
        self.context_parallel = context_parallel

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def llama2_7b(**kw):
    return LlamaConfig(hidden_size=4096, intermediate_size=11008,
                       num_hidden_layers=32, num_attention_heads=32, **kw)


def llama2_13b(**kw):
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40, **kw)


def llama2_70b(**kw):
    return LlamaConfig(hidden_size=8192, intermediate_size=28672,
                       num_hidden_layers=80, num_attention_heads=64,
                       num_key_value_heads=8, **kw)


def llama_tiny(**kw):
    """test-scale config"""
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("max_position_embeddings", 128)
    return LlamaConfig(**kw)


class _Linear(nn.Linear):
    """A bias-free projection through ``nn.functional.common.linear``,
    whose inputs the autocast mode casts first, as the reference's
    projections do (nn/functional/common.py:17-28)."""

    def forward(self, x):
        return linear(x, self.weight.t())


def _linear(in_f, out_f, **kw):
    return _Linear(in_f, out_f, bias=False, **kw)


def padding_mask(attention_mask):
    """A [B, S] padding mask (1 keep, 0 pad) as the additive [B, 1, 1, S]
    mask the reference adds on top of causal (:313-318); any other mask is
    taken as it is."""
    if attention_mask.dim() != 2:
        return attention_mask
    return (1.0 - attention_mask.float()[:, None, None, :]) * -1e9


def cache_mask(cache_position, S, S_max, attention_mask=None, device=None):
    """The fixed cache's additive mask (reference :271-280): query row i,
    at absolute position ``cache_position + i``, sees cache columns j <=
    that position (0, else -1e9), [1, 1, S, S_max] f32; a [B, S_max]
    padding ``attention_mask`` adds ``padding_mask`` ([B, 1, S, S_max])."""
    rows = cache_position + torch.arange(S, device=device)[:, None]
    cols = torch.arange(S_max, device=device)[None, :]
    mask = torch.where(cols <= rows, 0.0, -1e9)[None, None]
    if attention_mask is not None and attention_mask.dim() == 2:
        mask = mask + padding_mask(attention_mask)
    return mask


class LlamaAttention(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        self.q_proj = _linear(h, self.num_heads * self.head_dim, **kw)
        self.k_proj = _linear(h, self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = _linear(h, self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = _linear(self.num_heads * self.head_dim, h, **kw)

    def forward(self, hidden_states, position_ids=None, past_key_value=None,
                rope=None, segment_ids=None, attention_mask=None,
                cache_position=None, cache_mask=None):
        """past_key_value:
        - None (training): causal self-attention over the S positions,
          rope at ``position_ids`` (default 0..S-1) with ``rope_theta``,
          then ``scaled_dot_product_attention(is_causal=True)``: the flash
          kernels (K1, K2 for GQA) on the card. With ``segment_ids`` [B,
          S] (SFT packing, ids contiguous and ascending along a row; or
          the
          ``PackedSegments`` that ``LlamaModel`` prepares once), rope at
          ``position_ids`` (default: each token's position in its segment)
          and causal attention within each segment through
          ``flash_attention_packed`` (K3 on the card). Context parallel
          (``_use_context_parallel``): rope over the global positions,
          then ``_ring_attention`` over the sep shards; packed segment
          ids raise. A padding ``attention_mask`` ([B, S], 1 keep, 0 pad,
          or an additive mask) adds ``padding_mask`` on top of causal and
          takes the masked plain attention, which the reference also
          computes outside its Pallas kernels; with ``segment_ids`` or
          under context parallel it raises with the reference's words.
          Returns (out, None);
        - PagedLayerCache: decode-only (S == 1); the new token's K/V land in
          the pool, then paged decode attention (K5); as in the reference,
          the paged and ragged caches take no ``attention_mask`` (their
          lengths say which keys exist) and ignore one;
        - RaggedLayerCache: S is a packed mixed prefill+decode stream
          (B == 1); the stream's K/V land in the pool, then ragged paged
          attention (K4);
        - (k_cache, v_cache) [B, S_max, Hkv, D] with ``cache_position``:
          the fixed-shape cache (reference :260-283). The S new K/V land at
          ``cache_position`` (a slice assignment into the caller's cache,
          the reference's ``dynamic_update_slice``; cast to the cache's
          dtype), rope at ``position_ids`` (``LlamaModel``'s default:
          ``cache_position + arange(S)``) over a table covering S_max,
          then attention over
          the whole cache under ``cache_mask`` (``LlamaModel`` builds it
          once per forward: ``cache_mask(cache_position, S, S_max,
          attention_mask)``) in the masked plain tier, where the
          reference takes its math tier too;
        - (k, v) without ``cache_position``: the growing cache (reference
          :285-288). The new K/V are appended, and causal attention over
          the whole pair follows (bottom-right: K1 on the card with Sq <
          Sk), a [B, S_past + S] ``attention_mask`` adding its padding.
          Rope is at ``position_ids`` (``LlamaModel``'s default 0..S-1,
          the reference's) over a table covering S_past + S positions;
          the reference's table covers S only, so its absolute positions
          past S are NaN.
        The pools and the fixed cache are updated IN PLACE and returned as
        the layer's present; the growing cache's present is the new pair.
        ``rope`` is the (cos, sin) table pair covering the cache's
        positions (``LlamaModel`` builds it once per forward)."""
        paged = isinstance(past_key_value, PagedLayerCache)
        ragged = isinstance(past_key_value, RaggedLayerCache)
        if segment_ids is not None and (past_key_value is not None
                                        or cache_position is not None):
            raise ValueError(_PACKED_CACHE)
        B, S = hidden_states.shape[0], hidden_states.shape[1]
        q = self.q_proj(hidden_states).view(B, S, self.num_heads,
                                            self.head_dim)
        k = self.k_proj(hidden_states).view(B, S, self.num_kv_heads,
                                            self.head_dim)
        v = self.v_proj(hidden_states).view(B, S, self.num_kv_heads,
                                            self.head_dim)
        if past_key_value is None:
            cp = self._use_context_parallel(past_key_value)
            if attention_mask is not None:
                if segment_ids is not None:
                    raise ValueError(_PACKED_MASK)
                if cp:
                    raise ValueError(_CP_MASK)
            if segment_ids is not None:
                if cp:
                    raise ValueError(_PACKED_CP)
                segment_ids = pack_segments(segment_ids)
                if position_ids is None:
                    position_ids = segment_ids.position_ids
            q, k, _ = fused_rotary_position_embedding(
                q, k, None, position_ids=position_ids,
                rotary_emb_base=self.config.rope_theta)
            if segment_ids is not None:
                out = flash_attention_packed(q, k, v, segment_ids,
                                             causal=True)
            elif cp:
                out = self._ring_attention(q, k, v)
            else:
                out = scaled_dot_product_attention(
                    q, k, v, attn_mask=None if attention_mask is None
                    else padding_mask(attention_mask), is_causal=True,
                    training=self.training)
            out = out.reshape(B, S, self.num_heads * self.head_dim)
            return self.o_proj(out), None
        if not (paged or ragged):
            return self._dense(q, k, v, position_ids, past_key_value, rope,
                               attention_mask, cache_position, cache_mask)
        if position_ids is None:
            raise ValueError("the paged caches need position_ids")
        cos, sin = rope
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, cos=cos, sin=sin, position_ids=position_ids)
        c = past_key_value
        if paged:
            if S != 1:
                raise ValueError("paged cache is decode-only: expected S == 1")
            write_token_kv(c.k_pages, c.page_indices, c.lengths, k[:, 0])
            write_token_kv(c.v_pages, c.page_indices, c.lengths, v[:, 0])
            out = paged_decode_attention(q[:, 0], c.k_pages, c.v_pages,
                                         c.lengths + 1, c.page_indices)
        else:
            if B != 1:
                raise ValueError("ragged cache packs every row into one "
                                 "stream: expected B == 1")
            write_ragged_kv(c.k_pages, c.page_indices, c.row_of,
                            c.token_pos, c.valid, k[0])
            write_ragged_kv(c.v_pages, c.page_indices, c.row_of,
                            c.token_pos, c.valid, v[0])
            out = ragged_paged_attention(q[0], c.k_pages, c.v_pages,
                                         c.kv_lens, c.page_indices,
                                         c.cu_q_lens)
        out = out.reshape(B, S, self.num_heads * self.head_dim)
        return self.o_proj(out), c

    def _dense(self, q, k, v, position_ids, cache, rope, attention_mask,
               cache_position, mask):
        """The fixed-shape cache (``cache_position`` given) or the growing
        one (the ``forward`` docstring)."""
        B, S = q.shape[0], q.shape[1]
        k_past, v_past = cache
        cos, sin = rope
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, cos=cos, sin=sin, position_ids=position_ids)
        if cache_position is None:
            k = torch.cat([k_past, k], dim=1)
            v = torch.cat([v_past, v], dim=1)
            out = scaled_dot_product_attention(
                q, k, v, attn_mask=None if attention_mask is None
                else padding_mask(attention_mask), is_causal=True,
                training=self.training)
            out = out.reshape(B, S, self.num_heads * self.head_dim)
            return self.o_proj(out), (k, v)
        pos = int(cache_position)
        k_past[:, pos:pos + S] = k
        v_past[:, pos:pos + S] = v
        out = scaled_dot_product_attention(
            q, k_past.to(q.dtype), v_past.to(q.dtype), attn_mask=mask,
            is_causal=False, training=self.training)
        out = out.reshape(B, S, self.num_heads * self.head_dim)
        return self.o_proj(out), cache

    def _use_context_parallel(self, past_key_value):
        """Context parallel applies: the config asks for it, no cache is
        given, and the current mesh has a sep axis above 1 (reference
        :323-343)."""
        if not self.config.context_parallel or past_key_value is not None:
            return False
        if not has_mesh():
            return False
        mesh = get_mesh()
        return "sep" in mesh.axis_names and mesh.shape["sep"] > 1

    def _ring_attention(self, q, k, v):
        """The context-parallel island (reference :345-425): q [B, S, Hq,
        D], k/v [B, S, Hkv, D] after rope are cut into the sep ranks'
        sequence shards, stacked [n, B, S / n, H, D] (rank r: positions r
        S/n ...; no copy at B = 1), and run through the ring
        (``ring_flash_attention``: K6 per visit, K1's backward entries;
        causal by global position) or, for "ulysses", through
        ``ulysses_attention`` with ``flash_attention_fwd`` (K1/K2) on each
        rank's heads. Returns [B, S, Hq * D]."""
        sep = get_mesh().shape["sep"]
        B, S, hq, D = q.shape
        if S % sep:
            raise ValueError(
                f"context_parallel: sequence length {S} is not divisible "
                f"by the sep axis size {sep} — pad the sequence or change "
                "the mesh")

        def shards(x):
            return x.reshape(B, sep, S // sep, *x.shape[2:]).transpose(0, 1)

        if self.config.context_parallel == "ulysses":
            if hq % sep:
                raise ValueError(
                    f"context_parallel='ulysses' needs per-mp-rank head "
                    f"count divisible by sep={sep} (got {hq}) — use 'ring' "
                    "instead (which keeps kv heads unexpanded)")
            # GQA: kv heads ride the all-to-all unexpanded when they split
            # over sep, else they are expanded first (reference :387-388)
            group = hq // k.shape[2]
            if group > 1 and k.shape[2] % sep:
                k = k.repeat_interleave(group, dim=2)
                v = v.repeat_interleave(group, dim=2)
            out = ulysses_attention(
                shards(q), shards(k), shards(v), "sep", causal=True,
                attn_impl=lambda qq, kk, vv: flash_attention_fwd(
                    qq, kk, vv, causal=True))
        else:
            out = ring_flash_attention(shards(q), shards(k), shards(v),
                                       causal=True)
        return out.transpose(0, 1).reshape(B, S, hq * D)


class LlamaMLP(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m, **kw)
        self.up_proj = _linear(h, m, **kw)
        self.down_proj = _linear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.self_attn = LlamaAttention(config, **kw)
        if config.num_experts > 1:
            # reference :445-461: SwiGLU experts behind the configured gate
            self.mlp = MoELayer(
                config.hidden_size,
                experts=SwiGLUExpertStack(config.num_experts,
                                          config.hidden_size,
                                          config.intermediate_size, **kw),
                gate={"type": config.moe_gate,
                      "num_expert": config.num_experts,
                      "top_k": config.moe_top_k}, **kw)
        else:
            self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)

    def forward(self, hidden_states, position_ids=None, past_key_value=None,
                rope=None, segment_ids=None, attention_mask=None,
                **cache_kw):
        h, present = self.self_attn(self.input_layernorm(hidden_states),
                                    position_ids, past_key_value, rope,
                                    segment_ids, attention_mask, **cache_kw)
        h = hidden_states + h
        return h + self.mlp(self.post_attention_layernorm(h)), present


class LlamaModel(nn.Module):
    """The trunk: embedding, decoder layers, final norm."""

    def __init__(self, config, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **kw)

    def forward(self, input_ids, position_ids=None, past_key_values=None,
                segment_ids=None, attention_mask=None, cache_position=None,
                use_cache=False):
        """With one cache per layer in ``past_key_values`` (paged, ragged,
        or a dense (k, v) pair: fixed-shape with ``cache_position``, else
        growing; ``LlamaAttention``): returns (normed hidden states,
        presents); ``attention_mask`` reaches the dense caches alone, and
        the rope table and the fixed cache's mask are built here once for
        every layer. ``use_cache`` is the reference's flag: presents come
        back whenever caches are given. Without caches: the training
        forward, returning the normed hidden states; each layer runs under
        ``recompute`` (``config.recompute_policy``) when
        ``config.use_recompute`` and the model is training. ``segment_ids``
        [B, S] packs several sequences into each row (training only): each
        layer attends within segments, and rope restarts at each segment's
        start unless ``position_ids`` are given (reference :497-504). The
        ids' positions and K3's tile tables are prepared here once
        (``pack_segments``) for every layer. ``attention_mask``: a padding
        mask for every layer (``LlamaAttention``)."""
        if segment_ids is not None:
            if past_key_values is not None:
                raise ValueError(_PACKED_CACHE)
            segment_ids = pack_segments(torch.as_tensor(
                segment_ids, device=input_ids.device))
            if position_ids is None:
                position_ids = segment_ids.position_ids
        h = self.embed_tokens(input_ids)
        if past_key_values is None:
            if attention_mask is not None:
                attention_mask = torch.as_tensor(attention_mask,
                                                 device=input_ids.device)
            # MoE layers skip block recompute (reference :514-527): the
            # gate's aux loss is read off the layer after the forward
            remat = (self.config.use_recompute and self.training
                     and self.config.num_experts <= 1)
            for layer in self.layers:
                if remat:
                    h = recompute(layer, h, position_ids,
                                  segment_ids=segment_ids,
                                  attention_mask=attention_mask,
                                  policy=self.config.recompute_policy)[0]
                else:
                    h = layer(h, position_ids, segment_ids=segment_ids,
                              attention_mask=attention_mask)[0]
            return self.norm(h)
        c0 = past_key_values[0]
        dev = input_ids.device
        kw = {}
        if isinstance(c0, (tuple, list)):   # a dense (k, v) pair
            B, S = input_ids.shape
            if attention_mask is not None:
                attention_mask = torch.as_tensor(attention_mask, device=dev)
            n_tab = c0[0].shape[1]
            # positions default to the tokens' own (fixed cache) or to
            # 0..S-1 (the growing cache, as the reference's default)
            pos = 0 if cache_position is None else int(cache_position)
            if position_ids is None:
                position_ids = (pos + torch.arange(S, device=dev)).expand(
                    B, S)
            position_ids = torch.as_tensor(position_ids, device=dev)
            if cache_position is not None:
                kw = dict(cache_position=pos,
                          cache_mask=cache_mask(pos, S, n_tab,
                                                attention_mask, dev))
            else:
                n_tab += S
                kw = dict(attention_mask=attention_mask)
        else:
            n_tab = c0.page_indices.shape[1] * c0.page_size
        rope = rope_tables(n_tab, self.config.head_dim, self.config.rope_theta,
                           dev)
        presents = []
        for layer, pkv in zip(self.layers, past_key_values):
            h, present = layer(h, position_ids, pkv, rope, **kw)
            presents.append(present)
        return self.norm(h), presents

    def moe_aux_loss(self):
        """The sum of the gates' load-balancing losses from the last
        forward, or None without MoE layers (reference :534-551)."""
        total = None
        for layer in self.layers:
            aux = getattr(layer.mlp, "l_aux", None)
            if aux is not None:
                total = aux if total is None else total + aux
        return total


class LlamaPretrainingCriterion(nn.Module):
    """The LM loss (reference :578): ``(logits, labels)`` -> f32 cross-
    entropy, mean over the labels that are not ``ignore_index``; the fused
    form ``(hidden, lm_weight [H, V], labels)`` -> the same loss through
    ``fused_linear_cross_entropy`` in chunks of ``config.ce_chunk_size``
    rows, never building the [N, vocab] logits."""

    def __init__(self, config=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.ce_chunk_size = getattr(config, "ce_chunk_size", None)

    def forward(self, logits, *rest):
        if len(rest) == 2:
            weight, labels = rest
            return fused_linear_cross_entropy(
                logits, weight, labels, ignore_index=self.ignore_index,
                chunk_size=self.ce_chunk_size)
        (labels,) = rest
        return torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            labels.reshape(-1).long(), ignore_index=self.ignore_index,
            reduction="mean")


class LlamaForCausalLM(GenerationMixin, nn.Module):
    """Trunk (``llama``) plus LM head; weights drawn from ``seed`` with the
    reference's init (Normal(0, 0.02) for projections and embedding, ones
    for the norms, XavierUniform with the reference's fan rule for the MoE
    gates and experts) on ``device`` (default "cuda") in
    ``config.dtype``.
    ``generate``, ``generate_speculative`` and beam search come from
    ``GenerationMixin``."""

    def __init__(self, config, device="cuda", seed=0):
        super().__init__()
        dev = resolve(device)
        self.config = config
        kw = dict(device="meta", dtype=_DTYPES[config.dtype])
        self.llama = LlamaModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings
                        else _linear(config.hidden_size, config.vocab_size,
                                     **kw))
        self.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "layernorm" in name or name == "llama.norm.weight":
                    p.fill_(1.0)
                elif ".mlp.gate." in name or ".mlp.experts." in name:
                    xavier_uniform_(p, gen)
                else:
                    p.normal_(0.0, 0.02, generator=gen)
        self.eval()

    def head(self, h):
        """LM-head projection (tied: the embedding's transpose)."""
        if self.lm_head is not None:
            return self.lm_head(h)
        return h @ self.llama.embed_tokens.weight.t()

    def lm_weight(self):
        """The LM head's weight in the reference's [hidden, vocab] layout
        (a transposed view; tied: the embedding's)."""
        if self.lm_head is not None:
            return self.lm_head.weight.t()
        return self.llama.embed_tokens.weight.t()

    def moe_aux_loss(self):
        return self.llama.moe_aux_loss()

    def _apply_moe_aux(self, loss):
        """``loss`` plus ``moe_aux_loss_weight`` times the last forward's
        gate losses (reference :715-722); the loss itself without MoE."""
        aux = self.llama.moe_aux_loss()
        if aux is None or not self.config.moe_aux_loss_weight:
            return loss
        return loss + self.config.moe_aux_loss_weight * aux

    def make_loss_fn(self):
        """A ``TrainStep`` loss function that adds the gates' aux loss to
        the criterion's (reference :724-738): ``loss_fn(logits, labels)``,
        or ``loss_fn(hidden, lm_weight, labels)`` for the fused form. It
        reads the aux loss of the forward the step just ran."""
        crit = LlamaPretrainingCriterion(self.config)

        def loss_fn(*args):
            return self._apply_moe_aux(crit(*args))

        return loss_fn

    def forward(self, input_ids, position_ids=None, past_key_values=None,
                labels=None, segment_ids=None, attention_mask=None,
                cache_position=None, use_cache=False):
        """Serving and generation (caches given): returns (logits,
        presents) over the paged, ragged or dense caches (``LlamaModel``;
        ``cache_position`` selects the fixed-shape dense cache). Training
        (no cache), as the reference's :758-783:
        with ``fuse_linear_cross_entropy`` and labels, the fused loss from
        (hidden, lm weight, labels), never building [B, S, vocab] logits;
        fused and training without labels, (hidden, lm weight) for a loss
        function; otherwise the logits, or their loss given labels. A
        loss includes the MoE gates' aux loss (``_apply_moe_aux``).
        ``segment_ids`` [B, S]: SFT-packed rows (``LlamaModel``); refused
        with caches. ``attention_mask``: a padding mask on the training
        path and the dense caches (``LlamaAttention``); the paged and
        ragged caches ignore it, as the reference's do."""
        if past_key_values is not None:
            if segment_ids is not None:
                raise ValueError(_PACKED_CACHE)
            h, presents = self.llama(input_ids, position_ids, past_key_values,
                                     attention_mask=attention_mask,
                                     cache_position=cache_position)
            return self.head(h), presents
        h = self.llama(input_ids, position_ids, segment_ids=segment_ids,
                       attention_mask=attention_mask)
        if self.config.fuse_linear_cross_entropy and (labels is not None
                                                      or self.training):
            w = self.lm_weight()
            if labels is not None:
                return self._apply_moe_aux(
                    LlamaPretrainingCriterion(self.config)(h, w, labels))
            return h, w
        logits = self.head(h)
        if labels is not None:
            return self._apply_moe_aux(
                LlamaPretrainingCriterion(self.config)(logits, labels))
        return logits

    def num_parameters(self):
        return sum(p.numel() for p in self.parameters())

    @staticmethod
    def flops_per_token(config, seq_len=None, causal=True):
        """Training matmul FLOPs per token (reference :791): 6 * N
        (GQA-aware) plus the attention term 12 * L * h * s, halved when
        causal."""
        h = config.hidden_size
        kv_heads = config.num_key_value_heads or config.num_attention_heads
        kv_dim = kv_heads * (h // config.num_attention_heads)
        n = (config.vocab_size * h * (1 if config.tie_word_embeddings else 2)
             + config.num_hidden_layers
             * (2 * h * h + 2 * h * kv_dim
                + 3 * h * config.intermediate_size))
        flops = 6 * n
        if seq_len is not None:
            attn = 12.0 * config.num_hidden_layers * h * seq_len
            flops += attn * (0.5 if causal else 1.0)
        return flops
