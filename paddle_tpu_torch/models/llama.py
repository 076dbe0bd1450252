"""LLaMA for serving and training (counterpart of
``paddle_tpu/models/llama.py``).

Two paths:
- serving: the attention takes the two paged cache protocols of the ragged
  continuous-batching engine, ``PagedLayerCache`` (one decode token per
  row) and ``RaggedLayerCache`` (a packed mixed prefill+decode stream);
- training: with no cache, causal attention through
  ``F.scaled_dot_product_attention`` (the flash kernels on the card),
  optional per-layer recompute, and the fused linear cross-entropy.
The fixed-shape or growing caches, MoE, context and sequence parallelism
and packed segments raise NotImplementedError until a later slice of the
port (see ROADMAP.md). Parameter names match the reference's
``named_parameters()``, so ``models.convert.load_paddle_tpu_state`` maps a
reference checkpoint one to one.
"""
import torch
from torch import nn

from ..device import resolve
from ..distributed.fleet.recompute import recompute
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..nn.functional import (
    fused_rotary_position_embedding, rope_tables, scaled_dot_product_attention,
    swiglu,
)
from ..nn.norm import RMSNorm
from ..ops.paged_attention import (
    PagedLayerCache, paged_decode_attention, write_token_kv,
)
from ..ops.ragged_paged_attention import (
    RaggedLayerCache, ragged_paged_attention, write_ragged_kv,
)

_LATER = "comes in a later slice of the port (see ROADMAP.md)"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LlamaConfig:
    """The reference's config, field for field. ``dtype`` ("float32" or
    "bfloat16") is the parameter dtype of the port's model. MoE, context-
    and sequence-parallel fields are accepted but raise when set."""

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
        later = {
            "num_experts > 1 (MoE)": num_experts > 1,
            "context_parallel": bool(context_parallel),
            "sequence_parallel": sequence_parallel,
        }
        for field, is_set in later.items():
            if is_set:
                raise NotImplementedError(f"LlamaConfig: {field} {_LATER}")
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


def _linear(in_f, out_f, **kw):
    return nn.Linear(in_f, out_f, bias=False, **kw)


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
                rope=None):
        """past_key_value:
        - None (training): causal self-attention over the S positions,
          rope at ``position_ids`` (default 0..S-1) with ``rope_theta``,
          then ``scaled_dot_product_attention(is_causal=True)``: the flash
          kernels (K1, K2 for GQA) on the card. Returns (out, None);
        - PagedLayerCache: decode-only (S == 1); the new token's K/V land in
          the pool, then paged decode attention (K5);
        - RaggedLayerCache: S is a packed mixed prefill+decode stream
          (B == 1); the stream's K/V land in the pool, then ragged paged
          attention (K4).
        The pools are updated IN PLACE and the cache is returned as the
        layer's present. ``rope`` is the (cos, sin) table pair covering
        pages_per_seq * page_size positions (``LlamaModel`` builds it once
        per forward)."""
        paged = isinstance(past_key_value, PagedLayerCache)
        ragged = isinstance(past_key_value, RaggedLayerCache)
        if past_key_value is not None and not (paged or ragged):
            raise NotImplementedError(
                "LlamaAttention: only PagedLayerCache and RaggedLayerCache "
                "caches are ported; the dense and fixed-shape caches "
                f"{_LATER}")
        B, S = hidden_states.shape[0], hidden_states.shape[1]
        q = self.q_proj(hidden_states).view(B, S, self.num_heads,
                                            self.head_dim)
        k = self.k_proj(hidden_states).view(B, S, self.num_kv_heads,
                                            self.head_dim)
        v = self.v_proj(hidden_states).view(B, S, self.num_kv_heads,
                                            self.head_dim)
        if past_key_value is None:
            q, k, _ = fused_rotary_position_embedding(
                q, k, None, position_ids=position_ids,
                rotary_emb_base=self.config.rope_theta)
            out = scaled_dot_product_attention(q, k, v, is_causal=True,
                                               training=self.training)
            out = out.reshape(B, S, self.num_heads * self.head_dim)
            return self.o_proj(out), None
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
        self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)

    def forward(self, hidden_states, position_ids=None, past_key_value=None,
                rope=None):
        h, present = self.self_attn(self.input_layernorm(hidden_states),
                                    position_ids, past_key_value, rope)
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

    def forward(self, input_ids, position_ids=None, past_key_values=None):
        """With one paged or ragged cache per layer in ``past_key_values``:
        returns (normed hidden states, presents). Without: the training
        forward, returning the normed hidden states; each layer runs under
        ``recompute`` (``config.recompute_policy``) when
        ``config.use_recompute`` and the model is training."""
        h = self.embed_tokens(input_ids)
        if past_key_values is None:
            remat = self.config.use_recompute and self.training
            for layer in self.layers:
                if remat:
                    h = recompute(layer, h, position_ids,
                                  policy=self.config.recompute_policy)[0]
                else:
                    h = layer(h, position_ids)[0]
            return self.norm(h)
        c0 = past_key_values[0]
        rope = rope_tables(c0.page_indices.shape[1] * c0.page_size,
                           self.config.head_dim, self.config.rope_theta,
                           input_ids.device)
        presents = []
        for layer, pkv in zip(self.layers, past_key_values):
            h, present = layer(h, position_ids, pkv, rope)
            presents.append(present)
        return self.norm(h), presents


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


class LlamaForCausalLM(nn.Module):
    """Trunk (``llama``) plus LM head; weights drawn from ``seed`` with the
    reference's init (Normal(0, 0.02) for projections and embedding, ones
    for the norms) on ``device`` (default "cuda") in ``config.dtype``."""

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

    def forward(self, input_ids, position_ids=None, past_key_values=None,
                labels=None):
        """Serving (caches given): returns (logits, presents) over the paged
        or ragged caches. Training (no cache), as the reference's :758-783:
        with ``fuse_linear_cross_entropy`` and labels, the fused loss from
        (hidden, lm weight, labels), never building [B, S, vocab] logits;
        fused and training without labels, (hidden, lm weight) for a loss
        function; otherwise the logits, or their loss given labels."""
        if past_key_values is not None:
            h, presents = self.llama(input_ids, position_ids, past_key_values)
            return self.head(h), presents
        h = self.llama(input_ids, position_ids)
        if self.config.fuse_linear_cross_entropy and (labels is not None
                                                      or self.training):
            w = self.lm_weight()
            if labels is not None:
                return LlamaPretrainingCriterion(self.config)(h, w, labels)
            return h, w
        logits = self.head(h)
        if labels is not None:
            return LlamaPretrainingCriterion(self.config)(logits, labels)
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
