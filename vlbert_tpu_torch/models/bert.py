"""BERT encoder core (port of vlbert_tpu/models/bert.py), post-LN as in the
reference's vendored pytorch_pretrained_bert.

LayerNorm statistics and the attention softmax are always fp32; matmuls run
in the compute dtype with fp32 parameters. Padding is hidden by the
additive -10000 key bias. Module and parameter names are the reference's
(``attention.self.query``, ``attention.output.LayerNorm``, ...), so
checkpoint conversion is a mechanical rename. The pretraining MLM head
(``BertLMPredictionHead``) is here too.

The attention core goes through ``ops.attention``: in training with a
non-zero prob-dropout rate, ``fused_attention_dropout`` (kernels K3/K4 on
the card); otherwise ``fused_attention`` (kernel K2). Only the
attention-probs (vis) path keeps the plain einsum/softmax pipeline,
because its probs must reach the caller. The hidden dropouts are
``ops.dropout.Dropout`` (kernel K5 on the card); every dropout takes its
seed from the step's ``dropout_seeds`` context.

``BertEncoder(remat=True)`` (TPU.REMAT) checkpoints each layer in training
under grad: only its input is kept, and ``backward()`` runs the layer again
(K3 and K5 launch a second time) with the dropout seeds of its first run
(``ops.dropout.site_state`` / ``replay_sites``), so the recompute rebuilds
the masks that K4 and K5's backward replay. The attention-probs path and
eval run unrolled, as in the JAX package's ``nn.remat``.

Under tensor parallelism (``parallel/tp.py::shard_module``) a layer holds
its rank's heads and FFN columns and a ``model_group``: the
self-attention and the intermediate dense take their input through
``copy_to_model``, the self-attention runs its local heads (K3/K4 draw
their masks at the layer's head offset), and the two output denses are
row-parallel: the local partial product is summed over the model group in
fp32, the bias added once, the sum cast to the compute dtype. A layer's
recompute under REMAT replays its collectives in the same order on every
rank.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vlbert_tpu_torch.models.layers import Linear, cast
from vlbert_tpu_torch.ops.attention import (fused_attention,
                                            fused_attention_dropout)
from vlbert_tpu_torch.ops.dropout import (Dropout, next_site_seed,
                                          replay_sites, site_state)
from vlbert_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

ACT2FN = {
    # exact erf gelu, NOT the tanh approximation
    "gelu": F.gelu,
    "relu": torch.relu,
    "swish": F.silu,
}


class BertLayerNorm(nn.Module):
    """TF-style LayerNorm, eps inside the sqrt, statistics in fp32; the
    output has the input's dtype."""

    def __init__(self, hidden_size, eps=1e-12, scale_init_value=1.0, *,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.full((hidden_size,), float(scale_init_value),
                       device=device))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=device))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def _to_model(x, group):
    """``x`` as a column-parallel linear's input over ``group`` (None: no
    tensor parallelism)."""
    return x if group is None else copy_to_model(x, group)


def _row_parallel(dense, h, group):
    """``dense(h)``; over ``group`` (tensor parallelism) ``dense`` holds
    its rank's input columns: the partial product, summed over the group
    in fp32, plus the bias once, in the compute dtype."""
    if group is None:
        return dense(h)
    d = dense.compute_dtype
    part = F.linear(cast(h, d), dense.op_weight(d)).to(torch.float32)
    return (reduce_from_model(part, group) + dense.bias).to(d)


class BertSelfAttention(nn.Module):
    """Multi-head self-attention. ``fused_qkv`` runs the three projections
    as one [3H, H] GEMM over the concatenated query/key/value weights; q, k
    and v are then strided views of its output, which kernel K2 reads
    without a copy. The parameters are the same either way. Under tensor
    parallelism its ``num_heads`` heads are heads ``head_offset`` .. of the
    layer's ``heads_total``, and the weights its rank's rows of the
    layer's."""

    def __init__(self, hidden_size, num_heads, dropout_rate=0.0,
                 fused_qkv=False, *, dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_offset, self.heads_total = 0, num_heads
        self.model_group = None
        self.head_dim = hidden_size // num_heads
        self.fused_qkv = fused_qkv
        self.compute_dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.query = Linear(hidden_size, hidden_size, **kw)
        self.key = Linear(hidden_size, hidden_size, **kw)
        self.value = Linear(hidden_size, hidden_size, **kw)
        self.dropout_rate = float(dropout_rate)
        self.dropout = Dropout(dropout_rate)     # vis path only

    def forward(self, hidden, attention_bias, output_attention_probs=False):
        B, L, _ = hidden.shape
        d = self.compute_dtype
        if output_attention_probs and self.model_group is not None:
            raise NotImplementedError(
                "the attention-probs path runs on one process, with every "
                "head; tensor parallelism splits them")
        hidden = _to_model(hidden, self.model_group)
        shape = (B, L, -1, self.head_dim)
        if self.fused_qkv:
            w = torch.cat([self.query.op_weight(d), self.key.op_weight(d),
                           self.value.op_weight(d)])
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            qkv = F.linear(cast(hidden, d), w, cast(b, d))
            q, k, v = qkv.view(B, L, 3, -1, self.head_dim).unbind(2)
        else:
            q = self.query(hidden).view(shape)
            k = self.key(hidden).view(shape)
            v = self.value(hidden).view(shape)

        if output_attention_probs:
            # vis path: the probs survive to the caller
            s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                             k.to(torch.float32)) / math.sqrt(self.head_dim)
            probs = torch.softmax(s + attention_bias.to(torch.float32), -1)
            ctx = torch.einsum("bhqk,bkhd->bqhd",
                               self.dropout(probs).to(d).to(torch.float32),
                               v.to(torch.float32))
            return ctx.reshape(B, L, -1).to(d), probs
        if self.training and self.dropout_rate > 0.0:
            # a split layer's heads draw their masks at their place in it
            place = {} if self.heads_total == self.num_heads else dict(
                head_offset=self.head_offset, heads_total=self.heads_total)
            ctx = fused_attention_dropout(q, k, v, attention_bias,
                                          self.dropout_rate,
                                          seed=next_site_seed(), **place)
        else:
            ctx = fused_attention(q, k, v, attention_bias)
        return ctx.reshape(B, L, -1).to(d)


class BertSelfOutput(nn.Module):
    def __init__(self, hidden_size, dropout_rate, *, dtype, device):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype,
                            device=device)
        self.LayerNorm = BertLayerNorm(hidden_size, device=device)
        self.dropout = Dropout(dropout_rate)
        self.model_group = None

    def forward(self, h, residual):
        h = _row_parallel(self.dense, h, self.model_group)
        return self.LayerNorm(self.dropout(h) + residual)


class BertAttention(nn.Module):
    """Self-attention + residual projection block."""

    def __init__(self, hidden_size, num_heads, attention_dropout=0.0,
                 hidden_dropout=0.0, fused_qkv=False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.self = BertSelfAttention(hidden_size, num_heads,
                                      attention_dropout, fused_qkv,
                                      dtype=dtype, device=device)
        self.output = BertSelfOutput(hidden_size, hidden_dropout,
                                     dtype=dtype, device=device)

    def forward(self, x, attention_bias, output_attention_probs=False):
        attn = self.self(x, attention_bias, output_attention_probs)
        if output_attention_probs:
            attn, probs = attn
            return self.output(attn, x), probs
        return self.output(attn, x)


class BertIntermediate(nn.Module):
    def __init__(self, hidden_size, intermediate_size, hidden_act, *, dtype,
                 device):
        super().__init__()
        self.dense = Linear(hidden_size, intermediate_size, dtype=dtype,
                            device=device)
        self.act = ACT2FN[hidden_act]
        self.model_group = None

    def forward(self, x):
        return self.act(self.dense(_to_model(x, self.model_group)))


class BertOutput(nn.Module):
    def __init__(self, intermediate_size, hidden_size, dropout_rate, *,
                 dtype, device):
        super().__init__()
        self.dense = Linear(intermediate_size, hidden_size, dtype=dtype,
                            device=device)
        self.LayerNorm = BertLayerNorm(hidden_size, device=device)
        self.dropout = Dropout(dropout_rate)
        self.model_group = None

    def forward(self, h, residual):
        h = _row_parallel(self.dense, h, self.model_group)
        return self.LayerNorm(self.dropout(h) + residual)


class BertLayer(nn.Module):
    """One transformer block: attention -> FFN, both post-LN."""

    def __init__(self, hidden_size, num_heads, intermediate_size, hidden_act,
                 attention_dropout=0.0, hidden_dropout=0.0, fused_qkv=False,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attention = BertAttention(hidden_size, num_heads,
                                       attention_dropout, hidden_dropout,
                                       fused_qkv, **kw)
        self.intermediate = BertIntermediate(hidden_size, intermediate_size,
                                             hidden_act, **kw)
        self.output = BertOutput(intermediate_size, hidden_size,
                                 hidden_dropout, **kw)

    def forward(self, x, attention_bias, output_attention_probs=False):
        attn_out = self.attention(x, attention_bias, output_attention_probs)
        probs = None
        if output_attention_probs:
            attn_out, probs = attn_out
        out = self.output(self.intermediate(attn_out), attn_out)
        return (out, probs) if output_attention_probs else out


class BertEncoder(nn.Module):
    """Stack of BertLayers; per-layer outputs and attention probs are
    returned only when requested. ``remat``: each layer is activation-
    checkpointed in training under grad (see the module docstring)."""

    def __init__(self, num_layers, hidden_size, num_heads, intermediate_size,
                 hidden_act, attention_dropout=0.0, hidden_dropout=0.0,
                 fused_qkv=False, *, dtype=torch.float32, device=None,
                 remat=False):
        super().__init__()
        self.remat = remat
        self.layer = nn.ModuleList([
            BertLayer(hidden_size, num_heads, intermediate_size, hidden_act,
                      attention_dropout, hidden_dropout, fused_qkv,
                      dtype=dtype, device=device)
            for _ in range(num_layers)])

    def forward(self, x, attention_bias, output_all_encoded_layers=False,
                output_attention_probs=False):
        remat = self.remat and self.training and torch.is_grad_enabled() \
            and not output_attention_probs
        all_layers, all_probs = [], []
        for layer in self.layer:
            if remat:
                # the recompute draws the seeds this forward draws; no
                # layer reads torch's RNG, so its state is not kept
                replay = replay_sites(site_state())
                x = checkpoint(layer, x, attention_bias, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=lambda r=replay: (
                                   contextlib.nullcontext(), r))
            else:
                x = layer(x, attention_bias, output_attention_probs)
            if output_attention_probs:
                x, probs = x
                all_probs.append(probs)
            if output_all_encoded_layers:
                all_layers.append(x)
        out = all_layers if output_all_encoded_layers else x
        return (out, all_probs) if output_attention_probs else out


class BertPooler(nn.Module):
    """Tanh projection of the [CLS] position."""

    def __init__(self, hidden_size, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype,
                            device=device)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertPredictionHeadTransform(nn.Module):
    """dense + activation + LayerNorm, before the MLM decoder (and the VQA
    ``mlm`` classifier's first layer)."""

    def __init__(self, hidden_size, hidden_act, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype,
                            device=device)
        self.act = ACT2FN[hidden_act]
        self.LayerNorm = BertLayerNorm(hidden_size, device=device)

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class BertLMPredictionHead(nn.Module):
    """The MLM head: the transform, then the decoder tied to the
    word-embedding table, which the caller passes at each call (it is not
    copied), and a bias. The logits are fp32."""

    def __init__(self, hidden_size, vocab_size, hidden_act, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.transform = BertPredictionHeadTransform(
            hidden_size, hidden_act, dtype=dtype, device=device)
        self.bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, hidden, word_embedding_weight):
        h = self.transform(hidden)
        return F.linear(h, cast(word_embedding_weight, h.dtype)) \
            .to(torch.float32) + self.bias


class BertOnlyMLMHead(nn.Module):
    """Holds the MLM head as ``predictions``, the reference's nesting."""

    def __init__(self, hidden_size, vocab_size, hidden_act, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.predictions = BertLMPredictionHead(
            hidden_size, vocab_size, hidden_act, dtype=dtype, device=device)

    def forward(self, hidden, word_embedding_weight):
        return self.predictions(hidden, word_embedding_weight)
