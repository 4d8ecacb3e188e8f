"""VisualLinguisticBert, the single-stream VL transformer (port of
vlbert_tpu/models/vlbert.py).

Static layout ``[text slots (T) | object slots (O) | END]`` of length
T+O+1, as in the JAX package:
  * text slot i keeps position id ``i + ppi``,
  * every object slot gets position id ``text_len + ppi`` and END gets
    ``text_len + 1 + ppi`` (``ppi = position_padding_idx + 1``),
  * token types: text keeps its ids, objects and END get type 2,
  * the attention mask is ``[text_mask | object_mask | 1]``, applied as the
    additive -10000 key bias of shape [B, 1, 1, L].
Masked slots never influence live positions, so the fixed layout gives the
reference's packed-sequence outputs at every live position.

``VisualLinguisticBertForPretraining`` adds the pretraining heads: the
caption-image relationship, MLM (its decoder tied to ``word_embeddings``)
and masked-region classification (MVRC).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vlbert_tpu_torch.models.bert import (ACT2FN, BertEncoder, BertLayerNorm,
                                          BertOnlyMLMHead, BertPooler)
from vlbert_tpu_torch.models.layers import Embedding, Linear
from vlbert_tpu_torch.ops.dropout import Dropout

NUM_SPECIAL_WORDS = 1000


@dataclasses.dataclass(frozen=True)
class VLBertConfig:
    """Mirror of cfg.NETWORK.VLBERT plus the port's compute dtype, the
    fused-QKV choice and per-layer activation checkpointing (TPU.REMAT)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    visual_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 3
    initializer_range: float = 0.02
    visual_scale_text_init: float = 0.0
    visual_scale_object_init: float = 0.0
    visual_ln: bool = False
    word_embedding_frozen: bool = False
    obj_pos_id_relative: bool = True
    with_pooler: bool = False
    position_padding_idx: int = -1
    visual_region_classes: int = 1601
    dtype: torch.dtype = torch.float32
    fused_qkv: bool = False
    remat: bool = False

    @classmethod
    def from_attrdict(cls, d, dtype=torch.float32, fused_qkv=False,
                      remat=False):
        fields = {f.name for f in dataclasses.fields(cls)} \
            - {"dtype", "fused_qkv", "remat"}
        kwargs = {k: v for k, v in d.items() if k in fields}
        return cls(**kwargs, dtype=dtype, fused_qkv=fused_qkv, remat=remat)


class VisualLinguisticBert(nn.Module):
    def __init__(self, config, *, device=None):
        super().__init__()
        c = self.config = config
        if not c.obj_pos_id_relative:
            # the reference asserts on this branch too
            raise NotImplementedError("obj_pos_id_relative=False")
        kw = dict(dtype=c.dtype, device=device)
        H = c.hidden_size
        self.word_embeddings = Embedding(c.vocab_size, H, **kw)
        self.end_embedding = Embedding(1, H, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings, H,
                                             **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size, H, **kw)
        self.embedding_LayerNorm = BertLayerNorm(H, device=device)
        self.embedding_dropout = Dropout(c.hidden_dropout_prob)

        self.visual_1x1_text = self.visual_1x1_object = None
        if c.visual_size != H:
            self.visual_1x1_text = Linear(c.visual_size, H, **kw)
            self.visual_1x1_object = Linear(c.visual_size, H, **kw)
        if c.visual_ln:
            # LN scale initialized to visual_scale_*_init
            self.visual_ln_text = BertLayerNorm(
                H, scale_init_value=c.visual_scale_text_init, device=device)
            self.visual_ln_object = BertLayerNorm(
                H, scale_init_value=c.visual_scale_object_init,
                device=device)
        else:
            self.visual_scale_text = nn.Parameter(torch.tensor(
                float(c.visual_scale_text_init), device=device))
            self.visual_scale_object = nn.Parameter(torch.tensor(
                float(c.visual_scale_object_init), device=device))
        if c.word_embedding_frozen:
            # trainable table for the first NUM_SPECIAL_WORDS ids
            self.special_word_embeddings = Embedding(NUM_SPECIAL_WORDS, H,
                                                     **kw)
        self.encoder = BertEncoder(
            c.num_hidden_layers, H, c.num_attention_heads,
            c.intermediate_size, c.hidden_act,
            c.attention_probs_dropout_prob, c.hidden_dropout_prob,
            c.fused_qkv, remat=c.remat, **kw)
        if c.with_pooler:
            self.pooler = BertPooler(H, **kw)

    def word_embeddings_wrapper(self, input_ids):
        if self.config.word_embedding_frozen:
            frozen = self.word_embeddings(input_ids).detach()
            special = self.special_word_embeddings(
                input_ids.clamp(0, NUM_SPECIAL_WORDS - 1))
            return torch.where((input_ids < NUM_SPECIAL_WORDS)[..., None],
                               special, frozen)
        return self.word_embeddings(input_ids)

    def _visual(self, x, one_by_one, ln, scale):
        if one_by_one is not None:
            x = one_by_one(x)
        if self.config.visual_ln:
            return ln(x)
        return x * scale.to(x.dtype)

    def embedding(self, text_input_ids, text_token_type_ids,
                  text_visual_embeddings, text_mask,
                  object_vl_embeddings, object_mask):
        """Static-layout concat. Returns (embeddings [B,L,H], mask [B,L])
        with L = T + O + 1."""
        c = self.config
        B, T = text_input_ids.shape
        O = object_vl_embeddings.shape[1]
        dev = text_input_ids.device
        text_input_ids = text_input_ids.long()
        text_mask = text_mask.bool()
        object_mask = object_mask.bool()

        text_vl = self.word_embeddings_wrapper(text_input_ids) + self._visual(
            text_visual_embeddings, self.visual_1x1_text,
            getattr(self, "visual_ln_text", None),
            getattr(self, "visual_scale_text", None))

        obj_vis = self._visual(
            object_vl_embeddings[:, :, :c.visual_size],
            self.visual_1x1_object, getattr(self, "visual_ln_object", None),
            getattr(self, "visual_scale_object", None))
        obj_ling = object_vl_embeddings[:, :, c.visual_size:]
        obj_vl = obj_ling.to(obj_vis.dtype) + obj_vis

        end_tok = self.end_embedding(
            torch.zeros((B, 1), dtype=torch.long, device=dev))
        vl = torch.cat([text_vl, obj_vl.to(text_vl.dtype),
                        end_tok.to(text_vl.dtype)], dim=1)

        token_type_ids = torch.cat([
            text_token_type_ids.long(),
            torch.full((B, O + 1), 2, dtype=torch.long, device=dev)], dim=1)

        ppi = c.position_padding_idx + 1
        text_len = text_mask.long().sum(dim=1, keepdim=True)
        text_pos = (torch.arange(T, device=dev) + ppi).expand(B, T)
        obj_pos = (text_len + ppi).expand(B, O)
        end_pos = text_len + 1 + ppi
        position_ids = torch.cat([text_pos, obj_pos, end_pos], dim=1)

        mask = torch.cat([text_mask, object_mask,
                          torch.ones((B, 1), dtype=torch.bool, device=dev)],
                         dim=1)
        emb = (vl + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        emb = self.embedding_dropout(self.embedding_LayerNorm(emb))
        return emb, mask

    def forward(self, text_input_ids, text_token_type_ids,
                text_visual_embeddings, text_mask,
                object_vl_embeddings, object_mask,
                output_text_and_object_separately=False,
                output_all_encoded_layers=False,
                output_attention_probs=False):
        emb, mask = self.embedding(
            text_input_ids, text_token_type_ids, text_visual_embeddings,
            text_mask, object_vl_embeddings, object_mask)

        # additive -10000 key bias, [B, 1, 1, L] fp32
        bias = (1.0 - mask[:, None, None, :].to(torch.float32)) * -10000.0

        enc = self.encoder(emb, bias,
                           output_all_encoded_layers=output_all_encoded_layers,
                           output_attention_probs=output_attention_probs)
        probs = None
        if output_attention_probs:
            enc, probs = enc
        seq = enc[-1] if output_all_encoded_layers else enc
        pooled = self.pooler(seq) if self.config.with_pooler else None

        if output_text_and_object_separately:
            T = text_input_ids.shape[1]
            O = object_vl_embeddings.shape[1]

            def split(layer):
                # masked text and object slots are zeroed, as the
                # reference's zero-initialized re-split buffers are
                text_out = layer[:, :T] * text_mask[..., None].to(layer.dtype)
                obj_out = layer[:, T:T + O] \
                    * object_mask[..., None].to(layer.dtype)
                return text_out, obj_out

            if output_all_encoded_layers:
                parts = [split(layer) for layer in enc]
                text_out = [p[0] for p in parts]
                obj_out = [p[1] for p in parts]
            else:
                text_out, obj_out = split(seq)
            if output_attention_probs:
                return text_out, obj_out, pooled, probs
            return text_out, obj_out, pooled

        out = enc if output_all_encoded_layers else seq
        if output_attention_probs:
            return out, pooled, probs
        return out, pooled


class MVRCHeadTransform(nn.Module):
    """dense + activation transform."""

    def __init__(self, hidden_size, hidden_act, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype,
                            device=device)
        self.act = ACT2FN[hidden_act]

    def forward(self, x):
        return self.act(self.dense(x))


class VisualLinguisticBertMVRCHead(nn.Module):
    """Masked visual-region classification: fp32 logits over the
    detector's classes."""

    def __init__(self, hidden_size, visual_region_classes, hidden_act, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.transform = MVRCHeadTransform(hidden_size, hidden_act, **kw)
        self.region_cls_pred = Linear(hidden_size, visual_region_classes,
                                      **kw)

    def forward(self, hidden):
        return self.region_cls_pred(self.transform(hidden)).to(torch.float32)


class VisualLinguisticBertRelationshipPredictionHead(nn.Module):
    """Caption-image relationship (NSP-style) from the pooled output."""

    def __init__(self, hidden_size, *, dtype=torch.float32, device=None):
        super().__init__()
        self.caption_image_relationship = Linear(hidden_size, 2, dtype=dtype,
                                                 device=device)

    def forward(self, pooled):
        return self.caption_image_relationship(pooled).to(torch.float32)


# the reference's checkpoints also hold the tied MLM decoder under this
# name: the word-embedding table itself
TIED_DECODER = "mlm_head.predictions.decoder.weight"


class VisualLinguisticBertForPretraining(VisualLinguisticBert):
    """VL-BERT with the relationship, MLM and MVRC heads. As in the
    reference, the heads sit beside the encoder's own parameters, and the
    state dict carries the MLM decoder as ``TIED_DECODER``: written from
    ``word_embeddings.weight`` and dropped on load (the decoder is that
    table)."""

    def __init__(self, config, with_rel_head=True, with_mlm_head=True,
                 with_mvrc_head=True, *, device=None):
        super().__init__(config, device=device)
        c = config
        kw = dict(dtype=c.dtype, device=device)
        self.relationship_head = self.mlm_head = self.mvrc_head = None
        if with_rel_head:
            self.relationship_head = \
                VisualLinguisticBertRelationshipPredictionHead(
                    c.hidden_size, **kw)
        if with_mlm_head:
            self.mlm_head = BertOnlyMLMHead(c.hidden_size, c.vocab_size,
                                            c.hidden_act, **kw)
            self.register_state_dict_post_hook(_write_tied_decoder)
            self.register_load_state_dict_pre_hook(_drop_tied_decoder)
        if with_mvrc_head:
            self.mvrc_head = VisualLinguisticBertMVRCHead(
                c.hidden_size, c.visual_region_classes, c.hidden_act, **kw)

    def forward(self, text_input_ids, text_token_type_ids,
                text_visual_embeddings, text_mask, object_vl_embeddings,
                object_mask):
        """(relationship, MLM, MVRC) fp32 logits, None for a head that is
        off."""
        text_out, obj_out, pooled = super().forward(
            text_input_ids, text_token_type_ids, text_visual_embeddings,
            text_mask, object_vl_embeddings, object_mask,
            output_text_and_object_separately=True)
        rel = mlm = mvrc = None
        if self.relationship_head is not None:
            rel = self.relationship_head(pooled)
        if self.mlm_head is not None:
            mlm = self.mlm_head(text_out, self.word_embeddings.weight)
        if self.mvrc_head is not None:
            mvrc = self.mvrc_head(obj_out)
        return rel, mlm, mvrc


def _write_tied_decoder(module, state_dict, prefix, local_metadata):
    state_dict[prefix + TIED_DECODER] = \
        state_dict[prefix + "word_embeddings.weight"]


def _drop_tied_decoder(module, state_dict, prefix, *args):
    state_dict.pop(prefix + TIED_DECODER, None)
