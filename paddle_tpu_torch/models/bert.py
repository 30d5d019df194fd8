"""BERT family (baseline config 3: BERT-base pretraining).

Counterpart of ``paddle_tpu/models/bert.py``, the same code on the port's
Paddle surface: learned embeddings, a post-LN transformer encoder, and the
MLM and NSP heads. Each encoder layer's attention is
``F.scaled_dot_product_attention`` with no dropout, so without an
``attention_mask`` it runs the flash kernels (forward, and the fused
backward at BERT's shapes); a mask (additive ``[B, 1, 1, S]``) takes the
plain attention.
"""
from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
import paddle_tpu_torch.nn.functional as F


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_seq_len=512,
                 type_vocab_size=2, dropout=0.1, dtype="float32"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.dtype = dtype


def bert_base(**overrides):
    return BertConfig(**overrides)


def bert_large(**overrides):
    cfg = dict(hidden_size=1024, num_layers=24, num_heads=16,
               intermediate_size=4096)
    cfg.update(overrides)
    return BertConfig(**cfg)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_seq_len,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = paddle.arange(s)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertEncoderLayer(nn.Layer):
    """Post-LN encoder block (original BERT ordering)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.out = nn.Linear(h, h)
        self.attn_norm = nn.LayerNorm(h)
        self.fc1 = nn.Linear(h, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, h)
        self.ffn_norm = nn.LayerNorm(h)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        hd = h // self.num_heads

        def split(t):
            return t.reshape([b, s, self.num_heads, hd])

        attn = F.scaled_dot_product_attention(
            split(self.q(x)), split(self.k(x)), split(self.v(x)),
            attn_mask=attn_mask, dropout_p=0.0, is_causal=False,
            training=self.training,
        ).reshape([b, s, h])
        x = self.attn_norm(x + self.dropout(self.out(attn)))
        ffn = self.fc2(F.gelu(self.fc1(x)))
        return self.ffn_norm(x + self.dropout(ffn))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = nn.LayerList(
            [BertEncoderLayer(cfg) for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            mask = (attention_mask.astype("float32") - 1.0) * 1e9
            mask = mask.reshape([x.shape[0], 1, 1, x.shape[1]])
        for layer in self.layers:
            x = layer(x, mask)
        pooled = paddle.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Layer):
    """MLM + NSP heads (BERT pretraining objective)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.bert = BertModel(cfg)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size)
        self.nsp = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        mlm_logits = paddle.matmul(
            h, self.bert.embeddings.word_embeddings.weight, transpose_y=True)
        nsp_logits = self.nsp(pooled)
        return mlm_logits, nsp_logits

    def loss(self, input_ids, mlm_labels, nsp_labels=None,
             token_type_ids=None, attention_mask=None, ignore_index=-100):
        mlm_logits, nsp_logits = self(input_ids, token_type_ids,
                                      attention_mask)
        v = self.config.vocab_size
        flat_logits = mlm_logits.reshape([-1, v])
        flat_labels = mlm_labels.reshape([-1])
        mask = (flat_labels != ignore_index).astype("float32")
        safe_labels = paddle.where(
            flat_labels == ignore_index,
            paddle.zeros_like(flat_labels), flat_labels)
        per_tok = F.cross_entropy(flat_logits, safe_labels, reduction="none")
        mlm_loss = (per_tok.reshape([-1]) * mask).sum() / mask.sum().clip(min=1.0)
        if nsp_labels is None:
            return mlm_loss
        nsp_loss = F.cross_entropy(nsp_logits, nsp_labels.reshape([-1]))
        return mlm_loss + nsp_loss
