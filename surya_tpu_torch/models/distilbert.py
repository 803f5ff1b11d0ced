"""DistilBERT sequence classifier for OCR error detection, in PyTorch.

Counterpart of surya_tpu/models/distilbert.py: word and learned position
embeddings with a LayerNorm (eps 1e-12), ``n_layers`` post-norm blocks (MHA
through ``ops.attention.sdpa`` with an additive bias from the mask, then an
FFN with the exact GELU), and the classification head on the CLS token
(pre_classifier, ReLU, classifier), logits in float32. LayerNorms run in
fp32 and return the input dtype. Submodule names follow the JAX package's
``init_params`` pytree, so ``nn.load_jax_params`` carries its weights over.
No TPU kernel runs here: the JAX package runs plain ``att.sdpa``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from surya_tpu_torch import nn as pnn
from surya_tpu_torch.ops import attention as att

ID2LABEL = {0: "good", 1: "bad"}


@dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    n_layers: int = 6
    n_heads: int = 12
    dim: int = 768
    hidden_dim: int = 3072
    num_labels: int = 2
    layer_norm_eps: float = 1e-12


class _Layer(nn.Module):
    def __init__(self, config: DistilBertConfig):
        super().__init__()
        d, eps = config.dim, config.layer_norm_eps
        self.q_lin = nn.Linear(d, d)
        self.k_lin = nn.Linear(d, d)
        self.v_lin = nn.Linear(d, d)
        self.out_lin = nn.Linear(d, d)
        self.sa_layer_norm = pnn.LayerNorm(d, eps)
        self.lin1 = nn.Linear(d, config.hidden_dim)
        self.lin2 = nn.Linear(config.hidden_dim, d)
        self.output_layer_norm = pnn.LayerNorm(d, eps)


class DistilBert(nn.Module):
    def __init__(self, config: DistilBertConfig):
        super().__init__()
        self.config = config
        self.word_embeddings = nn.Embedding(config.vocab_size, config.dim)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, config.dim)
        self.embed_layer_norm = pnn.LayerNorm(config.dim, config.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(config) for _ in range(config.n_layers))
        self.pre_classifier = nn.Linear(config.dim, config.dim)
        self.classifier = nn.Linear(config.dim, config.num_labels)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """input_ids [B, S] integer, attention_mask [B, S] (1 = attend).
        Returns float32 classification logits [B, num_labels]."""
        c = self.config
        B, S = input_ids.shape
        hd = c.dim // c.n_heads
        x = self.word_embeddings(input_ids.long()) + self.position_embeddings.weight[:S][None]
        x = self.embed_layer_norm(x)
        bias = torch.where(attention_mask.bool(), 0.0, att.NEG_INF)[:, None, None, :]  # [B, 1, 1, S]
        for layer in self.layers:
            q = layer.q_lin(x).view(B, S, c.n_heads, hd)
            k = layer.k_lin(x).view(B, S, c.n_heads, hd)
            v = layer.v_lin(x).view(B, S, c.n_heads, hd)
            out = att.sdpa(q, k, v, bias=bias).reshape(B, S, c.dim)
            x = layer.sa_layer_norm(x + layer.out_lin(out))
            x = layer.output_layer_norm(x + layer.lin2(F.gelu(layer.lin1(x), approximate="none")))
        h = F.relu(self.pre_classifier(x[:, 0]))
        return self.classifier(h).float()


# -- checkpoint conversion ----------------------------------------------------

def convert_torch(tensors, config: DistilBertConfig) -> dict:
    """The upstream torch checkpoint (DistilBertForSequenceClassification) as
    surya_tpu distilbert's pytree (numpy leaves, JAX layout; surya_tpu
    distilbert.convert_torch)."""
    from surya_tpu_torch.common.weights import TensorBag

    bag = tensors if isinstance(tensors, TensorBag) else TensorBag(tensors)
    layers = []
    for i in range(config.n_layers):
        b = f"distilbert.transformer.layer.{i}"
        layers.append(
            {
                "q_lin": bag.linear(f"{b}.attention.q_lin"),
                "k_lin": bag.linear(f"{b}.attention.k_lin"),
                "v_lin": bag.linear(f"{b}.attention.v_lin"),
                "out_lin": bag.linear(f"{b}.attention.out_lin"),
                "sa_layer_norm": bag.layernorm(f"{b}.sa_layer_norm"),
                "lin1": bag.linear(f"{b}.ffn.lin1"),
                "lin2": bag.linear(f"{b}.ffn.lin2"),
                "output_layer_norm": bag.layernorm(f"{b}.output_layer_norm"),
            }
        )
    params = {
        "word_embeddings": bag.embedding("distilbert.embeddings.word_embeddings"),
        "position_embeddings": bag.embedding("distilbert.embeddings.position_embeddings"),
        "embed_layer_norm": bag.layernorm("distilbert.embeddings.LayerNorm"),
        "layers": layers,
        "pre_classifier": bag.linear("pre_classifier"),
        "classifier": bag.linear("classifier"),
    }
    bag.warn_unused("ocr_error")
    return params
