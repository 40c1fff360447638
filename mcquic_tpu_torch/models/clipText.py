"""CLIP's text tower under `CLIPTextModel`'s state-dict names, so that the
published weights load with `strict=True` (the caption encoder,
`utils/textEncoder.py`).

The model (transformers' `modeling_clip.py`, `CLIPTextTransformer`):
  * token and position embeddings, summed;
  * `num_hidden_layers` pre-LN blocks: x + attn(LN1(x)), then x + MLP(LN2(x)),
    the MLP fc1 -> `hidden_act` -> fc2;
  * the final LayerNorm, all with the config's `layer_norm_eps`;
  * the pooled output at the EOS position: the argmax of the ids where the
    config's `eos_token_id` is 2 (the published config: EOS has the largest
    id), else the first position holding `eos_token_id`.

Self-attention is causal and runs through K3 (`ops/attention_cuda.py::
flashAttention`) with one [T, T] mask for the whole batch; on the CPU that
call runs K3's plain version. transformers also masks the padding keys.
The port does not need to: the pooled position is the caption's last real
token, and under the causal mask no row up to it sees the padding after
it, so the pooled output and every row before it are what transformers
computes. `forward` checks that the pooled position is not padding. K3 has
no backward, so the model runs under `torch.no_grad()`.
"""
from typing import Tuple

import torch
from torch import nn

from mcquic_tpu_torch.ops.attention_cuda import flashAttention

# CLIPTextConfig's defaults (openai/clip-vit-base-patch32's text tower)
DEFAULTS = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
                num_attention_heads=8, max_position_embeddings=77, hidden_act="quick_gelu",
                layer_norm_eps=1e-5, eos_token_id=49407)


def textConfig(config: dict) -> dict:
    """The text tower's settings from a `config.json`: a `CLIPTextConfig`'s,
    or the `text_config` of a whole `CLIPConfig`, over the defaults."""
    config = config.get("text_config") or config
    return {key: config.get(key, value) for key, value in DEFAULTS.items()}


def _quickGelu(x):
    return x * torch.sigmoid(1.702 * x)


# the `hidden_act` values CLIP's text configs use
ACTIVATIONS = {"quick_gelu": _quickGelu, "gelu": nn.functional.gelu}


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, width: int, positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.position_embedding = nn.Embedding(positions, width)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(positions)[None]


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        if width % heads:
            raise ValueError(f"hidden_size {width} is not a multiple of {heads} heads")
        self.heads, self.scale = heads, (width // heads) ** -0.5
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.q_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        split = lambda y: y.view(B, T, self.heads, C // self.heads)
        out = flashAttention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                             causal, self.scale)
        return self.out_proj(out.reshape(B, T, C))


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int, act: str):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"hidden_act {act!r} is not one of {sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[act]
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        width, eps = c["hidden_size"], c["layer_norm_eps"]
        self.self_attn = _Attention(width, c["num_attention_heads"])
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.mlp = _Mlp(width, c["intermediate_size"], c["hidden_act"])
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(c) for _ in range(c["num_hidden_layers"]))


class _TextTransformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.embeddings = _Embeddings(c["vocab_size"], c["hidden_size"],
                                      c["max_position_embeddings"])
        self.encoder = _Encoder(c)
        self.final_layer_norm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])


class ClipTextModel(nn.Module):
    """`ClipTextModel(textConfig(config))(ids, mask)` -> (last hidden state
    [n, T, width], pooled [n, width]); `mask` [n, T] marks the real tokens."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = dict(config)
        self.text_model = _TextTransformer(self.config)

    def pooledPositions(self, ids: torch.Tensor) -> torch.Tensor:
        if self.config["eos_token_id"] == 2:
            return ids.to(torch.int32).argmax(-1)
        return (ids == self.config["eos_token_id"]).to(torch.int32).argmax(-1)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
        T = ids.shape[1]
        if T > self.config["max_position_embeddings"]:
            raise ValueError(f"{T} tokens, past max_position_embeddings "
                             f"{self.config['max_position_embeddings']}")
        pooled = self.pooledPositions(ids)
        if mask is not None and not bool(mask.gather(1, pooled[:, None].long()).all()):
            raise ValueError("the pooled position of a caption is padding, where the causal "
                             "mask alone would let it see the padding up to it")
        tm = self.text_model
        x = tm.embeddings(ids)
        causal = torch.ones(T, T, dtype=torch.int8, device=ids.device).tril_()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        return x, x[torch.arange(x.shape[0], device=x.device), pooled.long()]
