"""ESM2 protein language model as a torch nn.Module (inference); mirrors
`dfmdock_tpu/models/esm2.py`.

The reference embeds chains with fairseq `esm2_t33_650M_UR50D`.  This is the
same architecture written out: pre-LN blocks, HuggingFace rotary embeddings
over the head dimension, exact GELU, the token-dropout rescale at eval and a
-1e9 bias on padded keys.  Attention is plain products and a float32
softmax, as in the JAX package (which runs it outside any Pallas kernel).
`convert_hf_esm` maps a HuggingFace `EsmModel` state dict onto the module;
`load_hf_esm2` reads a locally cached HuggingFace model only (no network).

The module's parameter names follow the JAX package's pytree paths
(`layers.3.attn.q.weight` for "layers/3/attn/q/w"), so `params.to_state_dict`
of that pytree loads into it.

ESM2-650M: 33 layers, hidden 1280, 20 heads, FFN 5120, vocab 33, rotary.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The ESM alphabet (fairseq ordering; HF EsmTokenizer vocab matches).
ESM_TOKENS = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
TOKEN_TO_ID = {t: i for i, t in enumerate(ESM_TOKENS)}
CLS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
MASK_ID = TOKEN_TO_ID["<mask>"]
MASK_RATIO_TRAIN = 0.15 * 0.8
HF_ESM2_650M = "facebook/esm2_t33_650M_UR50D"
PAD_BIAS = -1e9


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    vocab_size: int = 33
    hidden_size: int = 1280
    num_layers: int = 33
    num_heads: int = 20
    intermediate_size: int = 5120
    layer_norm_eps: float = 1e-5
    token_dropout: bool = True


ESM2_650M = ESM2Config()


def tokenize(seq: str, pad_to: int | None = None) -> np.ndarray:
    """<cls> + residues + <eos> (+ <pad>...), as int32 ids."""
    ids = [CLS_ID] + [TOKEN_TO_ID.get(a, UNK_ID) for a in seq] + [EOS_ID]
    if pad_to is not None:
        ids += [PAD_ID] * (pad_to - len(ids))
    return np.asarray(ids, np.int32)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary(q, k):
    """HF ESM rotary embeddings over head_dim (inv_freq 10000^(-2i/d));
    q, k [L, heads, hd]."""
    L, _, hd = q.shape
    inv_freq = 1.0 / (10000 ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=q.device) / hd))
    freqs = torch.outer(torch.arange(L, dtype=torch.float32, device=q.device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb)[:, None, :], torch.sin(emb)[:, None, :]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


class Attention(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.q, self.k, self.v, self.out = (nn.Linear(h, h) for _ in range(4))

    def forward(self, x, mask_bias):
        L, H = x.shape
        nh = self.cfg.num_heads
        hd = H // nh
        ln = self.ln(x)
        q = self.q(ln).reshape(L, nh, hd) / math.sqrt(hd)
        k = self.k(ln).reshape(L, nh, hd)
        v = self.v(ln).reshape(L, nh, hd)
        q, k = rotary(q, k)
        scores = torch.einsum("qhd,khd->hqk", q, k) + mask_bias
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("hqk,khd->qhd", probs, v).reshape(L, H)
        return x + self.out(ctx)


class FFN(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return x + self.fc2(F.gelu(self.fc1(self.ln(x)), approximate="none"))


class Block(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.attn = Attention(cfg)
        self.ffn = FFN(cfg)

    def forward(self, x, mask_bias):
        return self.ffn(self.attn(x, mask_bias))


class ESM2(nn.Module):
    def __init__(self, cfg: ESM2Config = ESM2_650M):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights drawn on the generator's device: N(0, std)
        matrices and embeddings, zero biases, unit norms."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln." in name or name.startswith("final_ln"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * std)
        return self

    def forward(self, tokens: torch.Tensor, num_layers: int | None = None) -> torch.Tensor:
        """tokens [L] int -> last hidden states [L, H] (float32), as HF
        EsmModel's last_hidden_state for one sequence.  `num_layers` runs
        only the first blocks (then the final LayerNorm)."""
        attn_mask = (tokens != PAD_ID).to(torch.float32)
        x = self.embed[tokens.long()]
        if self.cfg.token_dropout:
            is_mask = tokens == MASK_ID
            x = torch.where(is_mask[:, None], 0.0, x)
            mask_ratio_obs = is_mask.sum() / attn_mask.sum()
            x = x * (1 - MASK_RATIO_TRAIN) / (1 - mask_ratio_obs)
        x = x * attn_mask[:, None]
        mask_bias = (1.0 - attn_mask) * PAD_BIAS
        for layer in self.layers[:num_layers]:
            x = layer(x, mask_bias)
        return self.final_ln(x)


def esm2_apply(model: ESM2, tokens) -> torch.Tensor:
    """tokens [L] (numpy or tensor) -> last hidden states [L, H] (f32)."""
    param = model.embed
    return model(torch.as_tensor(np.asarray(tokens), device=param.device))


@torch.no_grad()
def embed_sequence(model: ESM2, seq: str) -> torch.Tensor:
    """[L] sequence -> [L, H] per-residue embeddings (specials stripped)."""
    return esm2_apply(model, tokenize(seq))[1 : len(seq) + 1]


def convert_hf_esm(sd: dict, cfg: ESM2Config) -> dict:
    """HF EsmModel state dict (numpy or torch values) -> ESM2's state dict."""
    a = lambda k: torch.as_tensor(np.asarray(sd[k]), dtype=torch.float32)
    out = {"embed": a("embeddings.word_embeddings.weight")}

    def put(dst, src):
        out[f"{dst}.weight"] = a(f"{src}.weight")
        out[f"{dst}.bias"] = a(f"{src}.bias")

    for i in range(cfg.num_layers):
        pre, dst = f"encoder.layer.{i}", f"layers.{i}"
        put(f"{dst}.attn.ln", f"{pre}.attention.LayerNorm")
        for name, hf in (("q", "query"), ("k", "key"), ("v", "value")):
            put(f"{dst}.attn.{name}", f"{pre}.attention.self.{hf}")
        put(f"{dst}.attn.out", f"{pre}.attention.output.dense")
        put(f"{dst}.ffn.ln", f"{pre}.LayerNorm")
        put(f"{dst}.ffn.fc1", f"{pre}.intermediate.dense")
        put(f"{dst}.ffn.fc2", f"{pre}.output.dense")
    put("final_ln", "encoder.emb_layer_norm_after")
    return out


def weights_unavailable(model_name: str, err: Exception) -> RuntimeError:
    """The JAX package's error for ESM2 weights that are not on this machine."""
    return RuntimeError(
        f"ESM2 weights unavailable locally ({err}). Either provide "
        "precomputed embeddings (npz input with rec_x/lig_x), download "
        f"{model_name} into the HF cache, or run with "
        "--one-hot-only (requires a model trained without ESM)."
    )


def load_hf_esm2(model_name: str = HF_ESM2_650M, cfg: ESM2Config = ESM2_650M,
                 device="cpu") -> ESM2:
    """ESM2 with the locally cached HF weights of `model_name` (no network);
    raises `weights_unavailable` when transformers or the weights are
    missing."""
    try:
        from transformers import EsmModel

        hf = EsmModel.from_pretrained(model_name, local_files_only=True)
    except (ImportError, OSError, ValueError) as e:
        raise weights_unavailable(model_name, e) from e
    model = ESM2(cfg)
    model.load_state_dict(convert_hf_esm(hf.state_dict(), cfg))
    return model.to(device).eval()
