"""Causal-prefix-reuse text encoding for candidate scoring (port of
`leaf_tpu/models/prefix_encode.py`).

Every LEAF attack candidate is its clean sentence with one character
edited, so its BPE tokens share a prefix with the clean sentence's tokens
up to the edited word.  Under causal attention the hidden states of that
shared prefix equal the clean sentence's, so the clean batch can be
encoded once a step (`clean_kv`, B sequences), its per-layer K and V kept,
and each candidate runs only its suffix tokens through the stack,
attending to [clean-prefix K/V | its own suffix K/V]
(`encode_text_suffix`).  The key set of every suffix query is that of a
full encode, so the features are the full encode's.  `suffix_split`
(host numpy) finds each candidate's common prefix with its clean sentence
and rolls its suffix into a buffer of width T; `encode_text_suffix_packed`
concatenates G = target // T suffixes a row, each block with its own
gathered prefix K/V, as the towers pack short sequences.

The functions take the port's `clip.TextTower`: its weights, its
activation (GELU or QuickGELU) and its working dtype (`tower.dtype`).
Attention is plain PyTorch with fp32 logits and softmax under an additive
mask, as the JAX package computes it outside any Pallas kernel; the
LayerNorms are the tower's, the LayerNorm op (its kernel on a card).

As in the JAX package, no trainer or attack calls this module: the fused
step and the attack engine encode every candidate in full.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from leaf_tpu_torch.models.clip import TextTower, l2_normalize, text_pool


def _weights(block, dtype) -> dict:
    """A block's attention weights in the working dtype."""
    return {k: v.to(dtype) for k, v in block.attn.items()}


def _embed(tower: TextTower, tokens: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the positional embedding at positions `pos`."""
    x = tower.embed_tokens(tokens)
    return x + tower.positional_embedding.to(x.dtype)[pos]


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], n_heads: int, p: dict) -> torch.Tensor:
    """Attention given projected q [B, Sq, D] and k, v [B, Sk, D]; `mask`
    additive [Sq, Sk] or [B, Sq, Sk], applied to the fp32 logits."""
    B, Sq, D = q.shape
    Sk = k.shape[1]
    hd = D // n_heads

    def heads(t, S):
        return t.reshape(B, S, n_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q, Sq), heads(k, Sk), heads(v, Sk)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) \
        * hd ** -0.5
    if mask is not None:
        m = mask.float()
        if m.dim() == 3:
            m = m[:, None]
        logits = logits + m
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    out = out.transpose(1, 2).reshape(B, Sq, D)
    return out @ p["out_w"] + p["out_b"]


def _layer(block, h: torch.Tensor, k_pre: Optional[torch.Tensor],
           v_pre: Optional[torch.Tensor], mask: Optional[torch.Tensor],
           n_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pre-LN block whose attention sees [k_pre | own keys] (own keys
    alone where `k_pre` is None).  Returns (h, own k, own v)."""
    p = _weights(block, h.dtype)
    qkv = block.ln_1(h) @ p["qkv_w"] + p["qkv_b"]
    q, k, v = qkv.split(h.shape[-1], dim=-1)
    if k_pre is None:
        attn = _mha(q, k, v, mask, n_heads, p)
    else:
        attn = _mha(q, torch.cat([k_pre.to(h.dtype), k], 1),
                    torch.cat([v_pre.to(h.dtype), v], 1), mask, n_heads, p)
    h = h + attn
    return h + block.mlp(block.ln_2(h)), k, v


def _head(tower: TextTower, x: torch.Tensor, suffix_tokens: torch.Tensor,
          normalize: bool) -> torch.Tensor:
    """ln_final -> pool at the suffix's EOT -> projection (+ bias)."""
    x = tower.ln_final(x)
    pooled = text_pool(x, suffix_tokens, tower.cfg.pool_type)
    pooled = pooled @ tower.text_projection.to(pooled.dtype)
    if tower.text_projection_bias is not None:
        pooled = pooled + tower.text_projection_bias.to(pooled.dtype)
    return l2_normalize(pooled) if normalize else pooled


def _suffix_positions(tower: TextTower, prefix_len: torch.Tensor,
                      T: int) -> torch.Tensor:
    pos = prefix_len.long()[:, None] + torch.arange(T, device=prefix_len.device)
    return pos.clamp_max(tower.positional_embedding.shape[0] - 1)


def _neg_inf_where_not(allowed: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    return torch.where(allowed, zero, torch.full_like(zero, -float("inf")))


def clean_kv(tower: TextTower, clean_tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode the clean batch [B, S] one sequence a row and return each
    layer's pre-head K and V, each [L, B, S, D], in the tower's dtype."""
    cfg = tower.cfg
    B, S = clean_tokens.shape
    dev = clean_tokens.device
    x = _embed(tower, clean_tokens, torch.arange(S, device=dev))
    mask = None
    if not cfg.no_causal_mask:
        mask = _neg_inf_where_not(torch.ones(S, S, dtype=torch.bool,
                                             device=dev).tril())
    ks, vs = [], []
    for block in tower.blocks:
        x, k, v = _layer(block, x, None, None, mask, cfg.heads)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def encode_text_suffix(tower: TextTower, suffix_tokens: torch.Tensor,
                       sent_idx: torch.Tensor, prefix_len: torch.Tensor,
                       ks: torch.Tensor, vs: torch.Tensor,
                       normalize: bool = False) -> torch.Tensor:
    """Candidate features [N, output_dim] from suffix tokens only.

    `suffix_tokens[n, t]` is candidate n's token at absolute position
    `prefix_len[n] + t` (0 past its end: argmax-EOT pooling must stay in
    the suffix); `sent_idx[n]` its clean sentence's row of `ks`/`vs`.
    Suffix query t attends to the clean prefix's keys j < prefix_len[n]
    and to the suffix's keys causally: the key set of a full encode."""
    cfg = tower.cfg
    N, T = suffix_tokens.shape
    S = ks.shape[2]
    dev = suffix_tokens.device
    x = _embed(tower, suffix_tokens, _suffix_positions(tower, prefix_len, T))
    # additive mask [N, T, S + T]: prefix keys j < prefix_len, then causal
    j_pre = torch.arange(S, device=dev)[None, None, :] \
        < prefix_len.long()[:, None, None]
    pre = _neg_inf_where_not(j_pre).expand(N, T, S)
    suf = _neg_inf_where_not(torch.ones(T, T, dtype=torch.bool,
                                        device=dev).tril())
    mask = torch.cat([pre, suf[None].expand(N, T, T)], dim=-1)
    idx = sent_idx.long()
    for block, k_pre, v_pre in zip(tower.blocks, ks, vs):
        x, _, _ = _layer(block, x, k_pre[idx], v_pre[idx], mask, cfg.heads)
    return _head(tower, x, suffix_tokens, normalize)


def suffix_split(cand_tokens: np.ndarray, clean_tokens: np.ndarray,
                 sent_idx: np.ndarray, bucket: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: each candidate's common-prefix length with its clean
    sentence and its suffix buffer.

    Returns (suffix_tokens [N, T], prefix_len [N] int32).  prefix_len is
    capped so that every candidate keeps at least its EOT in the suffix (a
    candidate equal to its clean sentence re-derives only its EOT
    position).  `bucket` rounds T up to a multiple (0: the longest
    suffix)."""
    N, S = cand_tokens.shape
    clean = clean_tokens[sent_idx]
    diff = cand_tokens != clean
    any_diff = diff.any(axis=1)
    first_diff = np.where(any_diff, diff.argmax(axis=1), S - 1)
    eot = cand_tokens.argmax(axis=1)
    prefix_len = np.minimum(first_diff, eot).astype(np.int32)
    T = int((S - prefix_len).max())
    if bucket:
        T = int(np.ceil(T / bucket) * bucket)
    idx = prefix_len[:, None] + np.arange(T)[None, :]
    suffix = np.where(idx < S, np.take_along_axis(
        cand_tokens, np.minimum(idx, S - 1), axis=1), 0)
    return suffix.astype(cand_tokens.dtype), prefix_len


def _packed_suffix_masks(T: int, S: int, G: int, device=None):
    """The static parts of the packed mask: the block-diagonal causal
    suffix-to-suffix part [G*T, G*T] (additive) and the block selector
    [G*T, G*S] (query block g sees key block g only; each row's prefix
    length is applied per step)."""
    within = np.tril(np.ones((T, T), bool))
    suf = np.where(np.kron(np.eye(G, dtype=bool), within), 0.0,
                   -np.inf).astype(np.float32)
    blocksel = np.kron(np.eye(G, dtype=bool), np.ones((T, S), bool))
    return (torch.from_numpy(suf).to(device),
            torch.from_numpy(blocksel).to(device))


def encode_text_suffix_packed(tower: TextTower, suffix_tokens: torch.Tensor,
                              sent_idx: torch.Tensor,
                              prefix_len: torch.Tensor, ks: torch.Tensor,
                              vs: torch.Tensor, normalize: bool = False,
                              target: int = 128) -> torch.Tensor:
    """`encode_text_suffix` with G = target // T suffixes a row (fewer
    where G does not divide N; one a row falls back to the unpacked
    form), each block's clean-prefix K/V gathered into the row's prefix
    bundle [G*S]: the same key set for every query as the full encode."""
    cfg = tower.cfg
    N, T = suffix_tokens.shape
    S, D = ks.shape[2], ks.shape[3]
    G = max(1, target // T)
    while G > 1 and N % G:
        G -= 1
    if G <= 1:
        return encode_text_suffix(tower, suffix_tokens, sent_idx, prefix_len,
                                  ks, vs, normalize)
    R = N // G
    dev = suffix_tokens.device
    x = _embed(tower, suffix_tokens, _suffix_positions(tower, prefix_len, T))
    x = x.reshape(R, G * T, D)
    suf, blocksel = _packed_suffix_masks(T, S, G, dev)
    # key j of block g is real iff j < that block's prefix length
    valid = torch.arange(S, device=dev)[None, :] \
        < prefix_len.long().reshape(R, G)[:, :, None]          # [R, G, S]
    pre = _neg_inf_where_not(blocksel[None] & valid.reshape(R, 1, G * S))
    mask = torch.cat([pre, suf[None].expand(R, G * T, G * T)], dim=-1)
    idx = sent_idx.long()
    for block, k_pre, v_pre in zip(tower.blocks, ks, vs):
        x, _, _ = _layer(block, x, k_pre[idx].reshape(R, G * S, D),
                         v_pre[idx].reshape(R, G * S, D), mask, cfg.heads)
    return _head(tower, x.reshape(N, T, D), suffix_tokens, normalize)
