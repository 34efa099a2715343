"""PEZ hard-prompt inversion: a CLIP embedding back to a discrete prompt
(port of `leaf_tpu/evals/pez.py`, after "Hard Prompts Made Easy").

The prompt's P slots are continuous embeddings optimised with AdamW,
where each step
  (1) projects every slot to its nearest row of the [V, D] token table by
      cosine similarity (`nn_project`),
  (2) runs the *projected* prompt, between the SOT and EOT embeddings and
      the pad embedding's copies, through the text tower's embeddings-input
      forward (`TextTower.encode_text_embedding`) and scores its
      normalised features against the target features, and
  (3) applies the loss's gradient at the projected point to the continuous
      embeddings (straight-through).
The tower's weights take no gradient during the loop: the backward
computes the input's gradient alone.  Products are fp32 with TF32 off.
The initial ids and the subsampled targets are drawn from a
`torch.Generator` seeded by `seed`; `init_ids` gives the start instead.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from leaf_tpu_torch.evals.zero_shot import fp32_products
from leaf_tpu_torch.models.clip import TextTower, l2_normalize

SOT, EOT, PAD = 49406, 49407, 0


def nn_project(embeds: torch.Tensor, table: torch.Tensor,
               table_normalized: Optional[torch.Tensor] = None):
    """[B, P, D] -> (the projected embeddings [B, P, D], their ids [B, P])
    by cosine similarity against the [V, D] table.  `table_normalized`:
    the table's rows normalised, where the caller keeps them."""
    t = l2_normalize(table) if table_normalized is None else table_normalized
    sims = torch.einsum("bpd,vd->bpv", l2_normalize(embeds), t)
    idx = sims.argmax(dim=-1)
    return table[idx], idx


def optimize_prompt(
    text: TextTower,
    target_features,            # [N, D] image (or text) CLIP features
    prompt_len: int = 8,
    iters: int = 100,
    lr: float = 0.1,
    weight_decay: float = 0.1,
    loss_weight: float = 1.0,
    seed: int = 0,
    batch_size: Optional[int] = None,
    init_ids=None,
) -> Dict:
    """Returns {'ids': the best prompt's ids [P], 'sim': its mean cosine
    similarity, 'per_step_sims': every step's, 'per_step_ids': every
    step's projected ids}.  Decode ids with `tokenizer.decode(ids)`.
    `batch_size` < N subsamples that many targets a step; `init_ids`
    [1, P] replaces the seeded draw of the initial ids."""
    device = text.token_embedding.device
    ctx, vocab = text.cfg.context_length, text.cfg.vocab_size
    g = torch.Generator().manual_seed(seed)
    if init_ids is None:
        init_ids = torch.randint(0, vocab - 2, (1, prompt_len), generator=g)
    init_ids = torch.tensor(np.array(init_ids), dtype=torch.long,
                            device=device)
    if init_ids.shape != (1, prompt_len):
        raise ValueError(f"init_ids {tuple(init_ids.shape)}: expected "
                         f"(1, {prompt_len})")
    n_pad = ctx - prompt_len - 2
    tokens = torch.zeros(1, ctx, dtype=torch.long)
    tokens[0, 0], tokens[0, prompt_len + 1] = SOT, EOT
    tokens = tokens.to(device)

    saved = [p.requires_grad for p in text.parameters()]
    text.requires_grad_(False)
    try:
        with fp32_products():
            table = text.token_embedding.detach().to(text.dtype)
            table_n = l2_normalize(table)
            sot, eot = table[SOT][None, None], table[EOT][None, None]
            pad = table[PAD][None, None].expand(1, n_pad, -1)
            target = l2_normalize(torch.as_tensor(
                target_features).to(device).float())
            prompt = table[init_ids].clone().requires_grad_(True)
            opt = torch.optim.AdamW([prompt], lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=weight_decay)
            n_targets = target.shape[0]
            subsample = batch_size is not None and 0 < batch_size < n_targets
            best_sim, best_ids = -np.inf, None
            history, per_step_ids = [], []
            for _ in range(iters):
                step_target = target
                if subsample:
                    pick = torch.randperm(n_targets, generator=g)[:batch_size]
                    step_target = target[pick.to(device)]
                with torch.no_grad():
                    projected, ids = nn_project(prompt, table, table_n)
                projected.requires_grad_(True)
                full = torch.cat([sot, projected, eot, pad], dim=1)
                feats = text.encode_text_embedding(full, tokens,
                                                   normalize=True)
                mean_sim = (feats.float() @ step_target.T).mean()
                loss = loss_weight * (1.0 - mean_sim)
                prompt.grad, = torch.autograd.grad(loss, projected)
                opt.step()
                sim, ids = float(mean_sim.detach()), ids[0].tolist()
                history.append(sim)
                per_step_ids.append(ids)
                if sim > best_sim:
                    best_sim, best_ids = sim, ids
    finally:
        for p, flag in zip(text.parameters(), saved):
            p.requires_grad_(flag)
    return {"ids": best_ids, "sim": best_sim, "per_step_sims": history,
            "per_step_ids": per_step_ids}
