"""A whole run with the timed path broken underneath comes out not
correct: once for each fault a one-card training cell can have (a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest; an answer altered where it is produced).  The
exchange between cards does not exist in these cells."""
from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import run_cell


def _unchanged(monkeypatch, job):
    from leaf_tpu_torch.train import optim

    def update(self, step):
        grads = [p.grad for p in self.parameters() if p.grad is not None]
        norm = optim.global_norm(grads)
        self.adamw.zero_grad(set_to_none=True)
        return norm
    monkeypatch.setattr(optim.Optimizer, "update", update)


def _half(monkeypatch, job):
    if job == "leaf":
        from leaf_tpu_torch.train import fused
        make = fused.make_fused_train_only

        def half_only(*args, **kwargs):
            step = make(*args, **kwargs)
            return lambda state, adv1, anch1, adv2, anch2: step(
                state, adv1[:len(adv1) // 2], anch1[:len(adv1) // 2],
                adv1[len(adv1) // 2:], anch1[len(adv1) // 2:])
        monkeypatch.setattr(fused, "make_fused_train_only", half_only)
    else:
        from leaf_tpu_torch.train import fare
        loss = fare.embedding_loss

        def half_rows(loss_str, embedding, embedding_orig, *args, **kwargs):
            n = len(embedding) // 2
            return loss(loss_str, embedding[:n], embedding_orig[:n], *args,
                        **kwargs)
        monkeypatch.setattr(fare, "embedding_loss", half_rows)


def _answer(monkeypatch, job):
    if job == "leaf":
        from leaf_tpu_torch.train import fused
        score = fused._score

        def worst(text, tokens, anchors, objective):
            B, N, C = tokens.shape
            feats = text.encode_text(tokens.reshape(B * N, C))
            loss = fused.objective_loss(feats.reshape(B, N, -1).float(),
                                        anchors.float(), objective)
            return loss.argmin(dim=-1)
        assert score is not None
        monkeypatch.setattr(fused, "_score", worst)
    else:
        from leaf_tpu_torch.train import fare

        def no_attack(loss_fn, images, norm, eps, iterations, stepsize,
                      mode="max", momentum=0.9, perturbation=None):
            return (images + perturbation).clamp(0.0, 1.0)
        monkeypatch.setattr(fare, "pgd", no_attack)


@pytest.mark.parametrize("fault", [_unchanged, _half, _answer],
                         ids=["unchanged", "half", "answer"])
@pytest.mark.parametrize("workload", ["tiny.leaf", "tiny.fare"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, workload,
                                      fault):
    fault(monkeypatch, workload.split(".")[1])
    torch.manual_seed(0)
    result, _ = run_cell(tiny_root, workload, 2 ** 32 + 5, 0.5, False, "cpu",
                         time.perf_counter())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
