"""CLI flag system for the LEAF trainer (port of
`leaf_tpu/train/params.py`).

The same flag surface as the JAX package's trainer (the open_clip
training flags plus the LEAF attack/objective block, and the
per-model-family default lr/beta/eps), plus `--device`.  Flags whose
code is not ported yet still parse; `train.driver` raises on them.
"""
from __future__ import annotations

import argparse
import ast
from typing import List, Optional

import torch


class _ParseKwargs(argparse.Action):
    """key=value list → dict (reference `params_AT.py:26-35`)."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            if "=" not in value:
                parser.error(
                    f"argument {option_string}: expected key=value, "
                    f"got {value!r}")
            key, value = value.split("=", 1)
            try:
                kw[key] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                kw[key] = str(value)
        setattr(namespace, self.dest, kw)


def parse_args(args: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("leaf_tpu_torch text adversarial finetuning")

    # -- data ---------------------------------------------------------------
    p.add_argument("--train-data", type=str, default=None,
                   help="tar shard spec (brace notation) or csv path")
    p.add_argument("--train-data-upsampling-factors", type=str, default=None)
    p.add_argument("--val-data", type=str, default=None)
    p.add_argument("--val-text-classification", type=str, default=None,
                   help="enable AG-News/SST-2 zero-shot text eval")
    p.add_argument("--train-num-samples", type=int, default=None)
    p.add_argument("--val-num-samples", type=int, default=None)
    p.add_argument("--dataset-type", default="auto",
                   choices=["webdataset", "csv", "synthetic", "auto"])
    p.add_argument("--dataset-resampled", default=False, action="store_true")
    p.add_argument("--csv-separator", type=str, default="\t")
    p.add_argument("--csv-img-key", type=str, default="filepath")
    p.add_argument("--csv-caption-key", type=str, default="title")
    p.add_argument("--imagenet-val", type=str, default=None)
    p.add_argument("--imagenet-v2", type=str, default=None)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--bucket-by-length", default=False, action="store_true",
                   help="group captions of similar token length into the "
                        "same batch (wds train pipeline) so the fused "
                        "attack's per-batch-max context bucket stays small "
                        "on long-tailed alt-text streams. Trade-off: caption "
                        "lengths correlate within a batch")

    # -- run management -----------------------------------------------------
    p.add_argument("--logs", type=str, default="./logs/")
    p.add_argument("--log-local", action="store_true", default=False)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="'latest' or a checkpoint path")
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--save-most-recent", action="store_true", default=False)
    p.add_argument("--delete-previous-checkpoint", action="store_true",
                   default=False)
    p.add_argument("--report-to", default="", type=str,
                   help="comma-sep: wandb,tensorboard")
    p.add_argument("--wandb-notes", default="", type=str)
    p.add_argument("--wandb-project-name", type=str, default="open-clip")
    p.add_argument("--log-every-n-steps", type=int, default=100)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remote-sync", type=str, default=None,
                   help="remote dir the run dir is mirrored to "
                        "(reference params_AT.py:428)")
    p.add_argument("--remote-sync-frequency", type=int, default=300)
    p.add_argument("--remote-sync-protocol", type=str, default="fsspec",
                   choices=["fsspec", "local"])
    p.add_argument("--copy-codebase", action="store_true", default=False,
                   help="snapshot the package into the run dir")

    # -- optimisation -------------------------------------------------------
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=32)
    p.add_argument("--epochs-cooldown", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--beta2", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--wd", type=float, default=0.2)
    p.add_argument("--warmup", type=int, default=10000)
    p.add_argument("--skip-scheduler", action="store_true", default=False)
    p.add_argument("--lr-scheduler", type=str, default="cosine",
                   choices=["cosine", "const", "const-cooldown"])
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--accum-freq", type=int, default=1)
    p.add_argument("--grad-checkpointing", action="store_true", default=False)
    p.add_argument("--profile-dir", default="",
                   help="capture a profiler trace of epoch-0 batches 2-5 "
                        "into this directory")
    p.add_argument("--precision", default="fp32",
                   choices=["fp32", "bf16", "amp"],
                   help="'amp' maps to bf16 compute on fp32 weights, as "
                        "'bf16' does")

    # -- model --------------------------------------------------------------
    p.add_argument("--model", type=str, default="ViT-B-32")
    p.add_argument("--pretrained", type=str, default="",
                   help="local checkpoint path or registry tag")
    p.add_argument("--force-quick-gelu", action="store_true", default=False)
    p.add_argument("--force-patch-dropout", type=float, default=None)
    p.add_argument("--local-loss", action="store_true", default=False,
                   help="per-shard logit rows in the contrastive loss")
    p.add_argument("--gather-with-grad", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="always on (--no-gather-with-grad is rejected)")
    p.add_argument("--siglip", action="store_true", default=False)
    p.add_argument("--distill-model", type=str, default=None)
    p.add_argument("--distill-pretrained", type=str, default=None)
    p.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    p.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0)
    p.add_argument("--image-mean", type=float, nargs="+", default=None,
                   help="override the model's preprocess mean "
                        "(reference params_AT.py:250)")
    p.add_argument("--image-std", type=float, nargs="+", default=None)
    p.add_argument("--image-interpolation", default=None,
                   choices=[None, "bicubic", "bilinear", "random"])
    p.add_argument("--image-resize-mode", default=None,
                   choices=[None, "shortest", "longest", "squash"],
                   help="eval-transform geometry (reference "
                        "params_AT.py:262; train always RandomResizedCrops)")
    p.add_argument("--aug-cfg", nargs="*", default={}, action=_ParseKwargs,
                   help="train augmentation knobs, key=value "
                        "(scale, ratio, color_jitter, color_jitter_prob, "
                        "gray_scale_prob — reference transform.py:62-72)")
    p.add_argument("--force-image-size", type=int, default=None,
                   help="override the vision resolution; pretrained "
                        "position embeddings are bicubic-interpolated "
                        "(reference factory.py:240-242, model.py:523-554)")
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0,
                   help="leave last n image tower groups unlocked "
                        "(LiT; reference params_AT.py:238, contrastive "
                        "trainer only)")
    p.add_argument("--lock-image-freeze-bn-stats", action="store_true",
                   default=False,
                   help="accepted for parity (reference params_AT.py:244); "
                        "a no-op here: the functional towers always "
                        "normalise with the stored running stats — stats "
                        "never update, which IS the frozen behaviour")
    p.add_argument("--lock-text", action="store_true", default=False,
                   help="freeze the text tower (contrastive trainer; "
                        "reference main.py:322-325)")
    p.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    p.add_argument("--lock-text-freeze-layer-norm",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--lock-image", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="default differs per driver (None sentinel): the "
                        "LEAF driver always locks the vision tower and "
                        "rejects an explicit --no-lock-image "
                        "(train_AT_text_only.py:489-490); the contrastive "
                        "trainer defaults to trainable vision and locks "
                        "LiT-style on --lock-image (main.py:316-321)")
    p.add_argument("--zeroshot-frequency", type=int, default=1)
    p.add_argument("--val-frequency", type=int, default=1)

    # -- LEAF attack block (params_AT.py:474-597) ---------------------------
    p.add_argument("--eps_adv", type=float, default=2 / 255,
                   help="image attack L∞ radius")
    p.add_argument("--stepsize_adv", type=float, default=None)
    p.add_argument("--n_steps_adv", type=int, default=10)
    p.add_argument("--use_charmer", action="store_true", default=False,
                   help="use per-sentence Charmer during training")
    p.add_argument("--k_adv", type=int, default=1,
                   help="Levenshtein budget for the training attack")
    p.add_argument("--k_adv_test", type=int, default=1)
    p.add_argument("--rho", type=int, default=20,
                   help="positions/chars sampled per attack round")
    p.add_argument("--n_charmer_test", type=int, default=20)
    p.add_argument("--constrain", action="store_true", default=False,
                   help="no-new-words attack constraint")
    p.add_argument("--n_val_imagenet", type=int, default=1000)
    p.add_argument("--n_val_text", type=int, default=200)
    p.add_argument("--w_fare_text", type=float, default=1.0)
    p.add_argument("--normalize_fare", action="store_true", default=False)
    p.add_argument("--attack_objective", type=str, default="l2",
                   choices=["l2", "negl2", "sim", "dissim"])
    p.add_argument("--text_only", action="store_true", default=True)
    p.add_argument("--custom_out_folder", type=str, default=None)

    # -- device -------------------------------------------------------------
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run: 'cuda' (the default) or "
                        "'cpu'")
    p.add_argument("--mesh-shape", type=str, default=None,
                   help="the data mesh's shape: one entry, the number of "
                        "ranks (the JAX package's 1-D 'data' mesh)")
    p.add_argument("--matmul-precision", type=str, default=None,
                   choices=["default", "high", "highest"])

    ns = p.parse_args(args)
    apply_default_hparams(ns)
    return ns


# --matmul-precision: JAX's `jax_default_matmul_precision` values onto
# `torch.set_float32_matmul_precision`.  JAX's "default" is its fastest
# pass (bf16 inputs on the TPU), torch's "medium" (bf16 internally);
# "high" is TF32 (or bf16x3) in both; "highest" is full fp32 in both.
# Without the flag nothing is set, and torch's own default is "highest".
# The setting reaches cuBLAS and cuDNN only: the hand kernels never read
# it (their fp32 paths keep fp32 accuracy: 3xTF32 split products or
# scalar FMAs), and the fp32 parity limits of the tests and
# `chip_smoke.py` assume TF32 off.
MATMUL_PRECISIONS = {"default": "medium", "high": "high",
                     "highest": "highest"}


def set_matmul_precision(value: Optional[str]) -> None:
    """Apply `--matmul-precision` (see `MATMUL_PRECISIONS`); None keeps
    torch's setting."""
    if value:
        torch.set_float32_matmul_precision(MATMUL_PRECISIONS[value])


def check_mesh_shape(mesh_shape: Optional[str], world: int) -> None:
    """`--mesh-shape`: the JAX package builds a 1-D `data` mesh of that
    shape over all devices, and fails on a shape that does not hold them.
    Here a rank is a device: one entry, equal to the number of ranks.  No
    driver takes a model axis, in the JAX package as here: a (data, model)
    grid is `parallel.sharding.create_grid`'s."""
    if not mesh_shape:
        return
    try:
        shape = tuple(int(x) for x in mesh_shape.split(","))
    except ValueError:
        raise ValueError(f"--mesh-shape {mesh_shape!r}: comma-separated "
                         "integers") from None
    if shape != (world,):
        raise ValueError(
            f"--mesh-shape {mesh_shape!r} does not match the run's "
            f"{world} rank(s): the mesh has one axis, 'data', of one rank "
            "a device (a (data, model) grid is the API "
            "parallel.sharding.create_grid, which no driver reaches)")


def apply_default_hparams(ns: argparse.Namespace):
    """Per-model defaults when unset (`params_AT.py:599-606`)."""
    if "ViT" in ns.model or "coca" in ns.model.lower():
        defaults = {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    else:
        defaults = {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}
    for k, v in defaults.items():
        if getattr(ns, k) is None:
            setattr(ns, k, v)
