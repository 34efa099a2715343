"""Text-to-image robustness eval, the Stable Diffusion harness (port of
`leaf_tpu/evals/text_to_image.py`):

    python -m leaf_tpu_torch.evals.text_to_image --model ViT-L-14 \\
        --pretrained <checkpoint> --captions captions.json \\
        [--sd-model-path <SD dir> --robust-text-encoder-hf-dir <HF dir>]

Three stages:

  1. `attack_captions`: Charmer on each caption, anchored on its own
     embedding (drift maximisation); with a second encoder (`--model2`,
     the SDXL pairing) per caption, the two models' losses averaged.
     Runs on `--device` (default cuda) through the port's Charmer.
  2. `generate_images`: latent diffusion with DDIM or PLMS, classifier-
     free guidance and VAE decode.  The loop is written here; loading SD
     weights (`SDComponents.from_pretrained`) needs `diffusers` and
     `transformers`, and raises the JAX package's `RuntimeError` without
     `diffusers`.  Tests inject tiny components instead.  The robust text
     encoder is the HF directory `python -m leaf_tpu_torch.convert --to
     hf` writes.
  3. scoring, with `python -m leaf_tpu_torch.evals.clipscore` over the
     generated folders.

Against the JAX package: the initial latents are drawn from a CPU
generator and then moved to the device, so one seed gives the same
latents on the CPU and on a card (the JAX package draws them on
`device`, and it only runs on the CPU); `SDComponents.from_pretrained`
tokenizes with the port's BPE tokenizer, padding with the checkpoint's
pad token.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.text import (attack_text_charmer_batched,
                                         attack_text_charmer_inference)
from leaf_tpu_torch.models.clip import TextTower
from leaf_tpu_torch.utils.results import ResultsLedger

LOG = logging.getLogger(__name__)


def attack_captions(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    captions: Sequence[str],
    rho: int = 10,
    k: int = 2,
    objective: str = "l2",
    text2: Optional[TextTower] = None,
    scorer2: Optional[CandidateScorer] = None,
    out_csv: Optional[str] = None,
) -> List[str]:
    """Charmer-attack each caption anchored on its own embedding; with
    `text2` (and `scorer2` where its architecture differs) the second
    encoder's loss is averaged in, one caption at a time.  Without it the
    captions go 32 at a time through the batched Charmer (each caption's
    search that of the per-caption attack)."""
    ledger = ResultsLedger(out_csv, fresh=True, stream=True,
                           columns=["caption", "caption_adv"]) \
        if out_csv else None
    out: List[str] = []
    if text2 is None:
        for start in range(0, len(captions), 32):
            chunk = list(captions[start:start + 32])
            anchors = scorer.encode_text(text, tokenizer(chunk))
            out.extend(attack_text_charmer_batched(
                scorer, text, tokenizer, chunk, anchors,
                objective=objective, n=rho, k=k))
    else:
        s2 = scorer2 or scorer
        for cap in captions:
            anchor = scorer.encode_text(text, tokenizer([cap]))[0]
            anchor2 = s2.encode_text(text2, tokenizer([cap]))[0]
            adv, _ = attack_text_charmer_inference(
                scorer, text, tokenizer, cap, anchor, objective=objective,
                n=rho, k=k, text2=text2, anchor_features2=anchor2,
                scorer2=scorer2)
            out.append(adv)
    if ledger is not None:
        for cap, adv in zip(captions, out):
            ledger.append({"caption": cap, "caption_adv": adv})
    return out


def _scheduler_from_config(sched_cfg: Dict) -> str:
    """A checkpoint's `scheduler_config.json` `_class_name` -> the stepping
    algorithm: DDIMScheduler -> "ddim"; PNDMScheduler with
    `skip_prk_steps` (every SD v1.x) -> "pndm" (PLMS); anything else falls
    back to DDIM with a warning, a deviation from the reference pipeline,
    which runs whatever the checkpoint names."""
    name = sched_cfg.get("_class_name", "DDIMScheduler")
    if name == "DDIMScheduler":
        return "ddim"
    if name == "PNDMScheduler":
        if not sched_cfg.get("skip_prk_steps", False):
            LOG.warning(
                "PNDMScheduler with skip_prk_steps=false is not "
                "implemented natively; using DDIM stepping — generated "
                "images will differ from the reference pipeline")
            return "ddim"
        return "pndm"
    LOG.warning(
        "scheduler %s is not implemented natively; using DDIM stepping "
        "— generated images will differ from the reference pipeline "
        "(which runs the checkpoint's own scheduler)", name)
    return "ddim"


class SDComponents:
    """The modules the generation loop needs, decoupled from diffusers.

    Interface:
      tokenize(list[str]) -> LongTensor [B, T]
      text_encoder(ids)   -> FloatTensor [B, T, D] hidden states
      unet(x, t, emb)     -> the model output, same shape as x
      vae_decode(z)       -> images in [-1, 1], NCHW
    """

    def __init__(self, tokenize, text_encoder, unet, vae_decode,
                 latent_channels: int = 4, latent_scale: float = 0.18215,
                 image_size: int = 512, vae_factor: int = 8,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 train_steps: int = 1000, steps_offset: int = 1,
                 prediction_type: str = "epsilon",
                 set_alpha_to_one: bool = False,
                 scheduler: str = "ddim"):
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(
                f"unsupported prediction_type {prediction_type!r} "
                "(epsilon | v_prediction)")
        if scheduler not in ("ddim", "pndm"):
            raise ValueError(
                f"unsupported scheduler {scheduler!r} (ddim | pndm)")
        self.tokenize = tokenize
        self.text_encoder = text_encoder
        self.unet = unet
        self.vae_decode = vae_decode
        self.latent_channels = latent_channels
        self.latent_scale = latent_scale
        self.image_size = image_size
        self.vae_factor = vae_factor
        self.beta_start = beta_start
        self.beta_end = beta_end
        self.train_steps = train_steps
        self.steps_offset = steps_offset
        self.prediction_type = prediction_type
        # SD v1 configs ship set_alpha_to_one=false: the final DDIM step
        # uses alphas_cumprod[0], not exactly 1
        self.set_alpha_to_one = set_alpha_to_one
        self.scheduler = scheduler

    @classmethod
    def from_pretrained(cls, sd_model_path: str,
                        robust_text_encoder_hf_dir: Optional[str] = None,
                        device="cuda") -> "SDComponents":
        """UNet and VAE (diffusers) and the text encoder (transformers)
        from a local SD checkpoint directory, the text encoder optionally
        swapped for the robust one's HF directory.  Captions are
        tokenized by the port's BPE tokenizer at the checkpoint's length,
        padded with its pad token."""
        import json
        import os

        try:
            from diffusers import AutoencoderKL, UNet2DConditionModel
        except ImportError as e:
            raise RuntimeError(
                "loading SD weights requires the `diffusers` package; "
                "run stages 1/3 (attack_captions, compute_clipscores) "
                "standalone, or inject SDComponents directly") from e
        from transformers import CLIPTextModel

        from leaf_tpu_torch.tokenizer import get_tokenizer

        unet = UNet2DConditionModel.from_pretrained(
            sd_model_path, subfolder="unet").eval().to(device)
        vae = AutoencoderKL.from_pretrained(
            sd_model_path, subfolder="vae").eval().to(device)
        te = CLIPTextModel.from_pretrained(
            robust_text_encoder_hf_dir or os.path.join(
                sd_model_path, "text_encoder")).eval().to(device)
        tok_dir = os.path.join(sd_model_path, "tokenizer")
        tok_cfg, special = {}, {}
        for name, into in (("tokenizer_config.json", tok_cfg),
                           ("special_tokens_map.json", special)):
            if os.path.exists(os.path.join(tok_dir, name)):
                with open(os.path.join(tok_dir, name)) as f:
                    into.update(json.load(f))
        pad = special.get("pad_token", "<|endoftext|>")
        pad = pad.get("content") if isinstance(pad, dict) else pad
        bpe = get_tokenizer(int(tok_cfg.get("model_max_length", 77)))
        # SD 1.x pads with the end token, SD 2.x with "!" (id 0)
        pad_id = (bpe.eot_token_id if pad == "<|endoftext|>"
                  else bpe.encoder.get(pad, 0))

        def tokenize(caps):
            ids = torch.from_numpy(np.asarray(bpe(list(caps)))).long()
            after_eot = (torch.arange(ids.shape[1])[None, :]
                         > ids.argmax(dim=-1, keepdim=True))
            return ids.masked_fill(after_eot, pad_id)

        sched_cfg = {}
        sched_json = os.path.join(sd_model_path, "scheduler",
                                  "scheduler_config.json")
        if os.path.exists(sched_json):
            with open(sched_json) as f:
                sched_cfg = json.load(f)
        return cls(
            tokenize=tokenize,
            text_encoder=lambda ids: te(ids).last_hidden_state,
            unet=lambda x, t, emb: unet(
                x, t, encoder_hidden_states=emb).sample,
            vae_decode=lambda z: vae.decode(z).sample,
            latent_channels=unet.config.in_channels,
            image_size=unet.config.sample_size * 8,
            vae_factor=8,
            latent_scale=getattr(vae.config, "scaling_factor", 0.18215),
            beta_start=sched_cfg.get("beta_start", 0.00085),
            beta_end=sched_cfg.get("beta_end", 0.012),
            train_steps=sched_cfg.get("num_train_timesteps", 1000),
            steps_offset=sched_cfg.get("steps_offset", 1),
            prediction_type=sched_cfg.get("prediction_type", "epsilon"),
            set_alpha_to_one=sched_cfg.get("set_alpha_to_one", False),
            scheduler=_scheduler_from_config(sched_cfg))


def generate_images(captions: Sequence[str],
                    sd_model_path: Optional[str] = None,
                    robust_text_encoder_hf_dir: Optional[str] = None,
                    num_inference_steps: int = 50, seed: int = 0,
                    device="cuda", guidance_scale: float = 7.5,
                    components: Optional[SDComponents] = None) -> np.ndarray:
    """Latent-diffusion generation: DDIM (eta = 0) or PLMS (the
    PNDMScheduler `skip_prk_steps` path of SD v1.x), as the checkpoint's
    scheduler config names (`SDComponents.scheduler`), with leading
    timestep spacing + `steps_offset`, classifier-free guidance against
    the empty prompt, latent scaling, VAE decode and a [0, 1] clamp.
    Returns [N, H, W, 3] float32 in [0, 1].

    Pass `components` to run without diffusers; otherwise the weights
    load from `sd_model_path`."""
    c = components if components is not None else SDComponents.from_pretrained(
        sd_model_path, robust_text_encoder_hf_dir, device=device)
    if not 1 <= num_inference_steps <= c.train_steps:
        # the ratio would floor to 0 and every step would be a no-op
        raise ValueError(
            f"num_inference_steps={num_inference_steps} must be in "
            f"[1, {c.train_steps}]")
    B = len(captions)
    # the SD "scaled_linear" beta schedule
    betas = torch.linspace(c.beta_start ** 0.5, c.beta_end ** 0.5,
                           c.train_steps, dtype=torch.float64) ** 2
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
    ratio = c.train_steps // num_inference_steps
    # leading spacing: t_i = i * ratio + steps_offset, descending
    base_ts = torch.arange(num_inference_steps) * ratio + c.steps_offset
    if int(base_ts.max()) > c.train_steps - 1:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} with "
            f"steps_offset={c.steps_offset} yields timestep "
            f"{int(base_ts.max())} past the {c.train_steps}-entry alpha "
            "table; use fewer steps")
    final_alpha = (torch.ones(()) if c.set_alpha_to_one
                   else alphas_cumprod[0].float())
    gen = torch.Generator().manual_seed(seed)
    size = c.image_size // c.vae_factor
    latents = torch.randn(B, c.latent_channels, size, size,
                          generator=gen).to(device)

    def prev_sample_ddim(sample, t, t_prev, out):
        """One DDIM (eta = 0) step from the guided model output."""
        a_t = alphas_cumprod[t].float()
        if c.prediction_type == "v_prediction":
            # v = sqrt(a) eps - sqrt(1 - a) x0  (SD 2.x checkpoints)
            x0 = a_t.sqrt() * sample - (1 - a_t).sqrt() * out
            eps = a_t.sqrt() * out + (1 - a_t).sqrt() * sample
        else:
            eps = out
            x0 = (sample - (1 - a_t).sqrt() * eps) / a_t.sqrt()
        a_prev = (alphas_cumprod[t_prev].float() if t_prev >= 0
                  else final_alpha)
        return a_prev.sqrt() * x0 + (1 - a_prev).sqrt() * eps

    def prev_sample_pndm(sample, t, t_prev, out):
        """The PNDM transfer step (DDIM eta = 0 in the PNDM paper's
        arrangement) on a possibly multistep-combined model output."""
        a_t = alphas_cumprod[t].float()
        a_prev = (alphas_cumprod[t_prev].float() if t_prev >= 0
                  else final_alpha)
        b_t, b_prev = 1 - a_t, 1 - a_prev
        if c.prediction_type == "v_prediction":
            out = a_t.sqrt() * out + b_t.sqrt() * sample
        denom = a_t * b_prev.sqrt() + (a_t * b_t * a_prev).sqrt()
        return (a_prev / a_t).sqrt() * sample \
            - (a_prev - a_t) * out / denom

    with torch.no_grad():
        cond = c.text_encoder(c.tokenize(list(captions)).to(device))
        uncond = c.text_encoder(c.tokenize([""] * B).to(device))
        emb = torch.cat([uncond, cond])

        def predict(x, t):
            # classifier-free guidance on the raw model output
            out = c.unet(torch.cat([x, x]), int(t), emb)
            out_u, out_c = out.chunk(2)
            return out_u + guidance_scale * (out_c - out_u)

        if c.scheduler == "pndm":
            # PLMS: the second timestep is visited twice (the first
            # interval redone with the two outputs' average), then 2-, 3-
            # and 4-point Adams-Bashforth over the stored outputs
            plms_ts = torch.cat(
                [base_ts[:-1], base_ts[-2:-1], base_ts[-1:]]).flip(0)
            ets = []
            cur_sample = None
            for counter, t in enumerate(plms_ts.tolist()):
                out = predict(latents, t)
                if counter != 1:
                    ets = ets[-3:] + [out]
                    t_prev = t - ratio
                else:
                    t_prev = t
                    t = t + ratio
                if len(ets) == 1 and counter == 0:
                    combined, sample = out, latents
                    cur_sample = latents
                elif len(ets) == 1 and counter == 1:
                    combined = (out + ets[-1]) / 2
                    sample, cur_sample = cur_sample, None
                elif len(ets) == 2:
                    combined = (3 * ets[-1] - ets[-2]) / 2
                    sample = latents
                elif len(ets) == 3:
                    combined = (23 * ets[-1] - 16 * ets[-2]
                                + 5 * ets[-3]) / 12
                    sample = latents
                else:
                    combined = (55 * ets[-1] - 59 * ets[-2]
                                + 37 * ets[-3] - 9 * ets[-4]) / 24
                    sample = latents
                latents = prev_sample_pndm(sample, t, t_prev, combined)
        else:
            for t in base_ts.flip(0).tolist():
                latents = prev_sample_ddim(latents, t, t - ratio,
                                           predict(latents, t))
        imgs = c.vae_decode(latents / c.latent_scale)
    imgs = (imgs / 2 + 0.5).clamp(0, 1)
    return imgs.permute(0, 2, 3, 1).float().cpu().numpy()


def main(argv=None) -> List[str]:
    """Command line: stage 1 attacks the captions (optionally against two
    encoders) and writes `captions_adv.{csv,json}`; stage 2 generates the
    clean and adversarial images where `--sd-model-path` is given.  Score
    the folders with `python -m leaf_tpu_torch.evals.clipscore`."""
    import argparse
    import json
    import os

    from leaf_tpu_torch.models.factory import (create_model, get_tokenizer,
                                               local_checkpoint)

    p = argparse.ArgumentParser("leaf_tpu_torch text-to-image eval")
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--pretrained", default=None,
                   help="local HF or OpenCLIP checkpoint file or directory")
    p.add_argument("--model2", default=None,
                   help="second text encoder (SDXL dual-tower attack)")
    p.add_argument("--pretrained2", default=None)
    p.add_argument("--captions", required=True, help="JSON list")
    p.add_argument("--rho", type=int, default=10)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--objective", default="l2")
    p.add_argument("--sd-model-path", default=None)
    p.add_argument("--robust-text-encoder-hf-dir", default=None)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--precision", default="fp32")
    p.add_argument("--output-dir", default="results_t2i")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back to "
                        "the CPU)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    model = create_model(args.model,
                         local_checkpoint(args.pretrained, "--pretrained",
                                          args.model),
                         precision=args.precision, device=args.device,
                         master_weights=True)
    tokenizer = get_tokenizer(args.model)
    scorer = CandidateScorer(model.cfg, model.device)
    text2 = scorer2 = None
    if args.model2:
        model2 = create_model(
            args.model2, local_checkpoint(args.pretrained2, "--pretrained2",
                                          args.model2),
            precision=args.precision, device=args.device,
            master_weights=True)
        text2 = model2.module.text
        # the second encoder scores through its own config
        scorer2 = CandidateScorer(model2.cfg, model2.device)

    with open(args.captions) as f:
        captions = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    adv = attack_captions(
        scorer, model.module.text, tokenizer, captions, rho=args.rho,
        k=args.k, objective=args.objective, text2=text2, scorer2=scorer2,
        out_csv=os.path.join(args.output_dir, "captions_adv.csv"))
    with open(os.path.join(args.output_dir, "captions_adv.json"), "w") as f:
        json.dump(adv, f, indent=2)

    if args.sd_model_path:
        for name, caps in (("clean", captions), ("adv", adv)):
            imgs = generate_images(
                caps, args.sd_model_path,
                robust_text_encoder_hf_dir=args.robust_text_encoder_hf_dir,
                num_inference_steps=args.num_inference_steps,
                device=args.device)
            d = os.path.join(args.output_dir, f"gen_{name}")
            os.makedirs(d, exist_ok=True)
            from PIL import Image
            for i, im in enumerate(imgs):
                Image.fromarray((im * 255).astype("uint8")).save(
                    os.path.join(d, f"{i:05d}.png"))
    else:
        LOG.info("no --sd-model-path: wrote attacked captions only; "
                 "generate with a local SD pipeline, then score via "
                 "`python -m leaf_tpu_torch.evals.clipscore`")
    print(json.dumps({"n": len(adv), "output_dir": args.output_dir}))
    return adv


if __name__ == "__main__":
    main()
