"""Text-editing evaluator: per-sample CLIP, d-CLIP, PSNR, SSIM and L2, the
translated images as PNGs, and a per-sample CSV (counterpart of
``cyclediffusion_tpu.evaluation.translate_text``).

Images arrive as (original, translated) float HWC [0, 1] pairs.  CLIP
scores come from the shared DirectionalCLIP scorer (``runtime.context``);
without one they are NaN.  The CSV (``{split}_results.csv``) has the JAX
evaluator's columns and rows, NaN written as an empty field.
"""

from __future__ import annotations

import csv
import logging
import math
import os

import numpy as np

from cyclediffusion_tpu_torch.evaluation.utils import (
    calculate_l2,
    calculate_psnr,
    calculate_ssim,
    ensure_empty_dir,
    save_image,
)
from cyclediffusion_tpu_torch.runtime.context import get_directional_clip

logger = logging.getLogger(__name__)

COLUMNS = ["encode_text", "decode_text", "clip", "dclip", "psnr", "ssim", "l2"]


def _cell(value):
    return "" if isinstance(value, float) and math.isnan(value) else value


class Evaluator:
    def __init__(self, args, meta_args):
        self.args = args
        self.meta_args = meta_args
        self.directional_clip = get_directional_clip(required=False)

    def evaluate(self, images, model, weighted_loss, losses, data, split):
        if split not in ("eval", "test"):
            raise ValueError(f"split {split!r}")
        if len(data) != len(images):
            raise ValueError(f"{len(images)} image pairs for {len(data)} samples")
        out_dir = self.meta_args.output_dir
        f_gen = os.path.join(out_dir, "temp_gen")
        ensure_empty_dir(f_gen)

        n = len(images)
        sums = {k: 0.0 for k in ["psnr", "ssim", "l2", "clip", "dclip"]}
        rows = []
        for idx, (original_img, img) in enumerate(images):
            original_img = np.clip(np.asarray(original_img), 0, 1)
            img = np.clip(np.asarray(img), 0, 1)
            if not img.ndim == original_img.ndim == 3:
                raise ValueError(f"images must be HWC, got {img.shape}, {original_img.shape}")
            encode_text = data[idx]["encode_text"]
            decode_text = data[idx]["decode_text"]

            if self.directional_clip is not None:
                clip_s, dclip_s = self.directional_clip(
                    img[None], original_img[None], [encode_text], [decode_text])
                clip_s, dclip_s = float(clip_s[0]), float(dclip_s[0])
            else:
                clip_s = dclip_s = float("nan")

            psnr = calculate_psnr(img, original_img)
            ssim_v = calculate_ssim(img * 255.0, original_img * 255.0)
            l2 = calculate_l2(img, original_img)
            for k, v in [("psnr", psnr), ("ssim", ssim_v), ("l2", l2),
                         ("clip", clip_s), ("dclip", dclip_s)]:
                sums[k] += v
            rows.append([encode_text, decode_text, clip_s, dclip_s, psnr, ssim_v, l2])
            logger.info("sample %d: clip=%.4f dclip=%.4f psnr=%.2f ssim=%.4f l2=%.2f",
                        idx, clip_s, dclip_s, psnr, ssim_v, l2)
            save_image(os.path.join(f_gen, f"{idx}.png"), img)

        with open(os.path.join(out_dir, f"{split}_results.csv"), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(COLUMNS)
            writer.writerows([_cell(v) for v in row] for row in rows)
        return {
            "psnr": sums["psnr"] / n,
            "ssim": sums["ssim"] / n,
            "l2": sums["l2"] / n,
            "clip": sums["clip"] / n,
            "d-clip": sums["dclip"] / n,
        }
