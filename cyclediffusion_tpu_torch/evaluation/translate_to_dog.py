"""AFHQ -> dog evaluator (counterpart of
``cyclediffusion_tpu.evaluation.translate_to_dog``): PSNR, SSIM and L2 of
each translated image against its source, the images saved as
``temp_gen/<i>.png``, then FID and KID against the AFHQ dog test split
(``stargan-v2/data/test/dog``, 512 -> 256 bilinear), on the task model's
device.  The dog set is decoded once per process; without it FID and KID
are skipped with a warning.  A metric key carries the feature kind unless
it is Inception's (``fid_moment_feat``; see ``evaluation.fid``).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from cyclediffusion_tpu_torch.data.preprocess.afhqcat256 import load_afhq
from cyclediffusion_tpu_torch.data.preprocess.common import resolve_path
from cyclediffusion_tpu_torch.data.transforms import list_image_files_recursively
from cyclediffusion_tpu_torch.evaluation.fid import compute_fid_kid
from cyclediffusion_tpu_torch.evaluation.utils import (
    calculate_l2,
    calculate_psnr,
    calculate_ssim,
    ensure_empty_dir,
    save_image,
)

logger = logging.getLogger(__name__)

REF_ROOT = "stargan-v2/data/test/dog"

# the decoded reference set, the same for every eval round
_REF_CACHE: dict = {}


def reference_images() -> list:
    """The dog test split as float32 (256, 256, 3) arrays ([] if absent)."""
    if "images" not in _REF_CACHE:
        ref_root = resolve_path(REF_ROOT)
        if os.path.isdir(ref_root):
            _REF_CACHE["images"] = [load_afhq(f)
                                    for f in list_image_files_recursively(ref_root)]
        else:
            logger.warning("reference dog set missing at %s; FID/KID skipped", ref_root)
            _REF_CACHE["images"] = []
    return _REF_CACHE["images"]


class Evaluator:
    def __init__(self, args, meta_args):
        self.args = args
        self.meta_args = meta_args

    def evaluate(self, images, model, weighted_loss, losses, data, split):
        if split not in ("eval", "test"):
            raise ValueError(f"split {split!r}")
        f_gen = os.path.join(self.meta_args.output_dir, "temp_gen")
        ensure_empty_dir(f_gen)
        ref_images = reference_images()

        n = len(images)
        all_psnr = all_ssim = all_l2 = 0.0
        gen_images = []
        for idx, (original_img, img) in enumerate(images):
            original_img = np.clip(np.asarray(original_img), 0, 1)
            img = np.clip(np.asarray(img), 0, 1)
            if not img.ndim == original_img.ndim == 3:
                raise ValueError(f"images must be HWC, got {img.shape}, {original_img.shape}")
            all_psnr += calculate_psnr(img, original_img)
            all_ssim += calculate_ssim(img * 255.0, original_img * 255.0)
            all_l2 += calculate_l2(img, original_img)
            gen_images.append(img)
            save_image(os.path.join(f_gen, f"{idx}.png"), img)

        summary = {"psnr": all_psnr / n, "ssim": all_ssim / n, "l2": all_l2 / n}
        if ref_images:
            fid_score, kid_score, feat_kind = compute_fid_kid(
                np.stack(gen_images), np.stack(ref_images), device=model.device)
            suffix = "" if feat_kind == "inception" else f"_{feat_kind}_feat"
            summary[f"kid{suffix}"] = kid_score
            summary[f"fid{suffix}"] = fid_score
        return summary
