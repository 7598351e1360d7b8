"""Evaluators (registry extension point ``get_evaluator``): PSNR, MATLAB-style
SSIM, L2, CLIP and directional CLIP of text edits."""
