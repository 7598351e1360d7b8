"""The share of UNet rows, in %, computed for padding: every launch's rows
(the batch shapes the wrapped ``apply_model`` saw over the traced run's
whole window) less the rows the window's requests need (the mix's driver module's
``real_unet_rows``), over every launch's rows."""

UNIT = "%"
LAYER = "candidate chunking: pipelines/latent_text.py (_pad_launch)"
MOVES = "images_per_min"


def read(run):
    rows = run.recorder.rows.get("unet", 0)
    real = getattr(run.driver, "real_unet_rows", None)
    if not rows or real is None:
        return None
    return 100.0 * (rows - run.requests * real(run.mix)) / rows
