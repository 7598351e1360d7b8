"""Device milliseconds per image through the first stage: CUDA events
around each ``encode_first_stage`` and ``decode_first_stage`` call, over
the images they handled, in the traced run's whole window."""

UNIT = "ms"
LAYER = "models: models/autoencoder.py"
MOVES = "images_per_min"
LAYERS = ("first_stage.encode", "first_stage.decode")


def read(run):
    images = sum(run.recorder.rows.get(k, 0) for k in LAYERS)
    if not images or not any(run.recorder.events.get(k) for k in LAYERS):
        return None
    return sum(run.recorder.device_ms(k) for k in LAYERS) / images
