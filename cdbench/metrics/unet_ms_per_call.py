"""Device milliseconds per UNet call: CUDA events around each call of the
core's ``apply_model`` (a CUDA-graph replay and its copy-out) over the
traced run's whole window."""

UNIT = "ms"
LAYER = "models: models/unet_gd.py under runtime/graphs.py"
MOVES = "images_per_min"


def read(run):
    timed = len(run.recorder.events.get("unet", ()))
    return run.recorder.device_ms("unet") / timed if timed else None
