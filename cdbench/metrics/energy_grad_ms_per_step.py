"""Device milliseconds per guided step's energy gradient: CUDA events
around each call of the energy's graphed ``grad`` (its forward and
backward through the first stage's decoder and CLIP's image tower), over
the traced run's whole window."""

UNIT = "ms"
LAYER = "guided sampler and energy: samplers/guided.py, energy/clip_energy.py"
MOVES = "images_per_min"


def read(run):
    timed = len(run.recorder.events.get("energy", ()))
    return run.recorder.device_ms("energy") / timed if timed else None
