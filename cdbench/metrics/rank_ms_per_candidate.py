"""Device milliseconds per ranked candidate: CUDA events around each call
of the pipeline's ``rank`` (the DirectionalCLIP text, original and
candidate embeddings and the scores) over the candidates it ranked, in the
traced run's whole window."""

UNIT = "ms"
LAYER = "ranking: pipelines/latent_text.py rank over energy/clean_clip.py"
MOVES = "images_per_min"


def read(run):
    n = run.recorder.rows.get("rank", 0)
    if not n or not run.recorder.events.get("rank"):
        return None
    return run.recorder.device_ms("rank") / n
