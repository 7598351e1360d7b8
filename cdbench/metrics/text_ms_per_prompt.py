"""Device milliseconds per prompt through the text encoder: the CUDA event
pairs of the program's ``graph.text`` span (the conditioning model's
graph replay with its copies in and out) over the prompts it encoded, in
the traced slice."""

from cdbench import program_record

UNIT = "ms"
LAYER = "text encoders: models/text_encoders.py"
MOVES = "images_per_min"


def read(run):
    rec = program_record.recorded()
    timed = [] if rec is None else [r for r in rec.spans.values()
                                    if r.name == "graph.text" and r.timed]
    prompts = sum(r.rows for r in timed)
    if not prompts:
        return None
    return sum(r.device_ms for r in timed) / prompts
