"""Device milliseconds per chain step of the sampler's own arithmetic,
not the model call: the program's ``sampler.*`` spans (the DPM-Encoder's
posterior sample and eps recovery, the DDIM step, the guided update, CFG's
dual batch and combine) over its ``sampler.steps`` counter, in the traced
slice.  The program times a sample of each span's calls on the device
(CUDA event pairs); each span's mean over its timed calls stands for all
its calls."""

from cdbench import program_record

UNIT = "ms"
LAYER = "pipeline, sampler: samplers/{ddim,guided}.py, ops/{steps,cfg}.py"
MOVES = "images_per_min"


def read(run):
    rec = program_record.recorded()
    if rec is None:
        return None
    timed = [r for r in rec.spans.values() if r.name.startswith("sampler.") and r.timed]
    steps = rec.counts.get("sampler.steps", 0)
    if not timed or not steps:
        return None
    return sum(r.device_ms / r.timed * r.calls for r in timed) / steps
