"""Blocking host-device synchronisations per request in the traced slice:
the calls of the program's ``sync.*`` spans (a pageable host copy, a
``tolist``).  Each drains the device's queue, and the device then idles
until the host issues again."""

from cdbench import program_record

UNIT = "count"
LAYER = "host: blocking syncs in the pipeline and core"
MOVES = "images_per_min"


def read(run):
    rec = program_record.recorded()
    if rec is None:
        return None
    calls = sum(r.calls for r in rec.spans.values() if r.name.startswith("sync."))
    return calls / run.slice_requests
