"""CUDA-graph captures per request in the traced slice: the program's
``graph.captures.*`` counters.  Set-up's warm-up request captures every
signature a cell uses, so 0 is expected; more than 0 says a signature
changed from one request to the next."""

from cdbench import program_record

UNIT = "count"
LAYER = "runtime/graphs.py"
MOVES = "images_per_min"


def read(run):
    rec = program_record.recorded()
    if rec is None:
        return None
    captures = sum(n for name, n in rec.counts.items() if name.startswith("graph.captures."))
    return captures / run.slice_requests
