"""What the program itself recorded in the traced slice: the spans and
counters of ``cyclediffusion_tpu_torch.runtime.profiling``, which record
while ``torch.profiler`` records (the slice, and nothing else of a run).
The per-layer readers of the program's spans and counters read it here."""

from __future__ import annotations


def recorded():
    """The program's ``profiling.recorded()``, or None where the program
    has no such store or the store holds nothing."""
    from cyclediffusion_tpu_torch.runtime import profiling

    read = getattr(profiling, "recorded", None)
    if read is None:
        return None
    rec = read()
    if not rec.spans and not rec.counts:
        return None
    return rec
