"""The published ensemble's skip cycle: request ``i`` is the ensemble mix's
request (``drivers/ensemble.py``: one image's encode chain and its
decoder scales' candidates, decoded and ranked) at the skip
``skips[i mod len(skips)]``, so that a window walks the published skips in
turn, each chain as long as the skip makes it.

Parameters (the mix's file): the ensemble mix's, with ``skips`` (the
cycle's order) in place of ``skip``.  Every skip's UNet, first-stage and
text calls have the same shapes, so the warm-up request (index -1, the
cycle's last skip) captures every graph the window replays.
"""

from __future__ import annotations

from cdbench.drivers import ensemble

EXTRA_PARTS = ensemble.EXTRA_PARTS
NUMBERS = ensemble.NUMBERS
images_per_request = ensemble.images_per_request


def skip_of(mix: dict, index: int) -> int:
    return mix["skips"][index % len(mix["skips"])]


def at(mix: dict, index: int) -> dict:
    """The ensemble mix of request ``index``."""
    return dict(mix, skip=skip_of(mix, index))


def work_of_request(cfg: dict, mix: dict, index: int) -> dict:
    """The units of model work of request ``index``, by its own skip."""
    return ensemble.work_per_request(cfg, at(mix, index))


def work_per_request(cfg: dict, mix: dict) -> dict:
    """The mean over one cycle of :func:`work_of_request`."""
    n = len(mix["skips"])
    per = [work_of_request(cfg, mix, i) for i in range(n)]
    return {unit: sum(w[unit] for w in per) / n for unit in per[0]}


def make_request(cfg: dict, mix: dict, seed: int, index: int, device) -> dict:
    req = ensemble.make_request(cfg, at(mix, index), seed, index, device)
    req["skip"] = skip_of(mix, index)
    return req


class Program(ensemble.Program):
    """The ensemble mix's program, its pipeline set to each request's skip."""

    def __init__(self, cfg: dict, mix: dict, seed: int, state_dict: dict, device, dtype,
                 recorder):
        super().__init__(cfg, at(mix, 0), seed, state_dict, device, dtype, recorder)

    def run(self, req: dict) -> dict:
        self.pipe.skip_steps = [req["skip"]]
        return dict(super().run(req), skip=req["skip"])


def program_outputs(out: dict, kept: list, mix: dict) -> dict:
    return ensemble.program_outputs(out, kept, dict(mix, skip=out["skip"]))


def reference_outputs(cfg: dict, mix: dict, parts: dict, req: dict) -> dict:
    return ensemble.reference_outputs(cfg, dict(mix, skip=req["skip"]), parts, req)


def readings(cfg: dict, mix: dict, parts: dict, req: dict, outs: dict) -> dict:
    """The ensemble mix's readings (``ensemble.readings``) at the request's
    own skip."""
    return ensemble.readings(cfg, dict(mix, skip=req["skip"]), parts, req, outs)
