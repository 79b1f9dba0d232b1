"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference, and has a limit of its own in the cell's
file (``"limits"``), set from the readings that ``PERF.md`` gives."""

from __future__ import annotations

import statistics

import torch


def rays_gap(program_rays: int, reference_rays: int) -> float:
    """|program - reference| rays traced: the two trace the same paths, so
    the count is exact."""
    return float(abs(int(program_rays) - int(reference_rays)))


def image_rel_rms(program, reference) -> float:
    """RMS of the difference over the RMS of the reference image."""
    p = program.double().cpu()
    r = reference.double().cpu()
    return float(torch.sqrt(torch.mean((p - r) ** 2)) / torch.sqrt(torch.mean(r * r)))


def loss_gap(program_losses, reference_losses) -> float:
    """The widest relative gap between the steps' monitoring losses."""
    return max(abs(p - r) / abs(r) for p, r in zip(program_losses, reference_losses))


def leaf_gap(program: dict, reference: dict, counted) -> float:
    """The worst leaf's gap between the norms: |‖p‖ - ‖r‖| over the larger of
    the reference leaf's norm and the median counted leaf's."""
    norms_r = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in counted}
    floor = statistics.median(norms_r.values())
    return max(abs(float(torch.linalg.vector_norm(program[k].double())) - norms_r[k])
               / max(norms_r[k], floor) for k in counted)


def row_map(program: dict, reference: dict) -> torch.Tensor:
    """The program's material row of each reference row, matched by their
    values at the start (every field at once); the program may hold rows
    that no face uses, which match none."""
    prog = torch.cat([program[k].reshape(program[k].shape[0], -1).double().cpu()
                      for k in reference], dim=1)
    ref = torch.cat([reference[k].reshape(reference[k].shape[0], -1).double().cpu()
                     for k in reference], dim=1)
    dist = torch.cdist(ref, prog, p=1)
    rows = torch.argmin(dist, dim=1)
    if len(set(rows.tolist())) != len(rows) or float(dist.min(dim=1).values.max()) > 1e-6:
        raise ValueError("the program's materials do not match the reference's")
    return rows


def counted_leaves(reference_grads: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding: a norm of
    at least a thousandth of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in reference_grads.items()}
    floor = 1e-3 * statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= floor and n > 0.0]


def checked(name: str, value: float, cell: dict) -> tuple:
    return (name, value, cell["limits"][name])


def reference_settings(ctx, seed: int) -> dict:
    """The configuration's settings as the reference reads them."""
    st = ctx.settings()
    st["seed"] = seed
    return st


def reference_render(ctx, seed: int, on_sample=None, dtype=torch.float32):
    """The plain path tracer's render of the configuration with ``seed``:
    (mean radiance [H, W, 3], rays traced)."""
    from benchmark import scenes
    from benchmark.reference import pack, tracer

    st = reference_settings(ctx, seed)
    mesh, camera = scenes.load(ctx.config)
    scene = pack.pack(mesh, ctx.device, dtype)
    frame = tracer.ray_frame(camera, st["width"], st["height"], ctx.device, dtype)
    with torch.no_grad():
        return tracer.render(scene, st, frame, on_sample)
