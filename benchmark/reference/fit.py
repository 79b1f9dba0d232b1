"""The reference training step of the fit cell: the paired objective of
``pathtracer_tpu_torch/inverse.py`` (two independent one-sample waves, each
residual detached against the other wave's radiance, whose gradient is an
unbiased estimate of d MSE(E[X], target)) differentiated through the plain
path tracer of ``tracer.py``, Adam written out, and the port's clip ranges.

The rows run in blocks, so that the graph of a full-width wave fits: the
objective is a mean over rows, so the blocks' gradients add.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracer

CLIPS = {"mat_Kd": (0.0, 1.0), "mat_Ks": (0.0, 1.0), "mat_Ke": (0.0, None),
         "mat_Ns": (1.0, 499.0)}
BLOCK = 1 << 16


def _rows(scene, st, frame, params, pixel, sample):
    sc = dict(scene, **params)
    rad, _ = tracer.wave(sc, st, frame, pixel, sample)
    # max(x, 0) passes half the gradient at a tie, as the port's
    # ``tonemap.maximum`` does.
    return torch.maximum(rad, torch.zeros((), dtype=rad.dtype, device=rad.device))


def loss_and_grads(scene, st, frame, params, target_rows, sample_a: int, sample_b: int):
    """(monitoring loss, gradients by field) of one paired step over every
    pixel; ``params`` are leaves requiring grad."""
    n = target_rows.shape[0]
    scale = 1.0 / (n * target_rows.shape[1])
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    monitor = torch.zeros((), dtype=torch.float64, device=target_rows.device)
    for s in range(0, n, BLOCK):
        pixel = torch.arange(s, min(s + BLOCK, n), device=target_rows.device)
        tgt = target_rows[s:s + BLOCK]
        rad_a = _rows(scene, st, frame, params, pixel, torch.full_like(pixel, sample_a))
        rad_b = _rows(scene, st, frame, params, pixel, torch.full_like(pixel, sample_b))
        resid_a = rad_a.detach() - tgt
        resid_b = rad_b.detach() - tgt
        surrogate = torch.sum(resid_a * rad_b + resid_b * rad_a) * scale
        g = torch.autograd.grad(surrogate, list(params.values()), allow_unused=True,
                                materialize_grads=True)
        for k, gk in zip(params, g):
            grads[k] += gk
        mean = 0.5 * (rad_a.detach() + rad_b.detach())
        monitor += torch.sum((mean - tgt).double() ** 2) * scale
    return float(monitor), grads


class Adam:
    """Adam (Kingma and Ba), bias-corrected, with no weight decay."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 m: dict | None = None, v: dict | None = None, t: int = 0):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = m if m is not None else {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = v if v is not None else {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = t

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            p -= self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
            lo, hi = CLIPS[k]
            p.clamp_(min=lo, max=hi)


def follow(scene, st, frame, start: dict, target_rows, steps: int, lr: float):
    """The first ``steps`` steps from ``start``: (losses, first gradients,
    Adam's state after the last step, as ``step_from`` takes it). Step i
    draws samples 2i and 2i + 1."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for i in range(steps):
        loss, grads = loss_and_grads(scene, st, frame, params, target_rows, 2 * i, 2 * i + 1)
        losses.append(loss)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
    return losses, first, {"params": {k: v.detach().clone() for k, v in params.items()},
                           "m": opt.m, "v": opt.v, "t": opt.t}


def step_from(scene, st, frame, state: dict, target_rows, step: int, lr: float):
    """Step ``step`` (samples 2 * step and 2 * step + 1) from ``state``, as
    Adam holds it before that step: ``params``, the moments ``m`` and ``v``,
    and ``t`` steps taken. Returns (loss, gradients, parameters after)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state["params"].items()}
    loss, grads = loss_and_grads(scene, st, frame, params, target_rows, 2 * step, 2 * step + 1)
    opt = Adam(params, lr, m={k: v.clone() for k, v in state["m"].items()},
               v={k: v.clone() for k, v in state["v"].items()}, t=state["t"])
    opt.step(grads)
    return loss, grads, {k: v.detach().clone() for k, v in params.items()}
