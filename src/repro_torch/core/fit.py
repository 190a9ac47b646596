"""SGD-based non-uniform PWL fitting (paper Sec. IV), in torch.

Counterpart of ``repro/core/fit.py``, step for step:

  1. breakpoints uniformly over [a, b] (or by curvature), values the exact
     f(p_i);
  2. Adam (lr 0.1, betas (0.9, 0.999)) on the continuous MSE
     L = 1/(b-a) ∫ (f̂-f)² dx (trapezoid weights on a dense f32 grid), in
     chunks of ``eval_every`` steps, with a reduce-on-plateau LR;
  3. the escape from local minima: remove the breakpoint whose removal
     costs least, insert one at the midpoint of the segment with the
     largest integrated error, retrain at a lower LR;
  4. until the (remove, insert) pair repeats, or ``max_rounds``.

v_0 and v_{n-1} are derived from the asymptotes (or the exact value at a
range edge), so the outer segments lie on the asymptote lines; p_0 and
p_{n-1} stay learnable.

The fit runs on ``device`` (``cuda`` by default; the CPU only when asked)
and repeats bit for bit there: its gathers sum their gradients without
atomics (``pwl.eval_interp``), its segment sums and cumulative sums are
dense reductions, and the loss reaches the host once per chunk.  On CUDA a
chunk of Adam steps is one CUDA graph, captured once a fit and replayed
(:class:`ChunkGraph`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import functions as F
from . import pwl


@dataclasses.dataclass
class FitConfig:
    lr: float = 0.1
    betas: tuple[float, float] = (0.9, 0.999)  # recorded; the chunk uses (0.9, 0.999)
    eps: float = 1e-8                          # recorded; the chunk uses 1e-8
    max_steps: int = 4000
    eval_every: int = 50
    plateau_patience: int = 4      # evals without improvement before LR cut
    plateau_factor: float = 0.5
    min_lr: float = 1e-4
    rel_tol: float = 1e-5          # stop train() when improvement < rel_tol
    n_grid: int = 8192
    max_rounds: int = 8            # outer remove/insert rounds
    round_lr_decay: float = 0.5    # LR shrink per outer round
    init: str = "uniform"          # "uniform" (paper) | "curvature" (beyond-paper)
    curvature_gamma: float = 0.5   # breakpoint density ∝ |f''|^gamma
    seed: int = 0


def resolve_device(device) -> torch.device:
    """The fit's device; ``cuda`` without a GPU is an error, never a move to
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fitting on cuda (the default) needs a CUDA GPU, and none is "
                           "available; pass device='cpu' to fit on the CPU")
    return device


def _effective_values(spec: F.FunctionSpec, p, v):
    """Apply the boundary condition: v0/vn derived from asymptotes (or edges)."""
    v0 = spec.fn(p[0]) if spec.left_is_edge else spec.m_left * p[0] + spec.c_left
    vn = spec.fn(p[-1]) if spec.right_is_edge else spec.m_right * p[-1] + spec.c_right
    return torch.cat([v0.reshape(1), v[1:-1], vn.reshape(1)])


def _loss_fn(spec: F.FunctionSpec, x, fx, w, p, v, m_l, m_r):
    """Trapezoid MSE on grid x with weights w (∑w = 1).  PRECONDITION: p is
    sorted (the trainer re-sorts p, v and the Adam state after every step,
    outside the differentiated region)."""
    vs = _effective_values(spec, p, v)
    y = pwl.eval_interp(x, p, vs, m_l, m_r)
    return torch.sum(w * (y - fx) ** 2)


def _trapezoid_weights(x):
    dx = x[1:] - x[:-1]
    w = torch.zeros_like(x)
    w[:-1] += dx / 2
    w[1:] += dx / 2
    return w / (x[-1] - x[0])


def _bias_corrections(t0: int, steps: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``1 - b^t`` for t = t0+1 .. t0+steps, in f32, on the device (read by
    index: no host sync a step)."""
    t = torch.arange(t0 + 1, t0 + steps + 1, dtype=torch.float32, device=device)
    b1 = torch.tensor(0.9, dtype=torch.float32, device=device)
    b2 = torch.tensor(0.999, dtype=torch.float32, device=device)
    return 1 - b1 ** t, 1 - b2 ** t


def _adam_steps(spec, p, v, moments, lr, bc1, bc2, x, fx, w, m_l, m_r):
    """One Adam update for each entry of the bias corrections ``bc1``,
    ``bc2``; returns the new (p, v, moments) and the loss of the last
    step, a device scalar."""
    mp, vp, mv, vv = moments
    b1, b2 = 0.9, 0.999
    last = None
    for k in range(bc1.shape[0]):
        p_, v_ = p.detach().requires_grad_(True), v.detach().requires_grad_(True)
        loss = _loss_fn(spec, x, fx, w, p_, v_, m_l, m_r)
        gp, gv = torch.autograd.grad(loss, (p_, v_))
        last = loss.detach()
        with torch.no_grad():
            mp = b1 * mp + (1 - b1) * gp
            vp = b2 * vp + (1 - b2) * gp ** 2
            mv = b1 * mv + (1 - b1) * gv
            vv = b2 * vv + (1 - b2) * gv ** 2
            p = p - lr * (mp / bc1[k]) / (torch.sqrt(vp / bc2[k]) + 1e-8)
            v = v - lr * (mv / bc1[k]) / (torch.sqrt(vv / bc2[k]) + 1e-8)
            # keep breakpoints sorted (re-sort params + Adam state consistently)
            order = torch.argsort(p, stable=True)
            p, v = p[order], v[order]
            mp, vp, mv, vv = mp[order], vp[order], mv[order], vv[order]
    return p, v, (mp, vp, mv, vv), last


class ChunkGraph:
    """A chunk of Adam steps captured once into a CUDA graph and replayed
    for every later chunk of one fit (the breakpoint count, the grid and
    the chunk length stay fixed through its rounds).  A step is ~140 small
    kernels, whose launches one by one cost the host more time than the
    card spends on them.  The first chunk runs eagerly on a side stream
    (autograd's and the allocator's warm-up, as capture needs) and is the
    capture's template: a replay runs the same kernels on the same inputs,
    so its bits are the eager chunk's."""

    def __init__(self):
        self.graph = None
        self.static = self.out = None

    def __call__(self, spec, *inputs):
        """``_adam_steps(spec, p, v, moments, lr, bc1, bc2, x, fx, w, m_l,
        m_r)`` through the graph."""
        p, v, moments, lr, bc1, bc2, *consts = inputs
        flat = (p, v, *moments, lr, bc1, bc2)
        if self.graph is not None:
            for dst, src in zip(self.static, flat):
                dst.copy_(src)
            self.graph.replay()
            out = [t.clone() for t in self.out]
            return out[0], out[1], tuple(out[2:6]), out[6]
        self.static = [t.clone() for t in flat]

        def run():
            sp, sv, *rest = self.static
            sp, sv, mom, last = _adam_steps(spec, sp, sv, tuple(rest[:4]), *rest[4:], *consts)
            return [sp, sv, *mom, last]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = run()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run()
        return first[0], first[1], tuple(first[2:6]), first[6]


def _adam_chunk(spec, steps, p, v, state, lr, x, fx, w, m_l, m_r, graph=None):
    """``steps`` Adam updates from ``state = (mp, vp, mv, vv, t)`` (t counts
    the steps of the whole ``_train``), eagerly or through ``graph`` (a
    :class:`ChunkGraph`, on CUDA); returns the new (p, v, state) and the
    loss of the last step, a device scalar."""
    mp, vp, mv, vv, t = state
    bc1, bc2 = _bias_corrections(t, steps, p.device)
    run = graph if graph is not None else _adam_steps
    p, v, moments, last = run(spec, p, v, (mp, vp, mv, vv), lr, bc1, bc2, x, fx, w, m_l, m_r)
    return p, v, (*moments, t + steps), last


def _train(spec, p, v, lr, cfg: FitConfig, x, fx, w, m_l, m_r, graph=None):
    """Adam until plateau; reduce-on-plateau LR schedule."""
    state = tuple(torch.zeros_like(p) for _ in range(4)) + (0,)
    best = float("inf")
    best_pv = (p, v)
    stale = 0
    steps_done = 0
    cur_lr = lr
    while steps_done < cfg.max_steps and cur_lr >= cfg.min_lr:
        lr32 = torch.tensor(cur_lr, dtype=torch.float32, device=p.device)
        p, v, state, last = _adam_chunk(spec, cfg.eval_every, p, v, state, lr32,
                                        x, fx, w, m_l, m_r, graph=graph)
        steps_done += cfg.eval_every
        last = float(last)  # the chunk's one host sync
        if last < best * (1 - cfg.rel_tol):
            best, best_pv, stale = last, (p, v), 0
        else:
            stale += 1
            if stale >= cfg.plateau_patience:
                cur_lr *= cfg.plateau_factor
                stale = 0
    return best_pv[0], best_pv[1], best


def _removal_losses(spec, p, v, cfg, x, fx, w, m_l, m_r) -> np.ndarray:
    """Loss after deleting breakpoint i, for each interior i (1..n-2): entry
    k is i = k + 1."""
    n = p.shape[0]
    if n < 3:
        return np.zeros(0, np.float32)
    keep = torch.from_numpy(np.stack([np.delete(np.arange(n), i) for i in range(1, n - 1)]))
    keep = keep.to(p.device)
    with torch.no_grad():
        losses = [_loss_fn(spec, x, fx, w, p[k], v[k], m_l, m_r) for k in keep]
    return torch.stack(losses).cpu().numpy()


def _insertion_losses(spec, p, v, cfg, x, fx, w, m_l, m_r) -> np.ndarray:
    """ℓ_i^ins = ∫_{p_i}^{p_{i+1}} (f̂-f)² dx for each inner segment i."""
    with torch.no_grad():
        order = torch.argsort(p, stable=True)
        ps = p[order]
        vs = _effective_values(spec, ps, v[order])
        y = pwl.eval_interp(x, ps, vs, m_l, m_r)
        err2 = (y - fx) ** 2 * w * (x[-1] - x[0])  # un-normalized integrand
        seg = torch.clamp(torch.searchsorted(ps, x, right=True) - 1, 0, ps.shape[0] - 2)
        inside = (x >= ps[0]) & (x <= ps[-1])
        seg_loss = pwl.segment_sum(torch.where(inside, err2, 0.0), seg, ps.shape[0] - 1)
    return seg_loss.cpu().numpy()


def _second_derivative(spec: F.FunctionSpec, x):
    """f''(x) elementwise, by autograd twice (0 where f' is constant)."""
    t = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(spec.fn(t).sum(), t, create_graph=True)
    if not g.requires_grad:
        return torch.zeros_like(x)
    (d2,) = torch.autograd.grad(g.sum(), t, allow_unused=True)
    return torch.zeros_like(x) if d2 is None else d2


def _cumsum(a, block: int = 64):
    """Inclusive cumulative sum of a 1-D tensor that repeats bit for bit on
    CUDA (torch's 1-D CUDA cumsum is a scan whose order depends on timing):
    prefix sums within rows of ``block`` and of the rows' totals, each a
    reduction over a triangular mask."""
    n = a.shape[0]
    rows = -(-n // block)
    padded = torch.cat([a, a.new_zeros(rows * block - n)]).reshape(rows, block)
    tri = torch.ones(block, block, dtype=torch.bool, device=a.device).tril()
    within = torch.where(tri, padded[:, None, :], 0.0).sum(dim=-1)
    tri_rows = torch.ones(rows, rows, dtype=torch.bool, device=a.device).tril(-1)
    before = torch.where(tri_rows, within[None, :, -1], 0.0).sum(dim=-1)
    return (within + before[:, None]).reshape(-1)[:n]


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: linear interpolation in increasing ``xp``,
    the ends clamped to ``fp[0]`` and ``fp[-1]``."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def curvature_init(spec, n_breakpoints, lo, hi, gamma=0.5, n_grid=4096, device="cpu"):
    """Beyond-paper init: equidistribute breakpoints w.r.t. |f''|^gamma.

    For PWL interpolation the per-segment L2 error scales ~ f''(x)^2 h^5, so
    the asymptotically optimal segment width is h ∝ |f''|^(-1/2), i.e. the
    breakpoint *density* ∝ |f''|^(1/2).
    """
    x = pwl.linspace_f32(lo, hi, n_grid, device=device)
    d2 = _second_derivative(spec, x).detach()
    dens = d2.abs() ** gamma + 1e-3 * torch.max(d2.abs() ** gamma)
    cdf = _cumsum(dens)
    cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
    targets = pwl.linspace_f32(0.0, 1.0, n_breakpoints, device=device)
    p = interp(targets, cdf, x)
    # guarantee strict monotonicity (flat-CDF regions can collide breakpoints)
    steps = torch.arange(n_breakpoints, dtype=torch.float32, device=device) * 1e-6
    return torch.maximum(p, p[0] + steps)


@dataclasses.dataclass
class FitResult:
    table: pwl.PWLTable  # host (CPU) tensors
    mse: float
    mae: float
    history: list
    n_breakpoints: int
    range: tuple[float, float]


def fit(
    spec_or_name,
    n_breakpoints: int,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    cfg: Optional[FitConfig] = None,
    device="cuda",
) -> FitResult:
    """Fit a non-uniform PWL table to ``spec`` on [lo, hi] (paper Sec. IV)
    on ``device``; the table comes back on the host."""
    spec = F.get(spec_or_name) if isinstance(spec_or_name, str) else spec_or_name
    cfg = cfg or FitConfig()
    dev = resolve_device(device)
    if lo is None or hi is None:
        lo, hi = spec.default_range
    x = pwl.linspace_f32(lo, hi, cfg.n_grid, device=dev)
    fx = spec.fn(x)
    w = _trapezoid_weights(x)

    if cfg.init == "curvature":
        p = curvature_init(spec, n_breakpoints, lo, hi, cfg.curvature_gamma, device=dev)
    else:
        p = pwl.linspace_f32(lo, hi, n_breakpoints, device=dev)
    v = spec.fn(p)
    m_l, m_r = pwl.boundary_slopes(spec, p)

    graph = ChunkGraph() if dev.type == "cuda" else None
    history = []
    p, v, best = _train(spec, p, v, cfg.lr, cfg, x, fx, w, m_l, m_r, graph)
    history.append(("init_train", best))

    lr = cfg.lr * cfg.round_lr_decay
    last_move = None
    for rnd in range(cfg.max_rounds):
        rm = _removal_losses(spec, p, v, cfg, x, fx, w, m_l, m_r)
        if not rm.size:
            break
        i_rm = int(np.argmin(rm)) + 1  # the first minimum, as min() over JAX's dict
        pn = np.delete(p.cpu().numpy(), i_rm)
        vn = np.delete(v.cpu().numpy(), i_rm)
        ins = _insertion_losses(spec, torch.from_numpy(pn).to(dev),
                                torch.from_numpy(vn).to(dev), cfg, x, fx, w, m_l, m_r)
        i_ins = int(np.argmax(ins))
        move = (i_rm, i_ins)
        p_new = np.insert(pn, i_ins + 1, (pn[i_ins] + pn[i_ins + 1]) / 2)
        v_new = np.insert(vn, i_ins + 1, (vn[i_ins] + vn[i_ins + 1]) / 2)
        p2, v2, best2 = _train(spec, torch.from_numpy(p_new).to(dev),
                               torch.from_numpy(v_new).to(dev), lr, cfg, x, fx, w, m_l, m_r,
                               graph)
        history.append((f"round{rnd}_rm{i_rm}_ins{i_ins}", best2))
        if best2 < best:
            p, v, best = p2, v2, best2
        if move == last_move:
            break
        last_move = move
        lr = max(lr * cfg.round_lr_decay, cfg.min_lr)

    # recompute boundary slopes at final boundary breakpoints (edge tangents move)
    m_l, m_r = pwl.boundary_slopes(spec, p)
    v_eff = _effective_values(spec, p, v)
    t = pwl.params_to_coeffs(p, v_eff, m_l, m_r, name=spec.name)
    table = pwl.PWLTable(bp=t.bp.cpu(), m=t.m.cpu(), q=t.q.cpu(), name=spec.name)
    return FitResult(
        table=table,
        mse=pwl.mse(table, spec, lo, hi, cfg.n_grid),
        mae=pwl.mae(table, spec, lo, hi, cfg.n_grid),
        history=history,
        n_breakpoints=n_breakpoints,
        range=(lo, hi),
    )
