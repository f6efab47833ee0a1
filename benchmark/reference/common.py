"""What the family references share: TF32 off, the products of the weight
matrices (float32, or the float8 control), and the SGD steps that the
program's first steps are held to."""

from __future__ import annotations

import importlib

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def no_tf32():
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mm_f32(x, w):
    return x @ w


def _fp8(t, dtype, top):
    """``t`` rounded to ``dtype`` under one scale for the whole tensor
    that maps its largest magnitude to the format's largest, as float8
    training scales a tensor; returned in float32."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(torch.float32) / scale


class _FP8MatMul(torch.autograd.Function):
    """``x @ w`` with both operands in e4m3 and, in the backward, the
    incoming gradient in e5m2; products accumulate in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq = _fp8(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = _fp8(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = _fp8(dy, torch.float8_e5m2, E5M2_MAX)
        dx = dyq @ wq.transpose(-1, -2)
        dw = xq.reshape(-1, xq.shape[-1]).transpose(0, 1) @ \
            dyq.reshape(-1, dyq.shape[-1])
        return dx, dw


def mm_fp8(x, w):
    return _FP8MatMul.apply(x, w)


PRECISIONS = {"f32": mm_f32, "fp8": mm_fp8}


def family(name):
    return importlib.import_module(f"{__package__}.{name}")


def train(conf, batches, params, lr, n_steps, precision="f32"):
    """``n_steps`` SGD steps of the data-parallel loss: each step's loss is
    the mean over every rank's rows, as the ranks' mean of their own means
    is, and its gradient the gradient of that mean.  ``batches[k][r]`` is
    rank ``r``'s batch of step ``k``; ``params`` maps a path to a float32
    tensor (left unchanged).  The model and the update are computed in
    float32 (``precision`` "fp8" takes the weight products in float8), and
    the updated parameters are stored in the configuration's
    ``torch_dtype``, as the configuration keeps them between steps.  Rows
    go through the model the family's ``ROWS_PER_CALL`` at a time, their
    gradients summed, so that the reference fits beside nothing else on
    the card.
    Returns ``{"losses": [...], "grad1": {path: (p0 - p1) / lr},
    "gradient": {path: the first step's gradient}, "delta": {path: p_n -
    p0}}`` in float32."""
    fam = family(conf["family"])
    mm = PRECISIONS[precision]
    store = getattr(torch, conf["torch_dtype"])
    cur = {p: t.to(store).float() for p, t in params.items()}
    losses, grad1, gradient = [], None, None
    for k in range(n_steps):
        P = {p: t.clone().requires_grad_(True) for p, t in cur.items()}
        ranks = batches[k]
        n_rows = sum(fam.n_rows(b) for b in ranks)
        # Every rank holds as many rows of one length, so the mean of the
        # ranks' means is the mean over all the scored positions.
        denom = n_rows * fam.positions_per_row(ranks[0])
        total = 0.0
        for b in ranks:
            for lo in range(0, fam.n_rows(b), fam.ROWS_PER_CALL):
                s = fam.loss_sum(conf, P, fam.take_rows(
                    b, lo, lo + fam.ROWS_PER_CALL), mm)
                (s / denom).backward()
                total += float(s.detach())
        losses.append(total / denom)
        with torch.no_grad():
            grads = {p: t.grad if t.grad is not None else torch.zeros_like(t)
                     for p, t in P.items()}
            for p, g in grads.items():
                cur[p] = (cur[p] - lr * g).to(store).float()
            if k == 0:
                gradient = grads
                grad1 = {p: (params[p] - cur[p]) / lr for p in params}
        del P
    with torch.no_grad():
        delta = {p: cur[p] - params[p] for p in params}
    return {"losses": losses, "grad1": grad1, "gradient": gradient,
            "delta": delta}
