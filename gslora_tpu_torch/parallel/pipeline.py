"""GPipe pipeline parallelism over the stacked transformer layers (port of
gslora_tpu/parallel/pipeline.py).

The stacked (L, ...) block and LoRA parameters are split over the
``model`` axis (parallel/sharding: S stages of L/S consecutive layers
each, stage s = model index s), and each rank's rows are cut into M
micro-batches that flow stage to stage through :meth:`DataMesh.shift`
(JAX's ``ppermute`` to s + 1). The schedule is plain GPipe: T = M + S - 1
ticks; at tick t stage s runs its layers on micro-batch t - s. Bubble
ticks compute nothing (JAX computes clipped repeats there whose outputs
never reach the last stage); the shift still runs on every tick but the
last, with zeros where a stage has nothing to send, so every model rank
calls each collective in one order.

Every model rank ends the call holding the last stage's output for the
whole local batch (JAX's psum-mask, pipeline.py:107-110: a SUM over
``model`` of the last stage's outputs and the others' zeros), so the head,
the losses and the evals run replicated over ``model``.

The backward is not left to autograd's ordering of collectives: one
``torch.autograd.Function`` holds the whole schedule. Its forward keeps
each micro-batch's local graph (the stage's layers from a detached input);
its backward runs the reverse schedule explicitly: receive the cotangent
from s + 1 (the last stage takes its own: every rank's head computed the
same one), ``torch.autograd.grad`` through the local layers, send the
input's cotangent to s - 1. It returns the stage parameters' gradients,
summed over the micro-batches, and, on stage 0, the input's (zeros on the
other stages: the embedding's gradient comes from stage 0 alone, and
parallel/sharding.sync_grads sums it over ``model``).

No ViT layer op reduces over the batch dim, so the micro-batched output
equals the whole batch's up to the order of fp sums. Dropout draws each
stage's masks from the rank's own generator, one micro-batch after
another (a rematerialized layer replays its draws in the backward), so a
pp run equals one process at dropout 0 only, as ``--dp`` does.
Composition limits are JAX's (parallel/mesh.check_placement): pp
excludes tp, fsdp and sp.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from gslora_tpu_torch.parallel.mesh import MODEL_AXIS, DataMesh

StageFn = Callable[[torch.Tensor, Sequence[torch.Tensor]], torch.Tensor]


def micro_batches(mesh: DataMesh) -> int:
    """M: ``pp_micro``, or the stage count when it is 0 (JAX's
    ``set_pipeline``)."""
    return mesh.pp_micro if mesh.pp_micro > 0 else mesh.model


def _run(stage: StageFn, x: torch.Tensor, leaves: Sequence[torch.Tensor],
         mesh: DataMesh, keep: bool):
    """The forward ticks. ``keep``: record each micro-batch's graph from
    a detached input (the stage's input needs a gradient on every stage
    but the first, where ``x`` says); returns (output on every model
    rank, [(input, output)] of this stage's micro-batches)."""
    S, s = mesh.model, mesh.model_index
    M = micro_batches(mesh)
    if x.shape[0] % M != 0:
        raise ValueError(f"pipeline: local batch {x.shape[0]} not divisible "
                         f"by pp_micro={M}")
    xs = x.detach().split(x.shape[0] // M)
    outs: List[torch.Tensor] = []
    saved = []
    recv = None
    ticks = M + S - 1
    for t in range(ticks):
        m = t - s
        y = None
        if 0 <= m < M:
            inp = xs[m] if s == 0 else recv
            if keep:
                inp = inp.detach().requires_grad_(s > 0 or x.requires_grad)
            y = stage(inp, leaves)
            if keep:
                saved.append((inp, y))
            if s == S - 1:
                outs.append(y.detach())
        if t < ticks - 1:
            recv = mesh.shift(torch.zeros_like(xs[0]) if y is None
                              else y.detach(), 1)
    out = torch.cat(outs) if s == S - 1 else torch.zeros_like(x)
    mesh.all_reduce_([out], axis=MODEL_AXIS)
    return out, saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage, mesh, x, *leaves):
        with torch.enable_grad():
            params = [p.detach().requires_grad_(p.requires_grad)
                      for p in leaves]
            out, saved = _run(stage, x, params, mesh, keep=True)
        ctx.mesh, ctx.params, ctx.saved = mesh, params, saved
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, params, saved = ctx.mesh, ctx.params, ctx.saved
        S, s = mesh.model, mesh.model_index
        M = len(saved)
        gs = g.contiguous().split(g.shape[0] // M)
        wants = [p for p in params if p.requires_grad]
        sums = [None] * len(wants)
        gx: List[torch.Tensor] = []
        recv = None
        ticks = M + S - 1
        for t in range(ticks):
            m = t - (S - 1 - s)  # the last stage goes first
            g_in = None
            if 0 <= m < M:
                inp, y = saved[M - 1 - m]  # micro-batches in reverse
                cot = gs[M - 1 - m] if s == S - 1 else recv
                inputs = ([inp] if inp.requires_grad else []) + wants
                got = torch.autograd.grad(y, inputs, cot, allow_unused=True)
                if inp.requires_grad:
                    g_in, got = got[0], got[1:]
                for i, gi in enumerate(got):
                    if gi is not None:
                        sums[i] = gi if sums[i] is None else sums[i] + gi
                saved[M - 1 - m] = None  # free the micro-batch's graph
                if s == 0 and g_in is not None:
                    gx.append(g_in)
            if t < ticks - 1:
                recv = mesh.shift(torch.zeros_like(gs[0]) if g_in is None
                                  else g_in, -1)
        ctx.saved = ctx.params = None
        shape, dtype, device = ctx.x_meta
        grad_x = None
        if ctx.needs_input_grad[2]:
            grad_x = torch.cat(gx[::-1]) if gx else \
                torch.zeros(shape, dtype=dtype, device=device)
        it = iter(sums)
        return (None, None, grad_x,
                *(next(it) if p.requires_grad else None for p in params))


def pipeline_stack(x: torch.Tensor, leaves: Sequence[torch.Tensor],
                   stage: StageFn, mesh: DataMesh) -> torch.Tensor:
    """Run ``stage(x_micro, leaves)`` (this stage's L/S layers on one
    micro-batch, from its local parameter ``leaves``) through the GPipe
    schedule over ``model``; (B, n, d) tokens in, the last stage's output
    for the whole local batch out on every model rank. Every model rank
    calls it in lockstep. With autograd recording and anything to
    differentiate, the schedule runs inside :class:`_Pipeline`."""
    if torch.is_grad_enabled() and (x.requires_grad or
                                    any(p.requires_grad for p in leaves)):
        return _Pipeline.apply(stage, mesh, x, *leaves)
    with torch.no_grad():
        return _run(stage, x, leaves, mesh, keep=False)[0]
