"""The GS-LoRA(++) forgetting train step (port of gslora_tpu/engine/forget.py).

One call runs forward(forget) + forward(remain) (or one forward over
both with ``fused_batch``), L_forget / L_remain / L_structure /
L_prototype, the gradient of the trainable subtree and the AdamW update,
in place. Loss weights (beta/alpha/lr/bnd...) come in per call as a
scalar dict, so per-epoch schedules need no rebuild.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from gslora_tpu_torch.config import ForgetConfig, LoraConfig, RunConfig, \
    ViTConfig
from gslora_tpu_torch.engine.state import ForgetState
from gslora_tpu_torch.lora.core import group_lasso
from gslora_tpu_torch.losses.classification import (bounded_forget_loss,
                                                    cross_entropy,
                                                    top1_accuracy)
from gslora_tpu_torch.losses.prototype import hinged_prototype_losses, \
    prototype_loss
from gslora_tpu_torch.models.vit import vit_apply
from gslora_tpu_torch.ops.group_lasso import fp32_threshold, lora_group_prox
from gslora_tpu_torch.parallel.mesh import data_parallel_size
from gslora_tpu_torch.parallel.multihost import check_local_feed
from gslora_tpu_torch.parallel.sharding import sp_on, sync_grads
from gslora_tpu_torch.utils.trees import PairwiseSum


def make_forget_step(model: ViTConfig, lora: LoraConfig, fcfg: ForgetConfig,
                     optimizer, compute_dtype=torch.bfloat16,
                     use_prototype: Optional[bool] = None,
                     structure_mode: str = "loss",
                     lora_apply: str = "factored",
                     fused_batch: bool = False,
                     trainable: str = "lora",
                     grad_accum: int = 1, mesh=None):
    """Build the dual-batch train step.

    step(state, xf, yf, xr, yr, protos, scalars, generator) ->
    (state, metrics); ``state`` is updated in place and returned.
    scalars: dict of floats {beta, alpha, lr, bnd, bnd_pro, w_pro_f,
    w_pro_r}; metrics: dict of 0-dim tensors, the JAX step's keys.

    structure_mode:
      "loss" — reference-faithful: alpha * group-Lasso as a differentiated
               term (engine.py:269-274);
      "prox" — the group soft-threshold (kernel K2) applied to the LoRA
               after the optimizer update, threshold fp32(lr)·fp32(alpha);
               no structure term in the loss. FFN LoRA only.

    trainable: "lora" (only the LoRA subtree updates) or "base" (all base
    parameters, the reference's lora_rank=0 path); the state must be
    created with the same value.

    grad_accum > 1 runs each dual batch as that many micro-batch pairs,
    exactly: ``relu(BND - CE_f)`` and ``relu(BND_pro - L_pro_f)`` gate on
    the GLOBAL batch means, so a forward-only gate pass first takes the
    masked sums of every data term (the global means, the gates and the
    metrics), then a grad pass differentiates the gated-linear surrogate,
    whose micro-gradients sum to the full-batch gradient. Each micro-batch
    draws the same dropout masks in both passes (its generator state is
    saved before the gate pass and restored for the grad pass); gradients
    add up in fp32, as a tree (utils/trees.PairwiseSum), as do the sums.
    A batch that grad_accum does not divide (in either
    stream) runs unaccumulated, as in the JAX step.

    ``mesh`` (parallel/mesh.DataMesh): each rank passes its rows of the
    global batch pair and the step computes the one-device loss over the
    GLOBAL batch, as the JAX step does under a mesh. The gates and the
    means are nonlinear in the global masked sums, so the step always runs
    the gated-linear scheme above: the masked sums and counts of every
    data term are summed over the ranks (one all_reduce) before the gates,
    each rank differentiates its share of the surrogate divided by the
    global counts, and one all_reduce (SUM) over flat buckets of the
    trainable gradients gives every rank the full-batch gradient. DDP's
    mean of per-rank gradients would need each rank's loss already divided
    by the global count and its gates taken on global means, which is this
    scheme with an extra wrapper. With grad_accum 1 the sums come from the
    same forward that is differentiated (one forward per step); with
    grad_accum > 1 each rank microbatches its own rows in the two passes.
    On a ``(dcn, data, model)`` mesh the sums and the gradients go over
    the batch axis (dcn x data) only: the ranks of one model group hold
    the same rows, and the model's collectives (parallel/sharding) give
    each of them the whole gradient of its own leaves; fsdp shards come
    summed over ``data`` out of the backward, and ``sync_grads`` sums them
    over ``dcn``. Under sp and pp a rank's gradient of a leaf
    held whole inside the stack (or of the embedding) is its part over
    ``model`` (its tokens; stage 0's), and ``sync_grads`` sums those over
    that axis too; under sp the structure term, whose gradient every rank
    holds whole, is then differentiated on its own and added after the
    sums, so that it counts once.
    """
    use_proto = fcfg.prototype if use_prototype is None else use_prototype
    if structure_mode not in ("loss", "prox"):
        raise ValueError(f"unknown structure_mode {structure_mode!r}")
    use_prox = structure_mode == "prox"
    if use_prox and lora.rank > 0 and lora.pos != "FFN":
        # the prox handles the FFN placement only; training with no
        # structure pressure at all would corrupt experiments
        raise ValueError(
            "structure_mode='prox' supports lora_pos='FFN' only; use the "
            "reference-faithful structure_mode='loss' for Attention LoRA")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    train_base = trainable == "base"
    # under sp the LoRA's gradients are summed over ``model``: the
    # structure term joins after the sums
    late_structure = sp_on(mesh) and not use_prox and not train_base

    def forward(params, xf, yf, xr, yr, generator):
        """Dual-stream forward -> (logits_f, emb_f, logits_r, emb_r)."""
        kw = dict(train=True, generator=generator,
                  compute_dtype=compute_dtype, lora_apply=lora_apply)
        if fused_batch:
            # one forward over [forget; remain] — fewer, bigger matmuls
            logits, emb = vit_apply(params, torch.cat([xf, xr]),
                                    torch.cat([yf, yr]), model, lora, **kw)
            nf = xf.shape[0]
            return logits[:nf], emb[:nf], logits[nf:], emb[nf:]
        logits_f, emb_f = vit_apply(params, xf, yf, model, lora, **kw)
        logits_r, emb_r = vit_apply(params, xr, yr, model, lora, **kw)
        return logits_f, emb_f, logits_r, emb_r

    def structure(params):
        if use_prox:
            return torch.zeros(())
        return group_lasso(params["lora"], fcfg.group_type, fcfg.group_pos)

    def loss_fn(params, xf, yf, xr, yr, protos, sc, generator):
        logits_f, emb_f, logits_r, emb_r = forward(params, xf, yf, xr, yr,
                                                   generator)
        ce_r = cross_entropy(logits_r, yr)
        l_forget = bounded_forget_loss(logits_f, yf, sc["bnd"])
        l_struct = structure(params)
        if use_proto:
            l_proto, l_pro_f_hinged, l_pro_r = hinged_prototype_losses(
                emb_f, yf, emb_r, yr, protos,
                w_forget=sc["w_pro_f"], w_remain=sc["w_pro_r"],
                bnd_pro=sc["bnd_pro"], distance=fcfg.prototype_distance)
        else:
            l_proto = l_pro_f_hinged = l_pro_r = torch.zeros(())
        total = sc["beta"] * l_forget + ce_r + sc["alpha"] * l_struct + \
            l_proto
        metrics = {
            "loss_total": total,
            "loss_forget": sc["beta"] * l_forget,
            "loss_remain": ce_r,
            "loss_structure": sc["alpha"] * l_struct,
            "loss_prototype_forget": sc["w_pro_f"] * l_pro_f_hinged,
            "loss_prototype_remain": sc["w_pro_r"] * l_pro_r,
            "acc_forget": top1_accuracy(logits_f, yf),
            "acc_remain": top1_accuracy(logits_r, yr),
        }
        return total, metrics

    def micro_sums(params, xf, yf, xr, yr, protos, generator):
        """Masked per-sample SUMS (and valid counts) of every data term
        over one micro-batch pair: each loss is a masked mean with a
        max(valid, 1) denominator, so mean * valid is the masked sum (an
        all-padding micro-batch adds 0)."""
        logits_f, emb_f, logits_r, emb_r = forward(params, xf, yf, xr, yr,
                                                   generator)
        wf = torch.sum((yf >= 0).float())
        wr = torch.sum((yr >= 0).float())
        s = {"nf": wf, "nr": wr,
             "ce_f": cross_entropy(logits_f, yf) * wf,
             "ce_r": cross_entropy(logits_r, yr) * wr,
             "acc_f": top1_accuracy(logits_f, yf) * wf,
             "acc_r": top1_accuracy(logits_r, yr) * wr}
        if use_proto:
            dist = fcfg.prototype_distance
            s["pro_f"] = prototype_loss(emb_f, yf, protos, dist) * wf
            s["pro_r"] = prototype_loss(emb_r, yr, protos, dist) * wr
        return s

    def gates(sums, params, sc):
        """The global means, the relu gates and the step's metrics from the
        masked sums over the whole (global) batch pair."""
        nf = torch.clamp(sums["nf"], min=1.0)
        nr = torch.clamp(sums["nr"], min=1.0)
        ce_f, ce_r = sums["ce_f"] / nf, sums["ce_r"] / nr
        l_forget = torch.relu(sc["bnd"] - ce_f)
        # relu' is 0 AT the kink, so the gate is the strict inequality
        gate_f = (sc["bnd"] - ce_f > 0).float()
        l_struct = structure(params)
        if use_proto:
            l_pro_f, l_pro_r = sums["pro_f"] / nf, sums["pro_r"] / nr
            hinged = torch.relu(sc["bnd_pro"] - l_pro_f)
            gate_p = (sc["bnd_pro"] - l_pro_f > 0).float()
            l_proto = sc["w_pro_f"] * hinged + sc["w_pro_r"] * l_pro_r
        else:
            hinged = l_pro_r = l_proto = gate_p = torch.zeros(())
        total = sc["beta"] * l_forget + ce_r + sc["alpha"] * l_struct + \
            l_proto
        metrics = {
            "loss_total": total,
            "loss_forget": sc["beta"] * l_forget,
            "loss_remain": ce_r,
            "loss_structure": sc["alpha"] * l_struct,
            "loss_prototype_forget": sc["w_pro_f"] * hinged,
            "loss_prototype_remain": sc["w_pro_r"] * l_pro_r,
            "acc_forget": sums["acc_f"] / nf,
            "acc_remain": sums["acc_r"] / nr,
        }
        return (nf, nr, gate_f, gate_p), metrics

    def surrogate(s, g, params, sc, share):
        """The gated-linear loss of one micro-batch pair's sums ``s``: its
        gradient is that pair's part of the full-batch gradient. The
        data-independent structure term enters with weight ``share``, the
        pair's fraction of all pairs over all ranks."""
        nf, nr, gate_f, gate_p = g
        out = (-sc["beta"] * gate_f * s["ce_f"]) / nf + s["ce_r"] / nr
        if use_proto:
            out = out + (-sc["w_pro_f"] * gate_p * s["pro_f"]) / nf \
                + sc["w_pro_r"] * s["pro_r"] / nr
        if not train_base and not use_prox and not late_structure:
            out = out + sc["alpha"] * group_lasso(
                params["lora"], fcfg.group_type, fcfg.group_pos) * share
        return out

    def global_sums(sums):
        """Detached sums, summed over the ranks under a mesh."""
        sums = {k: v.detach() for k, v in sums.items()}
        if mesh is not None:
            keys = sorted(sums)
            flat = torch.stack([sums[k].float() for k in keys])
            mesh.all_reduce_([flat])
            sums = dict(zip(keys, flat.unbind()))
        return sums

    def accum_grads(state, names, leaves, xf, yf, xr, yr, protos, sc,
                    generator, n):
        """Gradients over ``n`` micro-batch pairs of this rank's rows,
        equal to the full-batch gradient (JAX ``_accum_grads``,
        forget.py:177-261)."""
        params = state.params
        world = data_parallel_size(mesh)
        micros = list(zip(*(t.split(t.shape[0] // n)
                            for t in (xf, yf, xr, yr))))
        if n == 1:
            # one pass: the gates come from this forward's detached sums
            s = micro_sums(params, *micros[0], protos, generator)
            g, metrics = gates(global_sums(s), params, sc)
            grads = [gi.float() for gi in torch.autograd.grad(
                surrogate(s, g, params, sc, 1.0 / world), leaves)]
        else:
            # phase 1: forward only; each micro-batch's generator state
            # first
            gen_states, sums = [], PairwiseSum()
            with torch.no_grad():
                for mb in micros:
                    gen_states.append(generator.get_state()
                                      if generator is not None else None)
                    s = micro_sums(params, *mb, protos, generator)
                    keys = sorted(s)
                    sums.add([s[k] for k in keys])
            g, metrics = gates(global_sums(dict(zip(keys, sums.total()))),
                               params, sc)
            # phase 2: the gated-linear surrogate, same dropout masks
            acc = PairwiseSum()
            for mb, gen_state in zip(micros, gen_states):
                if generator is not None:
                    generator.set_state(gen_state)
                s = micro_sums(params, *mb, protos, generator)
                acc.add([gi.float() for gi in torch.autograd.grad(
                    surrogate(s, g, params, sc, 1.0 / (n * world)),
                    leaves)])
            grads = acc.total()
        sync_grads(mesh, names, grads)
        if late_structure:
            grads = [gr + gs.float() for gr, gs in zip(
                grads, torch.autograd.grad(sc["alpha"] * group_lasso(
                    params["lora"], fcfg.group_type, fcfg.group_pos),
                    leaves))]
        return [gr.to(p.dtype) for gr, p in zip(grads, leaves)], metrics

    def step(state: ForgetState, xf, yf, xr, yr, protos,
             scalars: Dict[str, float], generator=None):
        if state.trainable != trainable:
            raise ValueError(f"state trains {state.trainable!r}, the step "
                             f"{trainable!r}")
        if mesh is not None:  # each rank feeds its rows, not the batch
            check_local_feed(mesh, xf.shape[0])
            check_local_feed(mesh, xr.shape[0])
        leaves = state.trainable_params()
        names = state.trainable_names()
        if grad_accum > 1 and xf.shape[0] % grad_accum == 0 and \
                xr.shape[0] % grad_accum == 0:
            grads, metrics = accum_grads(state, names, leaves, xf, yf, xr,
                                         yr, protos, scalars, generator,
                                         grad_accum)
        elif mesh is not None:
            grads, metrics = accum_grads(state, names, leaves, xf, yf, xr,
                                         yr, protos, scalars, generator, 1)
        else:
            # grad_accum == 1, or a ragged tail batch the micro split
            # cannot cut evenly: run it unaccumulated
            total, metrics = loss_fn(state.params, xf, yf, xr, yr, protos,
                                     scalars, generator)
            grads = torch.autograd.grad(total, leaves)
        optimizer.update(leaves, grads, state.opt_state, scalars["lr"])
        if use_prox and not train_base:
            lora_group_prox(state.params["lora"],
                            fp32_threshold(scalars["lr"], scalars["alpha"]))
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def scalars_for_epoch(cfg: RunConfig, epoch: int, *, beta=None, alpha=None,
                      w_pro_f=None, w_pro_r=None, lr: float = 0.0,
                      continual: bool = False) -> Dict[str, float]:
    """Host-side per-epoch loss-weight schedule -> scalar dict.

    Reproduces: alpha warmup (alpha=0 before alpha_epoch, then big_alpha —
    train_own_forget.py:723-727); beta decay (:728-732); the bare
    epoch<ALPHA_EPOCH structure-loss gate of the single-step engine
    (engine.py:82-90), which ``continual=True`` skips."""
    f = cfg.forget
    b = f.beta if beta is None else beta
    a = f.alpha if alpha is None else alpha
    if f.warmup_alpha:
        a = 0.0 if epoch < f.alpha_epoch else f.big_alpha
    elif not continual and epoch < f.alpha_epoch and f.alpha_epoch > 0:
        a = 0.0
    if f.beta_decay and epoch >= 50:
        b = f.small_beta
    return {
        "beta": float(b),
        "alpha": float(a),
        "lr": float(lr),
        "bnd": float(f.bnd),
        "bnd_pro": float(f.bnd_pro),
        "w_pro_f": float(f.pro_f_weight if w_pro_f is None else w_pro_f),
        "w_pro_r": float(f.pro_r_weight if w_pro_r is None else w_pro_r),
    }
