"""One rank of the port's ``(data, model)`` mesh runs for
tests/test_torch_mesh_*.py.

Run as ``python -m torch_mesh_worker <rank> <world> <port> <dir> <device>
<scenario>...`` with ``tests/`` and the repo root on PYTHONPATH: it sets
torchrun's environment, opens a gloo group itself, runs each scenario's
CLI with ``--dp`` and its layout flags at the tiny model of
tests/torch_dp_worker.py, from the parameter tree the scenario names
(``<dir>/<tree>.npz``), and saves what the tests compare to
``<dir>/<scenario>.rank<r>.pt``: the report, the eval history, the final
parameters gathered whole, and this rank's own shards. The scenario
``collectives`` checks the all_reduce route of all_gather,
reduce_scatter and the pipeline's shift against the native one instead,
``pp_remat`` takes the pipeline's gradients with and without
rematerialization, and ``dcn_sums`` records a rank's place, rows and
sums on the dcn meshes. A mesh smaller than the world leaves its other
ranks idle: those return at once, and the collectives every rank calls
after the groups are made are recorded, so that the test sees none on
the default group.

This module imports no JAX: a rank starts with PyTorch only."""
import os
import sys

import torch

import torch_dp_worker as dpw

TP = ["--tp", "--mesh_model", "2"]
SP = ["--sp", "--mesh_model", "2"]
PP = ["--pp", "--mesh_model", "2"]
DCN = ["--mesh_slices", "2"]
ATTN = dpw.FORGET + ["--lora_pos", "Attention"]
# ViT-B/16's structure at the tiny width (16 px, 16 / 8 + 1 = 5 tokens)
B16 = dict(soft_split=True, ac_patch_size=8, pad=0, qkv_bias=True,
           attn_scale="dim_head")
# the face ViT's overlapping soft split (kernel 12, stride 8, pad 4)
VITS = dict(soft_split=True, ac_patch_size=12, pad=4)
# scenario -> (CLI, argv without the layout, layout flags, the tree it
# starts from, model overrides, world)
SCENARIOS = {
    # forget (GS-LoRA, prototypes, alpha 5e-4 loss-mode group-Lasso)
    "forget_tp": ("train_forget", dpw.FORGET, TP, "pretrained", {}, 4),
    "forget_tp_merged": ("train_forget", dpw.FORGET + ["--lora_apply",
                                                       "merged"],
                         TP, "pretrained", {}, 4),
    "forget_tp_fsdp": ("train_forget", dpw.FORGET, TP + ["--fsdp"],
                       "pretrained", {}, 4),
    "forget_model2": ("train_forget", dpw.FORGET + ["--head", "CosFace"],
                      ["--mesh_model", "2"], "pretrained", {}, 2),
    "forget_fsdp": ("train_forget", dpw.FORGET, ["--fsdp"], "pretrained",
                    {}, 2),
    # GS-LoRA++ (prox, K2's plain version on the CPU) with EMA, 2 tasks
    "continual_fsdp_model2": ("train_forget_cl", dpw.CONTINUAL,
                              ["--fsdp", "--mesh_model", "2"], "pretrained",
                              {}, 4),
    "pretrain_tp": ("train_pretrain", dpw.PRETRAIN, TP, "init", {}, 4),
    "pretrain_tp_fsdp": ("train_pretrain", dpw.PRETRAIN + ["--remat"],
                         TP + ["--fsdp"], "init", {}, 4),
    # dropout on: the replicated leaves must stay equal across the ranks
    # of a model group
    "forget_tp_dropout": ("train_forget", dpw.FORGET + ["-e", "1"], TP,
                          "pretrained", {"dropout": 0.1}, 4),
    "pretrain_tp_dropout": ("train_pretrain", dpw.PRETRAIN + ["-e", "1"],
                            TP, "init", {"dropout": 0.1}, 4),
    # sequence parallelism: the 5 tokens (16 px / patch 8 + CLS) split 3
    # and 2 over the model axis
    "forget_sp": ("train_forget", dpw.FORGET, SP, "pretrained", {}, 2),
    "forget_tp_sp": ("train_forget", dpw.FORGET, TP + ["--sp"],
                     "pretrained", {}, 4),
    "continual_sp": ("train_forget_cl", dpw.CONTINUAL, SP, "pretrained", {},
                     2),
    "pretrain_tp_fsdp_sp": ("train_pretrain", dpw.PRETRAIN,
                            TP + ["--fsdp", "--sp"], "init", {}, 4),
    # GPipe: depth 2 over 2 stages in 2 micro-batches, depth 4 on 2 x 2
    "forget_pp": ("train_forget", dpw.FORGET, PP + ["--pp_micro", "2"],
                  "pretrained", {}, 2),
    "forget_pp_depth4": ("train_forget", dpw.FORGET + ["--vit_depth", "4"],
                         PP + ["--pp_micro", "2"], "init4", {}, 4),
    "forget_pp_dropout": ("train_forget", dpw.FORGET + ["-e", "1"], PP,
                          "pretrained",
                          {"dropout": 0.1, "emb_dropout": 0.1}, 2),
    "continual_pp": ("train_forget_cl", dpw.CONTINUAL + [
        "--structure_mode", "loss"], PP, "pretrained", {}, 2),
    "pretrain_pp": ("train_pretrain", dpw.PRETRAIN, PP, "init", {}, 4),
    # the outer dcn axis (--mesh_slices 2) on a world of 8: JAX's three
    # compositions (tests/test_mesh_multislice.py:47; 2 x 4 x 1 and
    # 2 x 2 x 2), the continual with the prox step and fsdp, the pretrain
    # with tp and fsdp (fsdp's shards within a slice, their gradients
    # summed across dcn), and plain --dp on the same world
    "forget_dp8": ("train_forget", dpw.FORGET, [], "pretrained", {}, 8),
    "forget_dcn_dp": ("train_forget", dpw.FORGET, DCN, "pretrained", {}, 8),
    "forget_dcn_tp_fsdp_sp": ("train_forget", dpw.FORGET,
                              DCN + TP + ["--fsdp", "--sp"], "pretrained",
                              {}, 8),
    "forget_dcn_pp": ("train_forget", dpw.FORGET,
                      DCN + PP + ["--pp_micro", "2"], "pretrained", {}, 8),
    "continual_dcn_fsdp": ("train_forget_cl", dpw.CONTINUAL,
                           DCN + ["--fsdp"], "pretrained", {}, 8),
    "pretrain_dcn_tp_fsdp": ("train_pretrain", dpw.PRETRAIN,
                             DCN + TP + ["--fsdp"], "init", {}, 8),
    # meshes smaller than the world of 4: ranks 2 and 3 idle
    "forget_subworld": ("train_forget", dpw.FORGET, ["--mesh_data", "2"],
                        "pretrained", {}, 4),
    "forget_subworld_tp": ("train_forget", dpw.FORGET,
                           ["--mesh_data", "1"] + TP, "pretrained", {}, 4),
    # every model and LoRA position under the layouts (the structures of
    # B16 and VITS, which both packages' CLIs take as the model): ViT-B/16
    # (qkv bias, head-dim scale, conv patchify, Softmax head with a bias)
    # under tp + fsdp, sp and pp; the face ViT's soft split under tp; the
    # attention LoRA under fsdp, tp, sp and pp (its group-Lasso and norms
    # over the stages)
    "b16_tp_fsdp": ("train_forget", dpw.FORGET + ["-n", "VIT_B16"],
                    TP + ["--fsdp"], "b16", B16, 4),
    "b16_sp": ("train_forget", dpw.FORGET + ["-n", "VIT_B16"], SP, "b16",
               B16, 2),
    "b16_pp": ("train_forget", dpw.FORGET + ["-n", "VIT_B16"],
               PP + ["--pp_micro", "2"], "b16", B16, 2),
    "vits_tp": ("train_forget", dpw.FORGET + ["-n", "VITs"], TP, "vits",
                VITS, 4),
    "attn_fsdp": ("train_forget", ATTN, ["--fsdp"], "attn", {}, 2),
    "attn_tp": ("train_forget", ATTN, TP, "attn", {}, 4),
    "attn_sp": ("train_forget", ATTN, SP, "attn", {}, 2),
    "attn_pp": ("train_forget", ATTN, PP + ["--pp_micro", "2"], "attn", {},
                2),
    # pair verification on the gathered parameters, rank 0 alone (the
    # .bin in the working directory)
    "pretrain_ver_tp_fsdp": ("train_pretrain", dpw.PRETRAIN + [
        "--ver_targets", "lfw", "--data_root", "."], TP + ["--fsdp"],
        "init", {}, 4),
}
# the card test of tests/test_torch_parallel.py: a baseline (train_forget
# --ewc, every parameter training but the head) under tp in bf16 through
# the kernels, from a tree without LoRA
SCENARIOS["ewc_tp_card"] = (
    "train_forget", ["-d", "synthetic", "--vit_depth", "2", "--head",
                     "Softmax", "--lora_rank", "0", "-b", "8", "-e", "2",
                     "--lr", "1e-3", "--warmup-epochs", "0",
                     "--num_of_first_cls", "6", "--per_forget_cls", "2",
                     "--few_shot", "--few_shot_num", "4", "--compute_dtype",
                     "bfloat16", "--ewc", "--ewc_lambda", "50"],
    TP, "base", {}, 2)
# scenarios whose model overrides are the structure of the model they
# name (the JAX run takes them too), not a departure from it
STRUCTURAL = {name for name, spec in SCENARIOS.items()
              if spec[4] in (B16, VITS)}
# scenarios whose rank 0 (and one process) write their files to
# ``<dir>/<scenario>.out`` (``.one`` for the one-process run)
WRITES = ("pretrain_pp", "pretrain_ver_tp_fsdp")
# scenarios whose every rank has an outdir of its own,
# ``<dir>/<scenario>.out<rank>``, and whose collectives after the groups
# are made are recorded (``default_group_calls``)
WATCHED = ("forget_subworld", "forget_subworld_tp")


def patch(module, tree, overrides, setattr_=setattr):
    """tests/torch_dp_worker.patch, with ``overrides`` on the model."""
    import dataclasses
    dpw.patch(module, tree, setattr_)
    config = module.config_from_args

    def with_overrides(args):
        cfg = config(args)
        cfg.model = dataclasses.replace(cfg.model, **overrides)
        return cfg

    setattr_(module, "config_from_args", with_overrides)


def mesh_reinit(generator, tree):
    """tests/torch_dp_worker.torch_reinit drawn at the whole shapes, the
    rank keeping its shards (the stages' layers under pp), as the port's
    own reinit_lora draws."""
    from gslora_tpu_torch.parallel import sharding
    from gslora_tpu_torch.parallel.mesh import active_mesh
    mesh = active_mesh()

    def path(pos, k):
        return ("lora", pos, k)

    whole = {pos: {k: torch.zeros(sharding.whole_shape(
        mesh, path(pos, k), v.shape)) for k, v in sub.items()}
        for pos, sub in tree.items()}
    drawn = dpw.torch_reinit(generator, whole)
    return {pos: {k: sharding.take_shard(mesh, t, sharding.leaf_spec(
        mesh, path(pos, k), t.shape)).contiguous().to(tree[pos][k].device)
        for k, t in sub.items()} for pos, sub in drawn.items()}


# the collectives of torch.distributed, by the argument that names the
# group (batch_isend_irecv: each op's group)
_WATCHED_CALLS = ("all_reduce", "broadcast", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "all_gather", "barrier",
                  "batch_isend_irecv")


def default_group_recorder(setattr_=setattr):
    """Wrap the collectives of torch.distributed; returns the list the
    names of those called on the default group go to and the function
    that starts the recording (once the groups are made)."""
    import torch.distributed as dist
    seen, on = [], []

    def default(group):
        return group is None or group is dist.group.WORLD

    def wrap(fn_name):
        fn = getattr(dist, fn_name)

        def call(*a, **k):
            if on:
                if fn_name == "batch_isend_irecv":
                    groups = [op.group for op in a[0]]
                else:
                    groups = [k.get("group")]
                if any(default(g) for g in groups):
                    seen.append(fn_name)
            return fn(*a, **k)
        return call

    for fn_name in _WATCHED_CALLS:
        setattr_(dist, fn_name, wrap(fn_name))
    return seen, lambda: on.append(True)


def watch_default_group(module, setattr_=setattr):
    """Record, once ``module``'s ``make_mesh`` has returned (the groups
    are made), every collective called on the default group; returns the
    list the calls' names go to."""
    seen, start = default_group_recorder(setattr_)
    make = module.make_mesh

    def make_then_watch(*a, **k):
        mesh = make(*a, **k)
        start()
        return mesh

    setattr_(module, "make_mesh", make_then_watch)
    return seen


def run(name, tree, layout=True, setattr_=setattr, device="cpu",
        outdir="", extra=()):
    """Scenario ``name``'s CLI from ``tree``: with ``--dp`` and its layout
    flags (a rank), or without both (the one-process run), with ``extra``
    flags, writing its
    files to ``outdir`` when given. Returns the report, the history, the
    final parameters whole and, on a rank, its shards."""
    import importlib

    from gslora_tpu_torch.parallel import sharding
    from gslora_tpu_torch.parallel.mesh import active_mesh
    cli, argv, flags, _, overrides, _ = SCENARIOS[name]
    module = importlib.import_module(f"gslora_tpu_torch.cli.{cli}")
    patch(module, tree, overrides, setattr_)
    argv = list(argv) + ["--device", device, "--outdir", outdir] + \
        list(extra)
    if layout:
        argv += ["--dp"] + flags
    seen = {}
    if layout and name in WATCHED:
        seen["default_group_calls"] = watch_default_group(module, setattr_)

    def whole(params):
        mesh = active_mesh()
        seen["shards"] = dpw.numpy_tree(params)
        return dpw.numpy_tree(sharding.gather_tree(mesh, params))

    if cli == "train_pretrain":
        seen["verification"] = verification_spy(module, setattr_)
        report, state = module.main(argv, return_state=True)
        if state is None:  # an idle rank
            return {"report": report, **seen}
        moments = dict(zip(state.trainable_names(), state.opt_state["mu"]))
        out = {"report": report, "params": whole(state.params),
               "shards": seen["shards"], "history": [],
               "moments": {k: tuple(v.shape) for k, v in moments.items()},
               "verification": seen["verification"]}
        if layout:
            out["restored"] = recovery(state, name)
        return out
    if cli == "train_forget" and "--ewc" in argv:
        # a baseline's runner returns its trees whole
        fn = module.run_regularization_task

        def spy(*a, **k):
            res = fn(*a, **k)
            seen["params"] = dpw.numpy_tree(res["params"])
            seen["history"] = []
            return res
        setattr_(module, "run_regularization_task", spy)
    elif cli == "train_forget":
        fn = module.run_forget_training

        def spy(*a, **k):
            res = fn(*a, **k)
            seen["params"] = whole(res.state.params)
            seen["history"] = [res.history]
            return res
        setattr_(module, "run_forget_training", spy)
    else:
        from gslora_tpu_torch.engine import continual
        setattr_(continual, "reinit_lora", mesh_reinit)
        task = continual.run_forget_training

        def spy_task(*a, **k):
            # the last task's trained shards are the final parameters
            res = task(*a, **k)
            seen["shards"] = dpw.numpy_tree(res.state.params)
            return res
        setattr_(continual, "run_forget_training", spy_task)
        fn = module.run_continual_forgetting

        def spy(*a, **k):
            out = fn(*a, **k)
            seen["params"] = dpw.numpy_tree(out.final_params)
            seen["history"] = [t.result.history for t in out.tasks]
            return out
        setattr_(module, "run_continual_forgetting", spy)
    report = module.main(argv)
    return {"report": report, **seen}


def verification_spy(module, setattr_=setattr):
    """Record each pair verification ``module`` logs (``buffer_val``):
    the list of (target, batch, accuracy, std) it is kept in."""
    kept = []
    log = module.buffer_val

    def spy(logger, name, acc, std, *a, batch=None, **k):
        kept.append((name, batch, float(acc), float(std)))
        return log(logger, name, acc, std, *a, batch=batch, **k)

    setattr_(module, "buffer_val", spy)
    return kept


def l1_norms(rank, world, outdir):
    """The LoRA's per-block group norms (L1 and L2) of the init tree on a
    1 x 2 tp mesh (B1 and A2 sharded over ``model``), on this rank's
    shards."""
    from gslora_tpu_torch.config import MeshConfig
    from gslora_tpu_torch.lora.core import lora_group_norms
    from gslora_tpu_torch.models.convert import params_from_jax
    from gslora_tpu_torch.parallel import sharding
    from gslora_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MeshConfig(model=2, tp=True), "cpu")
    tree = params_from_jax(dpw.load_tree(os.path.join(outdir, "init.npz")))
    lora = sharding.shard_tree(mesh, tree)["lora"]
    return {"shards": dpw.numpy_tree(lora),
            **{f"ord{o}": lora_group_norms(lora, "FFN", ord=o)
               for o in (1, 2)}}


def recovery(state, name):
    """The train state saved under the mesh (gathered, rank 0 writes) and
    restored into the same state zeroed: the rank's parameter and moment
    shards come back to the bit."""
    from gslora_tpu_torch.checkpoints.io import (restore_train_state,
                                                 save_train_state)
    from gslora_tpu_torch.parallel.mesh import active_mesh
    mesh = active_mesh()
    path = os.path.join(os.getcwd(), f"{name}.state.pt")
    before = [t.detach().clone() for t in state.trainable_params() +
              state.opt_state["mu"] + state.opt_state["nu"]]
    save_train_state(path, state, mesh)
    mesh.barrier()
    with torch.no_grad():
        for t in state.trainable_params() + state.opt_state["mu"]:
            t.zero_()
    restore_train_state(path, state, mesh)
    after = state.trainable_params() + state.opt_state["mu"] + \
        state.opt_state["nu"]
    return all(torch.equal(a, b) for a, b in zip(before, after))


def collectives(rank, world):
    """all_gather and reduce_scatter over each axis of a 2 x 2 mesh (or
    the data axis of 2 ranks), through the native collectives and through
    the all_reduce route, on tensors whose sums round; the shift over
    ``model`` (a 1 x 2 mesh of 2 ranks) each way by both routes."""
    import dataclasses

    from gslora_tpu_torch.config import MeshConfig
    from gslora_tpu_torch.parallel.mesh import make_mesh
    model = 2 if world == 4 else 1
    mesh = make_mesh(MeshConfig(model=model), "cpu")
    forced = dataclasses.replace(mesh, route="all_reduce")
    g = torch.Generator().manual_seed(rank)
    out = {"route": mesh.route}
    if world == 2:
        pipe = dataclasses.replace(mesh, model=2, data=1)
        x = torch.randn((3, 5, 7), generator=g) * 1e3
        out["shift.input"] = x
        for step in (1, -1):
            for which, m in (("native", pipe), ("all_reduce", dataclasses.
                                                replace(pipe,
                                                        route="all_reduce"))):
                out[f"shift.{step}.{which}"] = m.shift(x, step)
    axes = ("data", "model") if model > 1 else ("data",)
    for axis in axes:
        for dim in (0, 1, 2):
            x = torch.randn((4, 6, 8), generator=g) * 1e3
            for which, m in (("native", mesh), ("all_reduce", forced)):
                out[f"gather.{axis}.{dim}.{which}"] = m.all_gather(
                    x, axis, dim)
                out[f"scatter.{axis}.{dim}.{which}"] = m.reduce_scatter(
                    x, axis, dim)
            out[f"input.{axis}.{dim}"] = x
    return out


def dcn_sums(rank, world):
    """On a world of 8, for the dcn meshes 2 x 2 x 2 (fsdp) and 2 x 4 x 1:
    the rank's (dcn, data, model) indices, its block, its rows of a batch
    of 16, and what the sums give for rank-unique values (2^rank): an
    fsdp shard's gradient through ``sync_grads`` (as the backward leaves
    it, summed over ``data``: it crosses ``dcn`` alone), a replicated
    leaf's, and ``mesh.sum``."""
    from gslora_tpu_torch.config import MeshConfig
    from gslora_tpu_torch.parallel import multihost, sharding
    from gslora_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for tag, cfg in (("2x2x2", MeshConfig(slices=2, model=2, fsdp=True)),
                     ("2x4x1", MeshConfig(slices=2))):
        mesh = make_mesh(cfg, "cpu")
        names = ["base.blocks.qkv.kernel", "lora.ffn.A1"]
        grads = [torch.full((2, 8, 4), 2.0 ** rank, dtype=torch.float64),
                 torch.full((2, 4, 8), 2.0 ** rank, dtype=torch.float64)]
        sharding.sync_grads(mesh, names, grads)
        out[tag] = {
            "index": (mesh.dcn_index, mesh.data_index, mesh.model_index),
            "block": mesh.block,
            "rows": multihost.host_batch_bounds(mesh, 16),
            "specs": sharding.named_specs(mesh, names, grads),
            "fsdp_grad": float(grads[0][0, 0, 0]),
            "replicated_grad": float(grads[1][0, 0, 0]),
            "sum": mesh.sum([2.0 ** rank])[0]}
    return out


def pp_remat(rank, world):
    """The gradient of sum(emb^2) over the LoRA through the pipeline
    (depth 4 over 2 stages, 2 micro-batches, eval mode), without and with
    ``remat``, gathered whole (JAX's tests/test_mesh_loop.py:424-466)."""
    import dataclasses

    from gslora_tpu_torch.config import LoraConfig, MeshConfig, ViTConfig
    from gslora_tpu_torch.models.vit import ViT, init_vit_params, vit_apply
    from gslora_tpu_torch.parallel import sharding
    from gslora_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MeshConfig(model=2, pp=True, pp_micro=2), "cpu")
    model = ViTConfig(**{**dpw.MODEL, "depth": 4})
    lora = LoraConfig(rank=4)
    params = init_vit_params(torch.Generator().manual_seed(0), model, lora)
    x = torch.rand((8, 3, 16, 16), generator=torch.Generator().manual_seed(1))
    out = {}
    for remat in (False, True):
        m = dataclasses.replace(model, remat=remat)
        vit = ViT(sharding.shard_tree(mesh, params), m, lora)
        names = [n for n, _ in vit.lora.named_parameters()]
        leaves = list(vit.lora.parameters())
        emb = vit_apply(vit.tree(), x, None, m, lora,
                        compute_dtype=torch.float32)
        grads = torch.autograd.grad(torch.sum(emb ** 2), leaves)
        out[f"remat={remat}"] = {
            n: sharding.gather(mesh, gr, sharding.named_specs(
                mesh, ["lora." + n], [gr])[0]).numpy()
            for n, gr in zip(names, grads)}
    return out


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    outdir, device, *names = argv[3:]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        for name in names:
            if name == "collectives":
                out = collectives(rank, world)
            elif name == "pp_remat":
                out = pp_remat(rank, world)
            elif name == "dcn_sums":
                out = dcn_sums(rank, world)
            elif name == "l1_norms":
                out = l1_norms(rank, world, outdir)
            else:
                tree = dpw.load_tree(os.path.join(
                    outdir, SCENARIOS[name][3] + ".npz"))
                sub = f"{name}.out" if name in WRITES else \
                    f"{name}.out{rank}" if name in WATCHED else None
                out = run(name, tree, device=device, outdir=os.path.join(
                    outdir, sub) if sub else "")
            torch.save(out, os.path.join(outdir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
