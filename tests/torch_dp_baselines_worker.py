"""The baseline zoo under the port's data parallelism, for
tests/test_torch_parallel_baselines*.py and tests/test_torch_dcp.py: the
runs both the ranks and the one-process references make, the JAX
runners' reference of the test process (:func:`jax_family`), and one
rank's entry point.

Run as ``python -m torch_dp_baselines_worker <rank> <world> <port> <dir>
<name>...`` with ``tests/`` and the repo root on PYTHONPATH: it sets
torchrun's environment, opens a gloo group, runs each named run with a
``parallel/mesh.DataMesh`` (a runner family, the importance, or a CLI with
``--dp``) and saves what the tests compare to ``<dir>/<name>.rank<r>.pt``.

Families run the runners at the tiny model of tests/torch_baselines_setup.py
(fp32, dropout 0, rank 0) on its data, padded global batches of 8 (4 rows
a rank): 10 forget images leave a tail of 2, so rank 1's forget rows are
all padding in the last step, and 30 remain images a tail of 6, split 4 /
2. They train with SGD, whose step scales with the gradient (Adam's does
not), so a wrong global count shows.

This module imports no JAX (only :func:`jax_family`, which the ranks
never call, does): a rank starts with PyTorch only."""
import dataclasses
import itertools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_baselines_setup import CL_ARGS, MODEL, run_config, task_data

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
BS = 8  # the global batch: 4 rows a rank, 4 a micro-batch of one process
FAMILIES = ("reg_ewc", "distill_der_plus", "scrub", "lirf")
SINGLE_ARGS = ["-d", "synthetic", "--vit_depth", "2", "--head", "Softmax",
               "--lora_rank", "0", "-b", "8", "-e", "2", "--lr", "1e-3",
               "--warmup-epochs", "0", "--num_of_first_cls", "6",
               "--per_forget_cls", "2", "--few_shot", "--few_shot_num", "4",
               "--compute_dtype", "float32", "--ewc_lambda", "50"]
# run name -> (CLI module, argv): the eleven methods through
# train_forget_cl (two tasks, CL_ARGS) and --ewc / --retrain through
# train_forget
CLI_RUNS = {
    **{"cl_" + flag.lstrip("-").lower(): ("train_forget_cl",
                                          CL_ARGS + [flag])
       for flag in ("--retrain", "--replay", "--l2", "--ewc", "--MAS",
                    "--Lwf", "--Der", "--DER_plus", "--FDR", "--SCRUB",
                    "--LIRF")},
    "single_ewc": ("train_forget", SINGLE_ARGS + ["--ewc"]),
    "single_retrain": ("train_forget", SINGLE_ARGS + ["--retrain"]),
}


def family_method(name):
    """The method of a runner family (``reg_<method>``,
    ``distill_<method>``, ``scrub``, ``lirf``)."""
    return name.split("_", 1)[1] if name.startswith(("reg_", "distill_")) \
        else name


def family_config(C, method, grad_accum=1, device=None):
    """The RunConfig of a family run in either package's config module
    ``C``: two epochs of SGD (momentum 0.9) at lr 0.05; SCRUB's sgda at
    the same rate with SWA distance 0.1."""
    cfg = run_config(C, method, device=device, epochs=2,
                     grad_accum=grad_accum, lr=0.05,
                     sgda_learning_rate=0.05)
    cfg.optim = dataclasses.replace(cfg.optim, opt="sgd", momentum=0.9,
                                    weight_decay=5e-4)
    return cfg


def loaders(mesh):
    """This rank's rows (all rows without a mesh) of the padded global
    batches: relabeled forget, true-label forget and remain training
    loaders, and the forget / remain test loader factories (batches of
    24)."""
    from gslora_tpu_torch.data.splits import random_relabel
    from gslora_tpu_torch.parallel.multihost import process_sharded_loader
    forget_tr, remain_tr, forget_te, remain_te = task_data("torch")

    def load(ds, bs, **kw):
        return process_sharded_loader(mesh, ds, bs, mask_padding=True, **kw)

    def test(ds):
        return lambda: load(ds, 3 * BS, shuffle=False, prefetch=0)

    return {"forget": load(random_relabel(forget_tr, 8, seed=0), BS, seed=1),
            "forget_true": load(forget_tr, BS, seed=1),
            "remain": load(remain_tr, BS, seed=2),
            "importance": lambda ds: load(ds, BS, shuffle=False, prefetch=0),
            "remain_tr": remain_tr, "tbf": test(forget_te),
            "tbr": test(remain_te)}


def pretrained_tree(seed):
    """A tree (numpy leaves) the tiny model's classes are learnt in: the
    port's init from ``seed``, then 20 epochs of AdamW over every training
    image of :func:`task_data` (all eight classes), so the forget
    accuracies start high and the runs move them."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.data.pipeline import BatchLoader
    from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
    from gslora_tpu_torch.engine.pretrain import pretrain
    from gslora_tpu_torch.models.convert import unflatten_tree
    from gslora_tpu_torch.models.vit import init_vit_params
    train = synthetic_face_dataset(num_classes=8, per_class=5,
                                   image_size=16, seed=0, noise=1.0)
    cfg = tc.RunConfig(model=tc.ViTConfig(**MODEL),
                       lora=tc.LoraConfig(rank=0), device="cpu")
    init = init_vit_params(torch.Generator().manual_seed(seed), cfg.model,
                           cfg.lora)
    state, _ = pretrain(cfg, init, lambda: BatchLoader(train, BS, seed=0,
                                                       prefetch=0),
                        epochs=20, compute_dtype=torch.float32, lr=3e-3)
    return unflatten_tree(numpy_tree(state.params))


def numpy_tree(tree):
    from gslora_tpu_torch.models.convert import flatten_tree
    return {k: v.detach().float().cpu().numpy()
            for k, v in flatten_tree(tree).items()}


ACC_KEYS = ("forget_acc_before", "forget_acc", "remain_acc", "best_h")


def run_family(name, trees, mesh=None, grad_accum=1):
    """One runner family on the port, from ``trees`` (numpy trees by
    name: "p" the student, "teacher", "swa"); returns the final trees
    (numpy, flat) and the accuracies of every runner call."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.baselines.distill import run_distill_task
    from gslora_tpu_torch.baselines.lirf import run_lirf_task
    from gslora_tpu_torch.baselines.regularization import (
        estimate_importance, run_regularization_task)
    from gslora_tpu_torch.baselines.scrub import run_scrub_task
    from gslora_tpu_torch.data.pipeline import CyclingLoader
    from gslora_tpu_torch.models.convert import params_from_jax

    method = family_method(name)
    cfg = family_config(tc, method, grad_accum, device="cpu")
    t = {k: params_from_jax(v) for k, v in trees.items()}
    ld = loaders(mesh)
    tbf, tbr = ld["tbf"], ld["tbr"]
    out = {}
    if name.startswith("reg_"):
        # EWC's (MAS's) task 1: anchors at the start and after task 0,
        # each with its global Fisher (importance)
        p0 = t["p"]

        def importance(params):
            return estimate_importance(
                method, params, ld["importance"](ld["remain_tr"]),
                cfg.model, cfg.lora, torch.float32, grad_accum=grad_accum,
                mesh=mesh)

        imp0 = importance(p0)
        task0 = run_regularization_task(
            cfg, p0, lambda: iter(ld["forget"]), tbf, tbr, lam=50.0,
            anchors=[p0], importances=[imp0], mesh=mesh)
        imp1 = importance(task0["params"])
        res = run_regularization_task(
            cfg, task0["params"], lambda: iter(ld["forget"]), tbf, tbr,
            lam=50.0, anchors=[p0, task0["params"]],
            importances=[imp0, imp1], mesh=mesh)
        out["params"] = numpy_tree(res["params"])
        out["importance"] = numpy_tree(imp1)
        out["acc"] = [{k: r[k] for k in ACC_KEYS} for r in (task0, res)]
        return out
    if name.startswith("distill_"):
        res = run_distill_task(cfg, t["p"], t["teacher"],
                               lambda: iter(ld["forget"]),
                               CyclingLoader(ld["remain"]), tbf, tbr,
                               mesh=mesh)
        out["params"] = numpy_tree(res["params"])
    elif name == "scrub":
        res = run_scrub_task(
            cfg, t["p"], lambda: iter(ld["forget_true"]),
            lambda: itertools.islice(iter(ld["remain"]), 2), tbf, tbr,
            teacher=t["teacher"], swa=t["swa"], n_averaged=1, mesh=mesh)
        out["params"] = numpy_tree(res["params"])
        out["swa"] = numpy_tree(res["swa"])
    else:
        res = run_lirf_task(cfg, t["p"], lambda: iter(ld["forget"]),
                            CyclingLoader(ld["remain"]), tbf, tbr, mesh=mesh)
        out["params"] = numpy_tree(res["student_low"])
    out["acc"] = [{k: res[k] for k in ACC_KEYS}]
    return out


# The importance set: 13 images in batches of 8, so the tail's 5 valid
# rows split 4 / 1 over two ranks
IMPORTANCE_ROWS = 13


def run_importance(trees, mesh=None, grad_accum=1):
    """estimate_importance of EWC and MAS over IMPORTANCE_ROWS images of
    the remain set, each as a numpy tree."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.baselines.regularization import \
        estimate_importance
    from gslora_tpu_torch.data.folders import SubsetDataset
    from gslora_tpu_torch.models.convert import params_from_jax
    ld = loaders(mesh)
    ds = SubsetDataset(ld["remain_tr"], list(range(IMPORTANCE_ROWS)))
    p = params_from_jax(trees["p"])
    return {m: numpy_tree(estimate_importance(
        m, p, ld["importance"](ds), tc.ViTConfig(**MODEL),
        tc.LoraConfig(rank=0), torch.float32, grad_accum=grad_accum,
        mesh=mesh)) for m in ("ewc", "mas")}


def run_cli(name, extra=()):
    """CLI_RUNS[name] on the CPU at the tiny model, every model (the main
    one from seed 0, Retrain's from the seed the CLI asks for) drawn by the
    port's init; returns the report."""
    import importlib

    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.models.vit import init_vit_params
    cli, argv = CLI_RUNS[name]
    module = importlib.import_module(f"gslora_tpu_torch.cli.{cli}")
    orig = (module.config_from_args, module.build_params)

    def config(args):
        cfg = orig[0](args)
        cfg.model = tc.ViTConfig(**{**MODEL, "head_type": args.head})
        return cfg

    def build(cfg, seed=None):
        return init_vit_params(torch.Generator().manual_seed(
            0 if seed is None else seed), cfg.model, cfg.lora)

    module.config_from_args, module.build_params = config, build
    try:
        return module.main(list(argv) + ["--device", "cpu", "--outdir", ""]
                           + list(extra))
    finally:
        module.config_from_args, module.build_params = orig


def train_state():
    """A port train state, the same on every rank: the tiny model with a
    rank-4 LoRA after one AdamW step (seeded), its optimizer's moments
    and counts."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.engine.continual import detached
    from gslora_tpu_torch.engine.pretrain import (PretrainState,
                                                  make_pretrain_step)
    from gslora_tpu_torch.engine.state import make_optimizer
    from gslora_tpu_torch.models.vit import ViT, init_vit_params
    model, lora = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=4)
    opt = make_optimizer(tc.OptimConfig(lr=1e-3))
    state = PretrainState.create(ViT(init_vit_params(
        torch.Generator().manual_seed(0), model, lora), model, lora), opt)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((4, 3, 16, 16), generator=g)
    step = make_pretrain_step(model, lora, opt, compute_dtype=torch.float32)
    state, _ = step(state, x, torch.arange(4), 1e-3)
    return {"params": detached(state.params), "opt_state": state.opt_state,
            "step": state.step}


def flat_state(tree, prefix=""):
    """A state dict of dicts, lists, tensors and numbers as {path: numpy
    array or number}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree.detach().cpu().numpy()
                if isinstance(tree, torch.Tensor) else tree}
    out = {}
    for k, v in items:
        out.update(flat_state(v, f"{prefix}/{k}"))
    return out


def run_dcp(mesh=None):
    """:func:`train_state` saved by every rank through save_dcp and
    through AsyncSaver into the working directory, each read back with
    and without a template; returns the state and what was read, flat."""
    from gslora_tpu_torch.checkpoints.dcp_io import (AsyncSaver, load_dcp,
                                                     save_dcp)
    state = train_state()
    save_dcp("dcp_sync", state)
    saver = AsyncSaver()
    saver.save("dcp_async", state)
    saver.wait()
    saver.close()
    out = {"want": flat_state(state)}
    for name in ("dcp_sync", "dcp_async"):
        out[name] = flat_state(load_dcp(name))
        out[name + "_template"] = flat_state(load_dcp(name,
                                                      zeroed(state)))
    return out


def zeroed(tree):
    """A template of ``tree``: zeros of each tensor's shape and dtype, and
    0 for each number."""
    if isinstance(tree, dict):
        return {k: zeroed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [zeroed(v) for v in tree]
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0


MESH_WORLD = 4


def mesh_runs():
    """Family runs on a world of MESH_WORLD on meshes of their own, by
    name: (family, the MeshConfig its mesh is made from (None: the
    launched world's plain data mesh), the JAX mesh it is held to (None:
    none)). EWC under --mesh_slices 2 (2 x 2 x 1, and plain --dp on the
    same 4 ranks), SCRUB on --mesh_data 2 (ranks 2 and 3 idle)."""
    from gslora_tpu_torch.config import MeshConfig
    return {"reg_ewc_dcn": ("reg_ewc", MeshConfig(slices=2),
                            {"data": 2, "slices": 2}),
            "reg_ewc_dp4": ("reg_ewc", None, None),
            "scrub_subworld": ("scrub", MeshConfig(data=2), {"data": 2})}


def run_on_mesh(name, trees, mesh):
    """A run of :func:`mesh_runs` on this rank: its mesh made by
    ``make_mesh`` (every rank makes the groups); an idle rank returns at
    once. The collectives on the default group after the groups are made
    are recorded (``default_group_calls``)."""
    from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                                make_mesh)
    from torch_mesh_worker import default_group_recorder
    family, cfg, _ = mesh_runs()[name]
    if cfg is not None:
        mesh = make_mesh(cfg, "cpu", check=check_baseline_placement)
    seen, start = default_group_recorder()
    start()
    if mesh.idle:
        return {"idle": True, "default_group_calls": seen}
    out = run_family(family, trees, mesh)
    return {**out, "default_group_calls": list(seen)}


def layout_runs():
    """Family runs under the sharded layouts JAX's baseline runners take,
    by name: (family, the MeshConfig its mesh is made from, world); each
    is held to the JAX runners' one-device run. EWC with its importance
    taken under tp (1 x 2), fsdp (2 x 1) and sp (1 x 2), MAS under sp,
    LwF, DER++ and FDR under tp + fsdp (2 x 2), SCRUB under fsdp and a
    model axis (2 x 2), LIRF's split under tp + fsdp + sp (2 x 2), DER++
    under --mesh_slices 2 with tp (2 x 1 x 2); and SCRUB's SWA distance on
    the shards of the fsdp + model mesh (``param_dist``)."""
    from gslora_tpu_torch.config import MeshConfig
    tp_fsdp = MeshConfig(model=2, tp=True, fsdp=True)
    return {
        "reg_ewc_tp": ("reg_ewc", MeshConfig(model=2, tp=True), 2),
        "reg_ewc_fsdp": ("reg_ewc", MeshConfig(fsdp=True), 2),
        "reg_ewc_sp": ("reg_ewc", MeshConfig(model=2, sp=True), 2),
        "reg_mas_sp": ("reg_mas", MeshConfig(model=2, sp=True), 2),
        "distill_lwf_tp_fsdp": ("distill_lwf", tp_fsdp, 4),
        "distill_der_plus_tp_fsdp": ("distill_der_plus", tp_fsdp, 4),
        "distill_fdr_tp_fsdp": ("distill_fdr", tp_fsdp, 4),
        "scrub_fsdp_model2": ("scrub", MeshConfig(model=2, fsdp=True), 4),
        "lirf_tp_fsdp_sp": ("lirf", MeshConfig(model=2, tp=True, fsdp=True,
                                               sp=True), 4),
        "distill_der_plus_dcn_tp": ("distill_der_plus",
                                    MeshConfig(slices=2, model=2, tp=True),
                                    4),
        "param_dist": (None, MeshConfig(model=2, fsdp=True), 4),
    }


def param_dist_check(trees, mesh):
    """SCRUB's SWA distance (p 0.1) between the student and the SWA model
    and its gradient: of the whole trees, and of this rank's shards under
    ``mesh`` (the gradient gathered whole); each as (value, flat numpy
    gradient)."""
    from gslora_tpu_torch.baselines.scrub import param_dist
    from gslora_tpu_torch.models.convert import (flatten_tree,
                                                 params_from_jax,
                                                 unflatten_tree)
    from gslora_tpu_torch.parallel import sharding
    p, swa = (params_from_jax(trees[k]) for k in ("p", "swa"))

    def value_and_grad(a, b, m):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in flatten_tree(a).items()}
        d = param_dist(unflatten_tree(leaves), b, 0.1, m)
        grads = torch.autograd.grad(d, list(leaves.values()))
        return float(d), {k: sharding.gather(m, g, sharding.named_specs(
            m, [k], [g])[0]).numpy() if m is not None else g.numpy()
            for k, g in zip(leaves, grads)}

    return {"whole": value_and_grad(p, swa, None),
            "sharded": value_and_grad(sharding.shard_tree(mesh, p),
                                      sharding.shard_tree(mesh, swa), mesh)}


def run_on_layout(name, trees):
    """A run of :func:`layout_runs` on this rank, on its mesh (made by
    ``make_mesh`` through the baselines' guard)."""
    from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                                make_mesh)
    family, cfg, _ = layout_runs()[name]
    mesh = make_mesh(cfg, "cpu", check=check_baseline_placement)
    if family is None:
        return param_dist_check(trees, mesh)
    return run_family(family, trees, mesh)


def run(name, trees, mesh=None, grad_accum=1):
    """Run ``name``: a family, "importance", "dcp", a run of
    :func:`mesh_runs` or of :func:`layout_runs`, or a CLI run (with --dp
    and an --outdir of the rank's own in the working directory under a
    mesh; the mesh is the CLI's own)."""
    if mesh is not None and name in layout_runs():
        return run_on_layout(name, trees)
    if mesh is not None and name in mesh_runs():
        return run_on_mesh(name, trees, mesh)
    if name in FAMILIES:
        return run_family(name, trees, mesh, grad_accum)
    if name == "importance":
        return run_importance(trees, mesh, grad_accum)
    if name == "dcp":
        return run_dcp(mesh)
    if mesh is None:
        return run_cli(name)
    # each rank names its own --outdir, so the test sees who wrote what
    return run_cli(name, ["--dp", "--outdir", f"{name}.out{mesh.rank}"])


def _host(tree):
    """A tree of JAX arrays as flat numpy fp32 leaves."""
    import jax

    from gslora_tpu_torch.models.convert import flatten_tree
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_tree(jax.tree.map(np.asarray, tree)).items()}


def jax_family(name, trees, mesh_kw=None, one_device=False):
    """The family's runner calls in the JAX package, on a 2-device data
    mesh (or ``make_mesh(MeshConfig(**mesh_kw))``) of the test process's 8
    host devices, or on one device (``one_device``), with the same config,
    trees and padded global batches; run by the test process only."""
    import jax.numpy as jnp

    import gslora_tpu.config as jc
    from gslora_tpu.baselines.distill import run_distill_task
    from gslora_tpu.baselines.lirf import run_lirf_task
    from gslora_tpu.baselines.regularization import (estimate_importance,
                                                     run_regularization_task)
    from gslora_tpu.baselines.scrub import run_scrub_task
    from gslora_tpu.data.pipeline import BatchLoader, CyclingLoader
    from gslora_tpu.parallel.mesh import make_mesh
    from torch_baselines_setup import loaders as jax_loaders
    from torch_baselines_setup import to_jax

    mesh = None if one_device else \
        make_mesh(jc.MeshConfig(**(mesh_kw or {"data": 2})))
    method = family_method(name)
    cfg = family_config(jc, method)
    t = {k: to_jax(v) for k, v in trees.items()}
    fl, rl, tbf, tbr = jax_loaders("jax", relabel=name != "scrub", bs=BS)
    out = {}
    if name.startswith("reg_"):
        remain_tr = task_data("jax")[1]

        def importance(params):
            return estimate_importance(
                method, params, BatchLoader(remain_tr, BS, shuffle=False,
                                            prefetch=0, mask_padding=True),
                cfg.model, cfg.lora, jnp.float32)

        p0 = t["p"]
        imp0 = importance(p0)
        task0 = run_regularization_task(
            cfg, p0, lambda: iter(fl), tbf, tbr, lam=50.0, anchors=[p0],
            importances=[imp0], mesh=mesh)
        imp1 = importance(task0["params"])
        res = run_regularization_task(
            cfg, task0["params"], lambda: iter(fl), tbf, tbr, lam=50.0,
            anchors=[p0, task0["params"]], importances=[imp0, imp1],
            mesh=mesh)
        out["importance"] = _host(imp1)
        runs = (task0, res)
    elif name.startswith("distill_"):
        res = run_distill_task(cfg, t["p"], t["teacher"], lambda: iter(fl),
                               CyclingLoader(rl), tbf, tbr, mesh=mesh)
        runs = (res,)
    elif name == "scrub":
        res = run_scrub_task(cfg, t["p"], lambda: iter(fl),
                             lambda: itertools.islice(iter(rl), 2), tbf,
                             tbr, mesh=mesh, teacher=t["teacher"],
                             swa=t["swa"], n_averaged=1)
        out["swa"] = _host(res["swa"])
        runs = (res,)
    else:
        res = run_lirf_task(cfg, t["p"], lambda: iter(fl),
                            CyclingLoader(rl), tbf, tbr, mesh=mesh)
        runs = (res,)
    out["params"] = _host(res["student_low" if name == "lirf"
                              else "params"])
    out["acc"] = [{k: r[k] for k in ACC_KEYS} for r in runs]
    return out


def family_runs(outdir, names, mesh_names=()):
    """Every run of ``names`` (families and "importance") on 2 gloo ranks
    (started first), in one process with --grad_accum 2 and, for the
    importances, without it, and each family through the JAX runners on
    a 2-device mesh; the runs of ``mesh_names`` (:func:`mesh_runs`) on
    MESH_WORLD ranks started beside them, each family through the JAX
    runners on the mesh it names."""
    p = pretrained_tree(3)
    trees = {"p": p, "teacher": p, "swa": pretrained_tree(4)}
    save_trees(outdir, trees)
    procs = start_ranks(outdir, names)
    mesh_procs = start_ranks(outdir, mesh_names, MESH_WORLD) \
        if mesh_names else []
    try:
        one = {name: run(name, trees, grad_accum=2) for name in names}
        one_whole = run("importance", trees) if "importance" in names \
            else None
        jax_ref = {name: jax_family(name, trees) for name in names
                   if name in FAMILIES}
        for name in mesh_names:
            family, _, jax_kw = mesh_runs()[name]
            if jax_kw is not None:
                jax_ref[name] = jax_family(family, trees, jax_kw)
    except BaseException:
        for proc in procs + mesh_procs:
            proc.kill()
            proc.wait()
        raise
    return {"ranks": collect(procs, outdir, names), "one": one,
            "one_whole": one_whole, "jax": jax_ref, "trees": trees,
            "mesh_ranks": collect(mesh_procs, outdir, mesh_names)
            if mesh_names else []}


# The JAX suite's data-parallel tolerance (tests/test_mesh_loop.py:79-80)
RTOL, ATOL = 1e-4, 1e-5
ACC_TOL = 1e-3


def check_against_jax(runs, name, ranks=None):
    """Each rank's final trees of ``name`` (the student; SCRUB's SWA
    model; EWC's second Fisher) against the JAX mesh run's to RTOL /
    ATOL, every runner call's accuracies and best H to ACC_TOL; of
    ``ranks`` (each rank's {name: result}; the 2-rank runs by
    default)."""
    want = runs["jax"][name]
    for r, rank in enumerate(runs["ranks"] if ranks is None else ranks):
        got = rank[name]
        for key in ("params", "swa", "importance"):
            if key not in want:
                continue
            assert set(got[key]) == set(want[key])
            for k, w in want[key].items():
                np.testing.assert_allclose(got[key][k], w, rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"rank {r} {key} {k}")
        assert len(got["acc"]) == len(want["acc"])
        for g, w in zip(got["acc"], want["acc"]):
            for k in ACC_KEYS:
                assert abs(g[k] - w[k]) < ACC_TOL, (r, k, g[k], w[k])


def check_against_one_process(runs, name):
    """Each rank's results of ``name`` (flat trees by key, and the
    accuracies) equal to the bit to the one process's with --grad_accum
    2."""
    want = runs["one"][name]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[name]
        assert set(got) == set(want)
        for key, tree in want.items():
            if key == "acc":
                assert got[key] == tree
                continue
            assert set(got[key]) == set(tree)
            for k, w in tree.items():
                np.testing.assert_array_equal(got[key][k], w,
                                              err_msg=f"rank {r} {key} {k}")


def load_trees(outdir):
    from gslora_tpu_torch.models.convert import unflatten_tree
    out = {}
    path = Path(outdir) / "trees.npz"
    if path.exists():
        with np.load(path) as z:
            for key in z.files:
                tree, leaf = key.split("/", 1)
                out.setdefault(tree, {})[leaf] = z[key]
    return {k: unflatten_tree(v) for k, v in out.items()}


def save_trees(outdir, trees):
    from gslora_tpu_torch.models.convert import flatten_tree
    np.savez(Path(outdir) / "trees.npz",
             **{f"{name}/{k}": v for name, tree in trees.items()
                for k, v in flatten_tree(tree).items()})


def start_ranks(outdir, names, world=2):
    """Start ``world`` fresh ranks running ``names`` (each rank a new
    interpreter, never a fork of a JAX-loaded test process); returns the
    processes for :func:`collect`."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, "-m", "torch_dp_baselines_worker", str(r),
         str(world), str(port), str(outdir), *names], cwd=outdir, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def collect(procs, outdir, names):
    """Wait for the ranks (RANK_TIMEOUT_S each), kill any left, raise with
    a failed rank's log; returns each rank's {name: result}."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [{name: torch.load(Path(outdir) / f"{name}.rank{r}.pt",
                              weights_only=False) for name in names}
            for r in range(len(procs))]


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    outdir, *names = argv[3:]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from gslora_tpu_torch.parallel.mesh import DataMesh
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        mesh = DataMesh(rank=rank, world=world, device=torch.device("cpu"))
        trees = load_trees(outdir)
        for name in names:
            torch.save(run(name, trees, mesh),
                       os.path.join(outdir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
