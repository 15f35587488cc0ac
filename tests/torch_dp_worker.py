"""One rank of the port's data-parallel runs for tests/test_torch_parallel.py
(and, with ``--device cuda``, for the card check there).

Run as ``python -m torch_dp_worker <rank> <world> <port> <dir> <device>
<scenario>...`` with ``tests/`` and the repo root on PYTHONPATH: it sets
torchrun's environment, opens a gloo group itself (gloo also where the
ranks' tensors share one card, which NCCL refuses), runs each scenario's
CLI with ``--dp`` at the tiny model from the parameter tree the scenario
names (``<dir>/<tree>.npz``) and saves what the test compares to
``<dir>/<scenario>.rank<r>.pt``. The same scenario functions run in the
test process for the one-process runs.

This module imports no JAX: a rank starts with PyTorch only."""
import os
import sys

import numpy as np
import torch

MODEL = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
             dim_head=16, mlp_dim=64, num_class=8, dropout=0.0,
             emb_dropout=0.0, head_type="Softmax")
VER_FREQ = 4

COMMON = ["-d", "synthetic", "--vit_depth", "2", "--head", "Softmax",
          "--compute_dtype", "float32", "--lr", "1e-2"]
# 0.9 of the synthetic set's 20 images per class: 108 remain and 36 forget
# images, whose last batches of 16 leave tails of 12 and 4 rows, so on 2
# ranks the padding crosses into rank 0 (forget) and splits rank 1
# (remain)
FORGET = COMMON + ["--lora_rank", "4", "-b", "16", "-e", "2",
                   "--alpha_epoch", "0", "--num_of_first_cls", "6",
                   "--per_forget_cls", "2", "--data_ratio", "0.9",
                   "--prototype", "--pro_f_weight", "0.01", "--BND", "10",
                   "--beta", "1.0", "--alpha", "5e-4", "--lr", "3e-2"]
CONTINUAL = COMMON + ["--lora_rank", "4", "-b", "16", "-e", "1",
                      "--one_stage", "--num_tasks", "2",
                      "--num_of_first_cls", "6", "--per_forget_cls", "1",
                      "--data_ratio", "0.9", "--structure_mode", "prox",
                      "--alpha", "0.5", "--prototype", "--BND_pro", "50",
                      "--cl_beta_list", "0.3", "0.2", "--cl_prof_list",
                      "0.01", "0.02", "--average_weight", "--ema_epoch",
                      "0"]
# 160 images in batches of 24: a tail of 16, 12 rows of it on rank 0 and
# 4 on rank 1; 3 epochs reach the batch-20 eval
PRETRAIN = COMMON + ["--lora_rank", "0", "-b", "24", "-e", "3",
                     "--lr", "1e-3", "--warmup-epochs", "0"]
# scenario -> (CLI, argv, the tree it starts from): pretraining from the
# initial tree, forgetting from a pretrained base (which knows the classes,
# so the forget accuracies and H move)
SCENARIOS = {
    "pretrain": ("train_pretrain", PRETRAIN, "init"),
    # SGD, whose step scales with the gradient (Adam's does not), so a
    # wrong global count shows
    "pretrain_accum": ("train_pretrain", PRETRAIN + [
        "--grad_accum", "2", "--opt", "sgd", "--lr", "1e-2"], "init"),
    "forget": ("train_forget", FORGET, "pretrained"),
    "continual": ("train_forget_cl", CONTINUAL, "pretrained"),
    # the card: bf16 (the kernels' dtype), no prototypes (their batches
    # hold other rows than a one-process run's micro-batches)
    "forget_card": ("train_forget", [a for a in FORGET if a != "--prototype"]
                    + ["--compute_dtype", "bfloat16"], "pretrained"),
}


def load_tree(path):
    from gslora_tpu_torch.models.convert import unflatten_tree
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def patch(module, tree, setattr_=setattr):
    """The CLI module's config gets the tiny model, its build_params the
    shared tree."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.models.convert import params_from_jax
    orig = tc.config_from_args

    def config(args):
        cfg = orig(args)
        cfg.model = tc.ViTConfig(**{**MODEL, "depth": args.vit_depth,
                                    "head_type": args.head})
        cfg.ver_freq = VER_FREQ
        return cfg

    setattr_(module, "config_from_args", config)
    setattr_(module, "build_params",
             lambda cfg, seed=None: params_from_jax(tree))


def np_reinit(lora_tree):
    """LoRA reinit from numpy, the same in both packages: A ~
    U(+-sqrt(6 / (51 fan_in))) (kaiming-uniform's bound with a =
    sqrt(50)), B = 0, seeded per tensor name (the two packages' own
    reinits draw from different generators)."""
    out = {}
    for pos, sub in lora_tree.items():
        out[pos] = {}
        for name, arr in sub.items():
            shape = tuple(arr.shape)
            if name.startswith("A"):
                rng = np.random.RandomState(sum(map(ord, pos + name)))
                b = np.sqrt(6.0 / (51.0 * shape[-1]))
                out[pos][name] = rng.uniform(-b, b, shape).astype(np.float32)
            else:
                out[pos][name] = np.zeros(shape, np.float32)
    return out


def torch_reinit(generator, tree):
    return {pos: {k: torch.from_numpy(v).to(tree[pos][k].device)
                  for k, v in sub.items()}
            for pos, sub in np_reinit(tree).items()}


def numpy_tree(tree):
    from gslora_tpu_torch.models.convert import flatten_tree
    return {k: v.detach().float().cpu().numpy()
            for k, v in flatten_tree(tree).items()}


def run_scenario(name, tree, extra=(), setattr_=setattr, device="cpu"):
    """Run scenario ``name``'s CLI from ``tree`` with ``extra`` flags;
    returns what the test compares: the report, the final parameters
    (numpy, flat) and the eval history of every forget run."""
    import importlib
    cli, argv, _ = SCENARIOS[name]
    module = importlib.import_module(f"gslora_tpu_torch.cli.{cli}")
    patch(module, tree, setattr_)
    argv = list(argv) + ["--device", device, "--outdir", ""] + list(extra)
    seen = {}
    if cli == "train_pretrain":
        report, state = module.main(argv, return_state=True)
        return {"report": report, "params": numpy_tree(state.params),
                "history": []}
    if cli == "train_forget":
        run = module.run_forget_training

        def spy(*a, **k):
            res = run(*a, **k)
            seen["params"] = numpy_tree(res.state.params)
            seen["history"] = [res.history]
            return res
        setattr_(module, "run_forget_training", spy)
    else:
        from gslora_tpu_torch.engine import continual
        setattr_(continual, "reinit_lora", torch_reinit)
        run = module.run_continual_forgetting

        def spy(*a, **k):
            out = run(*a, **k)
            seen["params"] = numpy_tree(out.final_params)
            seen["history"] = [t.result.history for t in out.tasks]
            return out
        setattr_(module, "run_continual_forgetting", spy)
    report = module.main(argv)
    return {"report": report, **seen}


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
            tree = load_tree(os.path.join(outdir,
                                          SCENARIOS[name][2] + ".npz"))
            out = run_scenario(name, tree, ["--dp"], device=device)
            torch.save(out, os.path.join(outdir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
