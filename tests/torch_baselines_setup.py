"""Set-up shared by tests/test_torch_baselines_*.py: the tiny model and run
configs, one numpy-drawn parameter tree for both packages, and a run of
the JAX and the port forget CLIs side by side with their reports and
per-task checkpoints.

JAX is imported inside the functions that need it, so the card cases of
these files also run where only PyTorch is installed."""
import json

import numpy as np
import torch

MODEL = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
             dim_head=16, mlp_dim=64, num_class=8, dropout=0.0,
             emb_dropout=0.0, head_type="Softmax")
# Trained parameters, importances and task snapshots are held to the
# tolerance of tests/test_training_parity.py; losses to LOSS_RTOL.
PARAM_RTOL, PARAM_ATOL = 5e-3, 5e-5
LOSS_RTOL = 1e-4


def one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_config(C, method, device=None, epochs=1, grad_accum=1, lr=1e-3,
               num_tasks=2, data_mode="synthetic", **bkw):
    """A RunConfig of the tiny model for ``method`` in either package's
    config module ``C`` (fp32, dropout 0, rank 0 as the reference's
    baselines run)."""
    kw = dict(
        model=C.ViTConfig(**MODEL), lora=C.LoraConfig(rank=0),
        optim=C.OptimConfig(opt="adamw", lr=lr, warmup_epochs=0,
                            epochs=epochs, grad_accum=grad_accum),
        forget=C.ForgetConfig(num_of_first_cls=6, per_forget_cls=2,
                              num_tasks=num_tasks),
        baseline=C.BaselineConfig(method=method, **{
            "scrub_superepoch": 1, "sgda_learning_rate": 5e-3,
            "sgda_smoothing": 0.1, "ewc_lambda": 50.0, "mas_lambda": 50.0,
            "l2_lambda": 50.0, "der_lambda": 0.5, "fdr_lambda": 0.5,
            **bkw}),
        data=C.DataConfig(batch_size=8, data_mode=data_mode),
        num_epoch=epochs, ver_freq=10_000, disp_freq=1,
        compute_dtype="float32")
    if device is not None:
        kw["device"] = device
    return C.RunConfig(**kw)


def np_tree(seed=0, rank=0, model=None):
    """One parameter tree (numpy leaves) for both packages, drawn by the
    JAX package's init from ``seed``."""
    import jax

    import gslora_tpu.config as jc
    from gslora_tpu.models.vit import init_vit_params
    p = init_vit_params(jax.random.key(seed), jc.ViTConfig(**(model or
                                                              MODEL)),
                        jc.LoraConfig(rank=rank))
    return jax.tree.map(np.asarray, p)


def to_jax(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def to_numpy(tree):
    """A tree of JAX arrays or torch tensors as numpy leaves."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree, dtype=np.float32)


def assert_trees_close(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                       what="", scaled=False):
    """Leaf by leaf to rtol / atol; ``scaled``: atol is a fraction of each
    leaf's largest magnitude (for importances, whose scale is far from
    the parameters')."""
    from gslora_tpu_torch.models.convert import flatten_tree
    got, want = flatten_tree(to_numpy(got)), flatten_tree(to_numpy(want))
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        a = atol * float(np.abs(w).max()) if scaled else atol
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=a,
                                   err_msg=f"{what} {k}")


def patch_clis(monkeypatch, *modules):
    """Each CLI module's config gets the tiny model, and its build_params
    the numpy-drawn tree of its seed (the main model from seed 0, a
    Retrain model from the seed the CLI asks for): the two packages'
    generators draw different numbers."""
    import gslora_tpu.config as jc
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.models.convert import params_from_jax

    for module in modules:
        jax_side = module.__name__.startswith("gslora_tpu.")
        C = jc if jax_side else tc
        orig = C.config_from_args

        def patched(args, orig=orig, C=C):
            cfg = orig(args)
            cfg.model = C.ViTConfig(**{**MODEL, "head_type": args.head})
            return cfg

        def build(cfg, seed=None, jax_side=jax_side):
            tree = np_tree(0 if seed is None else seed)
            return to_jax(tree) if jax_side else params_from_jax(tree)

        monkeypatch.setattr(module, "config_from_args", patched)
        monkeypatch.setattr(module, "build_params", build)


# The CLI runs keep SCRUB's default SWA distance of 0: from a student equal
# to its teacher and SWA model, the distance's gradient is a unit vector
# of (p - swa) per tensor while p - swa is still rounding noise, so no two
# implementations agree there; test_scrub_task_matches_jax holds the
# distance where it is well defined.
CL_ARGS = ["-d", "synthetic", "--vit_depth", "2", "--head", "Softmax",
           "--lora_rank", "0", "-b", "8", "-e", "1", "--lr", "1e-3",
           "--warmup-epochs", "0", "--num_tasks", "2",
           "--num_of_first_cls", "6", "--per_forget_cls", "2",
           "--few_shot", "--few_shot_num", "4", "--compute_dtype",
           "float32", "--SCRUB_superepoch", "1",
           "--sgda_learning_rate", "5e-3", "--ewc_lambda", "50",
           "--mas_lambda", "50", "--l2_lambda", "50", "--DER_lambda", "0.5",
           "--FDR_lambda", "0.5"]


def run_both_clis(jmod, tmod, argv, tmp_path, tasks=2):
    """``main(argv)`` of the JAX CLI module and of the port's (on the CPU);
    returns {package: (report, [task snapshots as numpy trees])}."""
    from gslora_tpu_torch.checkpoints import msgpack
    from gslora_tpu_torch.checkpoints.io import load_params

    out = {}
    for name, mod, extra in (("jax", jmod, []),
                             ("torch", tmod, ["--device", "cpu"])):
        d = tmp_path / name
        report = mod.main(argv + ["--outdir", str(d)] + extra)
        assert json.loads((d / "report.json").read_text()) == \
            json.loads(json.dumps(report))
        snaps = []
        for t in range(tasks):
            path = d / "task-level" / f"Backbone_task_{t}"
            snaps.append(to_numpy(msgpack.load(str(path) + ".msgpack")
                                  if name == "jax" else
                                  load_params(str(path) + ".pth")))
        out[name] = (report, snaps)
    return out


def assert_reports_match(got, want):
    """Per-task reports: the same keys, the same accuracies (the same
    predictions), H-means to float rounding."""
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == np.float64(v) or abs(g[k] - v) <= 1e-6, \
                    (w["task"], k, g[k], v)
            else:
                assert g[k] == v, (w["task"], k, g[k], v)


class Recorder:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((step, {k: float(v) for k, v in
                                    metrics.items()}))

    def series(self, key):
        return [m[key] for _, m in self.records if key in m]


def task_data(pkg):
    """Train (5 per class) and test (3 per class) splits of the tiny
    synthetic set in package ``pkg`` ("jax" or "torch"): (forget_tr,
    remain_tr, forget_te, remain_te) of the window remain [0, 6), forget
    [6, 8)."""
    if pkg == "jax":
        from gslora_tpu.data.splits import split_by_class_window
        from gslora_tpu.data.synthetic import synthetic_face_dataset
    else:
        from gslora_tpu_torch.data.splits import split_by_class_window
        from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
    from gslora_tpu_torch.data.splits import make_order_list
    train = synthetic_face_dataset(num_classes=8, per_class=5,
                                   image_size=16, seed=0, noise=1.0)
    test = synthetic_face_dataset(num_classes=8, per_class=3,
                                  image_size=16, seed=1, noise=1.0)
    order = make_order_list(8, seed=1337)
    remain_tr, forget_tr = split_by_class_window(train, order, 0, 6, 6, 8)
    remain_te, forget_te = split_by_class_window(test, order, 0, 6, 6, 8)
    return forget_tr, remain_tr, forget_te, remain_te


def loaders(pkg, relabel=True, bs=7, pad=True):
    """Package ``pkg``'s loaders over :func:`task_data`: the (relabeled)
    forget and the remain training loaders, and the forget / remain test
    loader factories, all padded to full batches (``pad``) with the -1
    sentinel as on the card. A loader pads a tail by repeating its rows,
    so a tail whose length divides the batch weighs each row alike and
    hides an unmasked mean: 10 forget and 30 remain images in batches of
    7 leave tails of 3 and 2, repeated unevenly."""
    if pkg == "jax":
        from gslora_tpu.data.pipeline import BatchLoader
        from gslora_tpu.data.splits import random_relabel
    else:
        from gslora_tpu_torch.data.pipeline import BatchLoader
        from gslora_tpu_torch.data.splits import random_relabel
    forget_tr, remain_tr, forget_te, remain_te = task_data(pkg)
    f_ds = random_relabel(forget_tr, 8, seed=0) if relabel else forget_tr
    fl = BatchLoader(f_ds, bs, seed=1, mask_padding=pad)
    rl = BatchLoader(remain_tr, bs, seed=2, mask_padding=pad)

    def test(ds):
        return lambda: BatchLoader(ds, 3 * bs, shuffle=False, prefetch=0,
                                   mask_padding=pad)

    return fl, rl, test(forget_te), test(remain_te)


def np_tree_torch(seed=0):
    """:func:`np_tree` as the port's parameter tree."""
    from gslora_tpu_torch.models.convert import params_from_jax
    return params_from_jax(np_tree(seed))
