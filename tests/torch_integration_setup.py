"""Set-up shared by tests/test_torch_integration_*.py: the integration
scripts' tiny model (scripts/integration_baselines_cl.py --tiny: 16 px,
dim 64, depth 2, 2 heads x 32, mlp 128, dropout 0) on their synthetic
stand-in (100 classes, 24 and 5 images a class), one base for both
packages, and each script's composition rebuilt from the JAX package's
functions.

The JAX scripts set ``jax_default_prng_impl = "rbg"`` when imported, and
scripts/integration_synthetic.py runs its whole body then, so no test
imports them: each composition below follows its script line by line
(cited), in fp32 and with every epoch count cut to ``n_ep``. JAX is
imported inside the functions."""
import numpy as np
import torch

from torch_baselines_setup import np_tree

TINY = dict(image_size=16, patch_size=8, dim=64, depth=2, heads=2,
            dim_head=32, mlp_dim=128, num_class=100, dropout=0.0,
            emb_dropout=0.0)


def tiny_model(C, head="Softmax"):
    return C.ViTConfig(**TINY, head_type=head)


def stand_in(pkg, noise, image_size=16):
    """The scripts' (train, test) in package ``pkg``, at the tiny size
    unless ``image_size`` says otherwise."""
    if pkg == "jax":
        from gslora_tpu.data.synthetic import synthetic_face_dataset
    else:
        from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
    return (synthetic_face_dataset(num_classes=100, per_class=24,
                                   image_size=image_size, seed=0,
                                   noise=noise),
            synthetic_face_dataset(num_classes=100, per_class=5,
                                   image_size=image_size, seed=77,
                                   noise=noise))


def trained_base(head, noise, epochs=10, seed=0):
    """One base for both packages (numpy leaves): the JAX init of
    ``seed`` (torch_baselines_setup.np_tree, rank-8 LoRA), pretrained
    ``epochs`` epochs by the port in fp32 on the CPU (bs 240, lr 1e-3),
    so the forget runs start from a model that tells the classes apart
    (43 % test accuracy on the unsaturated stand-in, chance 1 %)."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.data.pipeline import BatchLoader
    from gslora_tpu_torch.engine.pretrain import pretrain
    from gslora_tpu_torch.models.convert import params_from_jax, \
        params_to_jax

    tree = np_tree(seed, rank=8, model={**TINY, "head_type": head})
    cfg = tc.RunConfig(model=tiny_model(tc, head), lora=tc.LoraConfig(8),
                       optim=tc.OptimConfig(lr=1e-3, warmup_epochs=0,
                                            epochs=epochs),
                       data=tc.DataConfig(batch_size=240), device="cpu")
    train, _ = stand_in("torch", noise)
    state, _ = pretrain(cfg, params_from_jax(tree),
                        lambda: BatchLoader(train, 240, seed=3),
                        epochs=epochs, compute_dtype=torch.float32)
    return params_to_jax(state.params)


def jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def jax_accuracy(params, test, model, batch_size, mask_padding):
    import jax.numpy as jnp
    from gslora_tpu.config import LoraConfig
    from gslora_tpu.data.pipeline import BatchLoader
    from gslora_tpu.engine.evaluate import eval_accuracy, make_eval_step
    ev = make_eval_step(model, LoraConfig(rank=8), compute_dtype=jnp.float32)
    return eval_accuracy(ev, params, BatchLoader(
        test, batch_size, shuffle=False, prefetch=0,
        mask_padding=mask_padding))


def jax_single_task(method, params, fresh, train, test, model, bs, n_ep):
    """scripts/integration_baselines.py:97-290 for one method: the
    pretrain accuracy and the method's accuracies; ``fresh``: Retrain's
    start (the script draws it from jax.random.key(11), :240-241)."""
    import jax.numpy as jnp
    from gslora_tpu.baselines.distill import run_distill_task
    from gslora_tpu.baselines.lirf import run_lirf_task
    from gslora_tpu.baselines.regularization import (
        estimate_importance, run_regularization_task)
    from gslora_tpu.baselines.scrub import run_scrub_task
    from gslora_tpu.config import (BaselineConfig, DataConfig, ForgetConfig,
                                   LoraConfig, OptimConfig, RunConfig)
    from gslora_tpu.data.folders import ConcatDataset
    from gslora_tpu.data.pipeline import BatchLoader, CyclingLoader
    from gslora_tpu.data.splits import (make_order_list, random_relabel,
                                        ratio_subset, split_by_class_window)
    from gslora_tpu.engine.loop import ForgetData, run_forget_training

    lora = LoraConfig(rank=8)
    pre_acc = jax_accuracy(params, test, model, 240, True)  # :95-98
    order = make_order_list(100, seed=1337)  # :101-106
    remain_tr, forget_tr = split_by_class_window(train, order, 0, 80, 80, 100)
    remain_te, forget_te = split_by_class_window(test, order, 0, 80, 80, 100)
    forget_sub = ratio_subset(forget_tr, 0.4, 1337)
    remain_sub = ratio_subset(remain_tr, 0.4, 1337)
    relabeled = random_relabel(forget_sub, 100, seed=1337)
    tbf = lambda: BatchLoader(forget_te, 240, shuffle=False,  # noqa: E731
                              prefetch=0, mask_padding=True)
    tbr = lambda: BatchLoader(remain_te, 240, shuffle=False,  # noqa: E731
                              prefetch=0, mask_padding=True)

    def cfg(lr=1e-4, **bkw):
        return RunConfig(
            model=model, lora=lora,
            optim=OptimConfig(opt="adamw", lr=lr, warmup_epochs=0,
                              epochs=n_ep),
            forget=ForgetConfig(num_of_first_cls=80, per_forget_cls=20),
            baseline=BaselineConfig(method=method, **bkw),
            data=DataConfig(batch_size=bs), num_epoch=n_ep, ver_freq=10_000,
            compute_dtype="float32")

    if method == "gs_lora":  # :116-140
        c = RunConfig(
            model=model, lora=lora,
            optim=OptimConfig(opt="adamw", lr=1e-2, warmup_epochs=0,
                              epochs=n_ep),
            forget=ForgetConfig(num_of_first_cls=80, per_forget_cls=20,
                                bnd=110.0 if model.head_type == "CosFace"
                                else 10.0,
                                beta=0.15, alpha=1e-4, alpha_epoch=0),
            data=DataConfig(batch_size=bs), num_epoch=n_ep, ver_freq=10_000,
            compute_dtype="float32", lora_apply="merged", fused_batch=True)
        res = run_forget_training(c, params, ForgetData(
            train_forget=forget_sub, train_remain=remain_sub,
            test_forget=forget_te, test_remain=remain_te))
        out = {"forget_acc_before": res.forget_acc_before,
               "forget_acc": res.forget_acc, "remain_acc": res.remain_acc,
               "best_h": res.best_h}
    elif method in ("lwf", "der", "der_plus", "fdr"):  # :142-168
        fl = BatchLoader(relabeled, bs, seed=4, mask_padding=True)
        rl = BatchLoader(remain_sub, bs, seed=5, mask_padding=True)
        out = run_distill_task(
            cfg(lwf_lambda_kd=0.5, lwf_lambda_remain=1.0, der_lambda=0.1,
                der_plus_lambda=0.1, fdr_lambda=0.1),
            params, params, lambda: iter(fl), CyclingLoader(rl), tbf, tbr)
    elif method == "lirf":  # :170-196
        fl = BatchLoader(relabeled, bs, seed=6, mask_padding=True)
        rl = BatchLoader(remain_sub, bs, seed=7, mask_padding=True)
        out = run_lirf_task(cfg(), params, lambda: iter(fl),
                            CyclingLoader(rl), tbf, tbr)
    elif method in ("ewc", "mas", "l2"):  # :198-224
        lam = {"ewc": 10.0, "mas": 5.0, "l2": 0.1}[method]
        imp = estimate_importance(
            method, params,
            BatchLoader(remain_sub, bs, shuffle=False, prefetch=0,
                        mask_padding=True), model, lora, jnp.float32)
        fl = BatchLoader(relabeled, bs, seed=1, mask_padding=True)
        out = run_regularization_task(
            cfg(**{method + "_lambda": lam}), params, lambda: iter(fl), tbf,
            tbr, lam=lam, anchors=[params], importances=[imp])
    elif method in ("retrain", "replay"):  # :226-264
        if method == "retrain":
            start, lr = fresh, 3e-4
            tl = BatchLoader(remain_sub, bs, seed=8, mask_padding=True)
        else:
            start, lr = params, 1e-4
            tl = BatchLoader(ConcatDataset(relabeled, remain_sub), bs,
                             seed=9, mask_padding=True)
        out = run_regularization_task(cfg(lr=lr), start, lambda: iter(tl),
                                      tbf, tbr, lam=0.0, anchors=[],
                                      importances=[])
    else:  # scrub, :266-290
        fl_true = BatchLoader(forget_sub, bs, seed=2, mask_padding=True)
        rl = BatchLoader(remain_sub, bs, seed=3, mask_padding=True)
        out = run_scrub_task(
            cfg(scrub_superepoch=n_ep, sgda_learning_rate=5e-4,
                sgda_gamma=0.99, sgda_alpha=0.001),
            params, lambda: iter(fl_true), lambda: iter(rl), tbf, tbr)
    return pre_acc, {k: out[k] for k in ("forget_acc_before", "forget_acc",
                                         "remain_acc", "best_h")}


def jax_continual_baselines(methods, params, train, test, model, bs,
                            num_tasks, n_ep):
    """scripts/integration_baselines_cl.py:98-160: the pretrain accuracy
    and, per method, run_baseline_continual's per-task results. Retrain
    draws each task's fresh start from cli/common.build_params."""
    from gslora_tpu.cli.train_forget_cl import run_baseline_continual
    from gslora_tpu.config import (BaselineConfig, DataConfig, ForgetConfig,
                                   LoraConfig, OptimConfig, RunConfig)
    from gslora_tpu.data.splits import make_order_list
    from gslora_tpu.metrics.logging import MetricLogger

    pre_acc = jax_accuracy(params, test, model, 240, True)
    order = make_order_list(100, seed=1337)
    recipes = {  # :112-144, epochs cut to n_ep
        "lwf": BaselineConfig(method="lwf", lwf_lambda_kd=0.5,
                              lwf_lambda_remain=1.0),
        "lirf": BaselineConfig(method="lirf"),
        "ewc": BaselineConfig(method="ewc", ewc_lambda=10.0),
        "scrub": BaselineConfig(method="scrub", scrub_superepoch=n_ep,
                                sgda_learning_rate=5e-4, sgda_gamma=0.99,
                                sgda_alpha=0.001),
        "der": BaselineConfig(method="der", der_lambda=0.1),
        "der_plus": BaselineConfig(method="der_plus", der_lambda=0.1,
                                   der_plus_lambda=0.1),
        "fdr": BaselineConfig(method="fdr", fdr_lambda=0.1),
        "mas": BaselineConfig(method="mas", mas_lambda=5.0),
        "l2": BaselineConfig(method="l2", l2_lambda=0.1),
        "replay": BaselineConfig(method="replay"),
        "retrain": BaselineConfig(method="retrain"),
    }
    lrs = {"retrain": 3e-4}  # :141-142, the rest at the default 1e-4
    results = {}
    for m in methods:
        cfg = RunConfig(
            model=model, lora=LoraConfig(rank=8),
            optim=OptimConfig(opt="adamw", lr=lrs.get(m, 1e-4),
                              warmup_epochs=0, epochs=n_ep),
            forget=ForgetConfig(num_of_first_cls=80, per_forget_cls=10,
                                num_tasks=num_tasks, data_ratio=0.4),
            baseline=recipes[m], data=DataConfig(batch_size=bs),
            num_epoch=n_ep, ver_freq=10_000, compute_dtype="float32")
        results[m], _ = run_baseline_continual(cfg, params, train, test,
                                               order, MetricLogger(),
                                               workdir=None)
    return pre_acc, results


def jax_synthetic(params, train, test, model, unsaturated, bs, n_ep):
    """scripts/integration_synthetic.py:82-116: the pretrain accuracy
    (batches of 250, no padding) and the forget run at the full recipe."""
    from gslora_tpu.config import (DataConfig, ForgetConfig, LoraConfig,
                                   OptimConfig, RunConfig)
    from gslora_tpu.data.splits import (make_order_list, ratio_subset,
                                        split_by_class_window)
    from gslora_tpu.engine.loop import ForgetData, run_forget_training

    acc = jax_accuracy(params, test, model, 250, False)
    order = make_order_list(100, seed=1337)
    remain_tr, forget_tr = split_by_class_window(train, order, 0, 90, 90, 100)
    remain_te, forget_te = split_by_class_window(test, order, 0, 90, 90, 100)
    data = ForgetData(train_forget=ratio_subset(forget_tr, 0.5, seed=1337),
                      train_remain=ratio_subset(remain_tr, 0.5, seed=1337),
                      test_forget=forget_te, test_remain=remain_te)
    cfg = RunConfig(
        model=model, lora=LoraConfig(rank=8),
        optim=OptimConfig(lr=1e-2, warmup_epochs=0, epochs=n_ep),
        forget=ForgetConfig(bnd=10.0 if unsaturated else 110.0, beta=0.15,
                            alpha=0.01, warmup_alpha=True, big_alpha=0.01,
                            alpha_epoch=10, prototype=True, pro_f_weight=0.1,
                            pro_r_weight=0.0, bnd_pro=18.0,
                            average_weight=True, ema_epoch=12,
                            ema_decay=0.9),
        data=DataConfig(batch_size=bs), num_epoch=n_ep, ver_freq=30,
        compute_dtype="float32", lora_apply="merged")
    res = run_forget_training(cfg, params, data)
    return {"pretrain_test_acc": acc, "head": model.head_type,
            "noise": 2.4 if unsaturated else 1.0,
            "forget_acc_before": res.forget_acc_before,
            "forget_acc_after": res.forget_acc,
            "remain_acc_after": res.remain_acc, "best_H_mean": res.best_h,
            "norm_list": list(res.norm_list)}


def jax_continual(params, train, test, model, boundary, few_shot, num_tasks,
                  n_ep, data_ratio=0.4, logger=None, disp_freq=5):
    """scripts/integration_continual.py:96-118 (--unsaturated): the
    GS-LoRA++ recipe's ForgetConfig and RunConfig in fp32, every epoch
    count cut to ``n_ep``, the first ``num_tasks`` tasks, ``data_ratio``
    in place of the script's 0.4 where a test cuts it; returns
    run_continual_forgetting's result. ``logger`` gets the step metrics
    every ``disp_freq`` steps."""
    import dataclasses

    from gslora_tpu.config import (DataConfig, ForgetConfig, LoraConfig,
                                   OptimConfig, RunConfig)
    from gslora_tpu.data.splits import make_order_list
    from gslora_tpu.engine.continual import run_continual_forgetting

    fcfg = ForgetConfig(num_of_first_cls=80, per_forget_cls=20,
                        num_tasks=num_tasks, bnd=10.0,
                        cl_beta_list=(0.3, 0.4, 0.28, 0.2),
                        alpha=1e-4, alpha_epoch=0,
                        prototype=True, bnd_pro=50.0,
                        cl_prof_list=(0.015, 0.06, 0.025, 0.012),
                        pro_r_weight=0.0, data_ratio=data_ratio)
    if few_shot:
        fcfg = dataclasses.replace(fcfg, few_shot=True, few_shot_num=4)
    cfg = RunConfig(
        model=model, lora=LoraConfig(rank=8),
        optim=OptimConfig(lr=1e-2, warmup_epochs=0, epochs=n_ep),
        forget=fcfg, data=DataConfig(batch_size=4 if few_shot else 48),
        num_epoch=n_ep, ver_freq=10_000, disp_freq=disp_freq,
        compute_dtype="float32", lora_apply="merged", fused_batch=True)
    return run_continual_forgetting(cfg, params, train, test,
                                    make_order_list(100, seed=1337),
                                    logger=logger, boundary=boundary)


def np_reinit(lora_tree):
    """One LoRA reinit for both packages at the task boundary (JAX keys
    and torch generators draw different numbers): A uniform in
    +-sqrt(6 / (51 fan_in)), B = 0, seeded by the tensor's name."""
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


def patch_reinit(monkeypatch):
    """Both packages' continual boundary draws :func:`np_reinit`."""
    import jax
    import jax.numpy as jnp

    import gslora_tpu.engine.continual as jcont
    import gslora_tpu_torch.engine.continual as tcont
    monkeypatch.setattr(jcont, "reinit_lora", lambda key, tree: jax.tree.map(
        jnp.asarray, np_reinit(tree)))
    monkeypatch.setattr(tcont, "reinit_lora", lambda gen, tree: {
        pos: {k: torch.from_numpy(v) for k, v in sub.items()}
        for pos, sub in np_reinit(tree).items()})


def assert_close(got, want, what):
    """An accuracy (the same predictions) or an H-mean, to float
    rounding."""
    assert abs(got - want) <= 1e-6, (what, got, want)


FLAGSHIP = dict(image_size=112, patch_size=8, dim=512, depth=6, heads=8,
                dim_head=64, mlp_dim=2048, num_class=100, dropout=0.1,
                emb_dropout=0.1)
# the tier-1 cut of the flagship: one layer, dropout 0
DEPTH_1 = {**FLAGSHIP, "depth": 1, "dropout": 0.0, "emb_dropout": 0.0}
HEAD_SCALE = 100.0  # test CE ~2.7 nats: the class means differ in little


def class_mean_base(train):
    """The JAX seed-0 init of :data:`DEPTH_1` (numpy leaves) with its
    Softmax head set to the nearest class mean of the port's fp32
    embeddings of each class's mean training image: logits s (e - m) .
    (mu_c - m) - s |mu_c - m|^2 / 2, m the mean of the mu_c. At these
    widths a port pretrain stays near chance for longer than a tier-1
    file's budget; this head tells 76.8 % of the stand-in's test images
    apart."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.models.convert import params_from_jax, \
        params_to_jax
    from gslora_tpu_torch.models.vit import vit_embed

    model = {**DEPTH_1, "head_type": "Softmax"}
    params = params_from_jax(np_tree(0, rank=8, model=model))
    means = np.stack([train.images[train.labels == c].mean(0)
                      for c in range(100)])
    with torch.no_grad():
        mu = vit_embed(params, torch.from_numpy(means), tc.ViTConfig(**model),
                       tc.LoraConfig(8), compute_dtype=torch.float32)
    m = mu.mean(0)
    centred = mu - m
    params["base"]["head"] = {
        "weight": HEAD_SCALE * centred,
        "bias": -HEAD_SCALE * ((centred * centred).sum(1) / 2
                               + centred @ m)}
    return params_to_jax(params)


def jax_flagship_base(path):
    """scripts/integration_synthetic.py:49-90 with --unsaturated, in fp32
    on the CPU: the flagship (Softmax head) from the JAX seed-0 init,
    pretrained 12 epochs on the noise-2.4 stand-in (remat, AdamW lr 3e-4,
    2 warm-up epochs, BatchLoader(train, 240, seed=3)) and saved at
    ``path`` with save_pytree; a base already at ``path`` is read
    instead. Returns the tree with numpy leaves. Over an hour on an
    8-core CPU."""
    import dataclasses
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np
    from gslora_tpu.checkpoints.io import load_pytree, save_pytree
    from gslora_tpu.config import (DataConfig, LoraConfig, OptimConfig,
                                   RunConfig, ViTConfig)
    from gslora_tpu.data.pipeline import BatchLoader
    from gslora_tpu.data.synthetic import synthetic_face_dataset
    from gslora_tpu.engine.pretrain import pretrain
    from gslora_tpu.models.vit import init_vit_params

    model = ViTConfig(**FLAGSHIP, head_type="Softmax")
    lora = LoraConfig(rank=8)
    params = init_vit_params(jax.random.key(0), model, lora,
                             param_dtype=jnp.float32)
    if os.path.exists(path):
        params = load_pytree(path, params)
    else:
        train = synthetic_face_dataset(num_classes=100, per_class=24,
                                       image_size=112, seed=0, noise=2.4)
        cfg = RunConfig(model=dataclasses.replace(model, remat=True),
                        lora=lora,
                        optim=OptimConfig(lr=3e-4, warmup_epochs=2,
                                          epochs=12),
                        data=DataConfig(batch_size=240))
        state, _ = pretrain(cfg, params,
                            lambda: BatchLoader(train, 240, seed=3),
                            epochs=12, compute_dtype=jnp.float32)
        params = state.params
        save_pytree(path, params)
    return jax.tree.map(np.asarray, params)
