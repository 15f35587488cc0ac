"""Shared set-up of tests/test_torch_mesh_*.py: the rank spawn, the one
parameter tree both packages start from, the JAX CLI's one-device run of
a scenario and the comparisons (the JAX suite's tolerances at fp32,
tests/test_mesh_loop.py:286-291)."""
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import torch_dp_worker as dpw
import torch_mesh_worker as mw

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
RTOL, ATOL = 1e-4, 1e-5
ACC_TOL = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(outdir, names, world, device="cpu"):
    """Start ``names`` in ``world`` fresh ranks (tests/torch_mesh_worker.py)
    and return the function that waits for them: it raises with a rank's
    log if any fails or outlives RANK_TIMEOUT_S, else returns each rank's
    results. The caller works meanwhile (the references)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_mesh_worker", str(r), str(world),
         str(port), str(outdir), device, *names], cwd=outdir, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    started = time.monotonic()

    def finish():
        logs = []
        try:
            for p in procs:
                left = RANK_TIMEOUT_S - (time.monotonic() - started)
                logs.append(p.communicate(timeout=max(left, 1.0))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
        return [{name: torch.load(Path(outdir) / f"{name}.rank{r}.pt",
                                  weights_only=False) for name in names}
                for r in range(world)]

    return finish


def init_tree(depth=2, overrides=None, pos="FFN"):
    """One parameter tree for both packages (numpy leaves, drawn by the JAX
    package's init) of the tiny model with ``overrides`` and a rank-4
    LoRA at ``pos``, its LoRA B factors nonzero."""
    import jax

    import gslora_tpu.config as jc
    from gslora_tpu.models.vit import init_vit_params
    p = jax.tree.map(np.asarray, init_vit_params(
        jax.random.key(0), jc.ViTConfig(**{**dpw.MODEL, "depth": depth,
                                           **(overrides or {})}),
        jc.LoraConfig(rank=4, pos=pos)))
    rng = np.random.RandomState(1)
    for sub in p["lora"].values():
        for name in [k for k in sub if k.startswith("B")]:
            sub[name] = (0.05 * rng.randn(*sub[name].shape)).astype(
                np.float32)
    return p


def save_tree(tree, path):
    from gslora_tpu_torch.models.convert import flatten_tree
    np.savez(path, **flatten_tree(tree))


def pretrained_tree(init, monkeypatch):
    """A base that knows the classes: the port's one-process pretrain of
    tests/torch_dp_worker.py from ``init``, with ``init``'s LoRA."""
    from gslora_tpu_torch.models.convert import unflatten_tree
    one = dpw.run_scenario("pretrain", init, setattr_=monkeypatch.setattr)
    base = unflatten_tree({k[5:]: v for k, v in one["params"].items()
                           if k.startswith("base.")})
    return {"base": base, "lora": init["lora"]}


def jax_run(cli, argv, tree, monkeypatch, overrides=None):
    """The JAX CLI ``cli`` on one device with ``argv`` (no --dp, no layout,
    no --device), the tiny model with ``overrides`` and ``tree``; the
    report, the final parameters (flat numpy), the eval history of every
    forget run and the pair verifications it logged."""
    import jax
    import jax.numpy as jnp

    import gslora_tpu.config as jc
    module = importlib.import_module(f"gslora_tpu.cli.{cli}")
    orig = jc.config_from_args

    def config(args):
        cfg = orig(args)
        cfg.model = jc.ViTConfig(**{**dpw.MODEL, "depth": args.vit_depth,
                                    "head_type": args.head,
                                    **(overrides or {})})
        cfg.ver_freq = dpw.VER_FREQ
        return cfg

    monkeypatch.setattr(module, "config_from_args", config)
    import gslora_tpu.metrics.logging as jlog
    verification = mw.verification_spy(jlog, monkeypatch.setattr)
    monkeypatch.setattr(module, "build_params", lambda cfg, seed=None:
                        jax.tree.map(jnp.asarray, tree))
    seen = {"history": []}

    def host(t):
        from gslora_tpu_torch.models.convert import flatten_tree
        return {k: np.asarray(v, np.float32)
                for k, v in flatten_tree(jax.tree.map(np.asarray, t)).items()}

    if cli == "train_pretrain":
        make = module.make_pretrain_step

        def spy_make(*a, **k):
            step = make(*a, **k)

            def spy_step(state, *args):
                state, m = step(state, *args)
                seen["state"] = state
                return state, m
            return spy_step
        monkeypatch.setattr(module, "make_pretrain_step", spy_make)
    elif cli == "train_forget":
        run = module.run_forget_training

        def spy(*a, **k):
            res = run(*a, **k)
            seen["params"] = host(res.state.params)
            seen["history"] = [res.history]
            return res
        monkeypatch.setattr(module, "run_forget_training", spy)
    else:
        from gslora_tpu.engine import continual
        monkeypatch.setattr(continual, "reinit_lora", lambda key, tree:
                            jax.tree.map(jnp.asarray, dpw.np_reinit(tree)))
        run = module.run_continual_forgetting

        def spy(*a, **k):
            out = run(*a, **k)
            seen["params"] = host(out.final_params)
            seen["history"] = [t.result.history for t in out.tasks]
            return out
        monkeypatch.setattr(module, "run_continual_forgetting", spy)
    report = module.main(list(argv) + ["--outdir", ""])
    if "state" in seen:
        seen["params"] = host(seen.pop("state").params)
    return {"report": report, "verification": verification, **seen}


def references(names, trees, monkeypatch, outdir=None):
    """The port's one-process run and the JAX one-device run of each
    scenario, one of each per distinct (CLI, argv, tree); a scenario of
    torch_mesh_worker.WRITES writes its files to ``<outdir>/<name>.one``."""
    one, jax_ref, done = {}, {}, {}
    for name in names:
        cli, argv, _, tree_name, overrides, _ = mw.SCENARIOS[name]
        key = (cli, tuple(argv), tree_name, tuple(sorted(overrides.items())))
        if name in mw.WRITES:
            key += (name,)
        if key not in done:
            tree = trees[tree_name]
            port = mw.run(name, tree, layout=False,
                          setattr_=monkeypatch.setattr,
                          outdir=str(Path(outdir) / f"{name}.one")
                          if name in mw.WRITES else "")
            ref = jax_run(cli, argv, tree, monkeypatch, overrides) \
                if not overrides or name in mw.STRUCTURAL else None
            done[key] = (port, ref)
        one[name], jax_ref[name] = done[key]
    return one, jax_ref


def assert_params(got, want, rtol=RTOL, atol=ATOL, what=""):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def assert_history(got, want):
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        assert len(gt) == len(wt) > 0
        for g, w in zip(gt, wt):
            assert (g["epoch"], g["batch"]) == (w["epoch"], w["batch"])
            for k in ("Test forget Accuracy", "Test remain Accuracy",
                      "H_mean"):
                assert abs(g[k] - w[k]) < ACC_TOL, (k, g[k], w[k])


def assert_reports(got, want):
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        for k, v in w.items():
            if k == "time_to_forget_s":
                continue
            if k == "norm_list":
                np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL)
            elif isinstance(v, float):
                assert abs(g[k] - v) < ACC_TOL, (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


def expected_spec(name, ndim, data, model, tp, fsdp, pp=False):
    """The mesh axis of each dim of the leaf ``name`` on a ``data`` x
    ``model`` mesh, by the JAX rules written out (gslora_tpu/parallel/
    mesh.py:220-304)."""
    parts = name.split(".")
    spec = [None] * ndim
    if pp and model > 1:
        if "blocks" in parts or "ffn" in parts or "attn" in parts:
            spec[0] = "model"
        return spec
    if "head" in parts and parts[-1] == "weight" and model > 1:
        spec[0] = "model"
        return spec
    if tp and model > 1:
        dim = {("fc1", "kernel", 3): 2, ("fc1", "bias", 2): 1,
               ("fc2", "kernel", 3): 1, ("ffn", "B1", 3): 1,
               ("ffn", "A2", 3): 2}.get((*parts[-2:], ndim))
        if dim is not None:
            spec[dim] = "model"
    if fsdp and data > 1 and parts[-1] == "kernel" and ndim == 3:
        dim = {"qkv": 1, "attn_out": 2, "fc1": 1, "fc2": 2}.get(parts[-2])
        if dim is not None:
            spec[dim] = "data"
    return spec


def expected_shard(whole, name, rank, data, model, tp, fsdp, pp=False,
                   slices=1):
    """Rank ``rank``'s slice of the whole leaf (rank r sits at data index
    (r // model) % data, model index r % model; every slice holds the
    same shards)."""
    t = torch.from_numpy(whole)
    for dim, axis in enumerate(expected_spec(name, t.ndim, data, model, tp,
                                             fsdp, pp)):
        if axis is not None:
            n, i = (model, rank % model) if axis == "model" \
                else (data, (rank // model) % data)
            t = t.chunk(n, dim=dim)[i]
    return t.numpy()


def layout_of(name):
    """(data, model, tp, fsdp, pp, slices) of a scenario."""
    flags = mw.SCENARIOS[name][2]
    world = mw.SCENARIOS[name][5]

    def flag(key, default):
        return int(flags[flags.index(key) + 1]) if key in flags \
            else default
    model, slices = flag("--mesh_model", 1), flag("--mesh_slices", 1)
    data = flag("--mesh_data", world // (model * slices))
    return data, model, "--tp" in flags, "--fsdp" in flags, \
        "--pp" in flags, slices


def jax_refusal(mesh_kw, flags, baseline=False):
    """The ValueError message of what JAX refuses for ``flags`` on the mesh
    of ``mesh_kw`` over its host devices: the baseline runners' pp guard
    first (``baseline``: JAX's run_regularization_task raises it before
    anything else), then placement()."""
    import gslora_tpu.config as jc
    from gslora_tpu.baselines.regularization import run_regularization_task
    from gslora_tpu.parallel.mesh import make_mesh, placement
    try:
        if baseline and flags.get("pp"):
            run_regularization_task(
                jc.RunConfig(mesh=jc.MeshConfig(**mesh_kw, **flags)), {},
                None, None, None, lam=0.0, anchors=[], importances=[])
        placement(make_mesh(jc.MeshConfig(**mesh_kw)), **flags)
    except ValueError as e:
        return str(e)
    finally:
        placement(None)
    raise AssertionError(f"JAX runs {flags} on {mesh_kw}")
