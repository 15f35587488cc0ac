"""The ViT-B/16 ImageNet-100 path of the port (models/vit.py's soft split,
models/vit_imagenet.py, cli/common.py's head preparation, missing-class
set and resume, checkpoints/msgpack.py, cli/export_torch.py and the
imagenet100 mode of cli/train_forget_cl.py) against the JAX package on the
CPU: fp32, dropout 0, the same weights and data.

Tolerances: patchify, state-dict conversion, head slicing and msgpack
reading exact; forwards 1e-3 for embeddings and 5e-3 for logits
(tests/test_parity_at_scale.py); the CL CLI's trained LoRA rtol 5e-3
(tests/test_training_parity.py), its accuracies within one sample.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.cli.common as jcommon
import gslora_tpu.cli.export_torch as jexport
import gslora_tpu.cli.train_forget_cl as jcli
import gslora_tpu.config as jc
import gslora_tpu.engine.continual as jcont
import gslora_tpu.models.vit_imagenet as jvi
from gslora_tpu.checkpoints.io import save_pytree, save_task_checkpoint
from gslora_tpu.models.vit import init_vit_params as jax_init
from gslora_tpu.models.vit import patchify as jax_patchify
from gslora_tpu.models.vit import vit_apply as jax_vit_apply

import gslora_tpu_torch.cli.common as tcommon
import gslora_tpu_torch.cli.export_torch as texport
import gslora_tpu_torch.cli.train_forget_cl as tcli
import gslora_tpu_torch.config as tc
import gslora_tpu_torch.engine.continual as tcont
import gslora_tpu_torch.models.vit_imagenet as tvi
from gslora_tpu_torch.checkpoints import msgpack
from gslora_tpu_torch.checkpoints.io import save_params
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax
from gslora_tpu_torch.models.vit import init_vit_params, patchify, vit_apply


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# a narrow ViT-B/16: its conv patchify, qkv bias, head-dim scale, Softmax
# head and ImageNet input norm, at 48x48 (9 patches)
B16 = dict(image_size=48, patch_size=16, dim=32, depth=2, heads=2,
           dim_head=16, mlp_dim=64, num_class=20, head_type="Softmax",
           dropout=0.0, emb_dropout=0.0, soft_split=True, ac_patch_size=16,
           pad=0, qkv_bias=True, attn_scale="dim_head",
           input_norm="imagenet")
# a narrow VITs (the face model's overlapping soft split) at 32x32
VITS = dict(image_size=32, patch_size=8, dim=32, depth=2, heads=2,
            dim_head=16, mlp_dim=64, num_class=6, head_type="CosFace",
            dropout=0.0, emb_dropout=0.0, soft_split=True, ac_patch_size=12,
            pad=4)


def _jax_params(model, rank=4, seed=0):
    """JAX-initialised weights with nonzero LoRA B, as numpy arrays."""
    p = jax_init(jax.random.key(seed), jc.ViTConfig(**model),
                 jc.LoraConfig(rank))
    rng = np.random.RandomState(seed + 1)
    for sub in p["lora"].values():
        for name in sub:
            if name.startswith("B"):
                sub[name] = jnp.asarray(0.3 * rng.randn(*sub[name].shape)
                                        .astype(np.float32))
    return jax.tree.map(np.asarray, p)


def _torchvision_sd(model, rank=0, seed=0):
    """A torchvision vit_b_16-named state dict of numpy arrays for
    ``model`` (its head as wide as model["num_class"]), with the loralib
    FFN keys when ``rank`` > 0."""
    rng = np.random.RandomState(seed)
    d, m, L, k = model["dim"], model["mlp_dim"], model["depth"], \
        model["patch_size"]
    n = (model["image_size"] // k) ** 2 + 1

    def r(*shape, s=0.1):
        return (s * rng.randn(*shape)).astype(np.float32)

    sd = {"conv_proj.weight": r(d, 3, k, k), "conv_proj.bias": r(d),
          "class_token": r(1, 1, d), "encoder.pos_embedding": r(1, n, d),
          "encoder.ln.weight": 1 + r(d), "encoder.ln.bias": r(d),
          "heads.head.weight": r(model["num_class"], d),
          "heads.head.bias": r(model["num_class"])}
    for i in range(L):
        p = f"encoder.layers.encoder_layer_{i}"
        sd.update({
            f"{p}.ln_1.weight": 1 + r(d), f"{p}.ln_1.bias": r(d),
            f"{p}.self_attention.in_proj_weight": r(3 * d, d),
            f"{p}.self_attention.in_proj_bias": r(3 * d),
            f"{p}.self_attention.out_proj.weight": r(d, d),
            f"{p}.self_attention.out_proj.bias": r(d),
            f"{p}.ln_2.weight": 1 + r(d), f"{p}.ln_2.bias": r(d),
            f"{p}.mlp.0.weight": r(m, d), f"{p}.mlp.0.bias": r(m),
            f"{p}.mlp.3.weight": r(d, m), f"{p}.mlp.3.bias": r(d)})
        if rank:
            sd.update({f"{p}.mlp.0.lora_A": r(rank, d),
                       f"{p}.mlp.0.lora_B": r(m, rank, s=0.05),
                       f"{p}.mlp.3.lora_A": r(rank, m),
                       f"{p}.mlp.3.lora_B": r(d, rank, s=0.05)})
    return sd


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].float().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# (a) the soft split, (b) forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(image_size=112, patch_size=8, ac_patch_size=12, pad=4),  # VITs
    dict(image_size=224, patch_size=16, ac_patch_size=16, pad=0),  # B/16
], ids=["12-8-4", "16-16-0"])
def test_soft_split_patchify_matches_jax_exactly(kw):
    x = np.random.RandomState(0).randn(2, 3, kw["image_size"],
                                       kw["image_size"]).astype(np.float32)
    want = np.asarray(jax_patchify(jnp.asarray(x),
                                   jc.ViTConfig(soft_split=True, **kw)))
    cfg = tc.ViTConfig(soft_split=True, **kw)
    got = patchify(torch.from_numpy(x), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.num_patches, cfg.patch_dim)
    np.testing.assert_array_equal(got, want)
    # the fresh tree's patch projection is sized by the soft split
    p = init_vit_params(torch.Generator().manual_seed(0), cfg)
    assert p["base"]["patch"]["kernel"].shape == (cfg.patch_dim, cfg.dim)


@pytest.mark.parametrize("model", [VITS, B16], ids=["VITs", "ViT-B16"])
def test_soft_split_forward_matches_jax(model):
    p = _jax_params(model)
    # models/convert carries the soft-split patch kernel by its path
    tp = params_from_jax(p)
    assert tp["base"]["patch"]["kernel"].shape == \
        p["base"]["patch"]["kernel"].shape
    size = model["image_size"]
    x = np.random.RandomState(2).rand(4, 3, size, size).astype(np.float32)
    y = np.array([0, 3, 5, 1], np.int32)
    lj, ej = jax_vit_apply(p, jnp.asarray(x), jnp.asarray(y),
                           jc.ViTConfig(**model), jc.LoraConfig(4),
                           compute_dtype=jnp.float32)
    lt, et = vit_apply(tp, torch.from_numpy(x), torch.from_numpy(y),
                       tc.ViTConfig(**model), tc.LoraConfig(4),
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("argv", [["-n", "VITs"],
                                  ["-n", "VIT_B16", "-d", "imagenet100"]],
                         ids=["VITs", "VIT_B16"])
def test_cli_models_match_jax_configs(argv):
    """The CLI's VITs and VIT_B16 are the JAX package's configs, and the
    port builds them at full size: a fresh tree whose patch projection has
    the soft split's rows embeds one image."""
    want = jc.config_from_args(jc.build_parser().parse_args(argv)).model
    cfg = tc.config_from_args(tc.build_parser().parse_args(argv))
    for f in ("image_size", "patch_size", "dim", "depth", "heads",
              "dim_head", "mlp_dim", "num_class", "head_type", "dropout",
              "soft_split", "ac_patch_size", "pad", "qkv_bias",
              "attn_scale", "input_norm"):
        assert getattr(cfg.model, f) == getattr(want, f), f
    assert cfg.model.soft_split and cfg.model.seq_len == 197
    p = init_vit_params(torch.Generator().manual_seed(0), cfg.model)
    assert p["base"]["patch"]["kernel"].shape == (cfg.model.patch_dim,
                                                  cfg.model.dim)
    size = cfg.model.image_size
    x = torch.rand(1, 3, size, size, generator=torch.Generator()
                   .manual_seed(1))
    emb = vit_apply(p, x, None, cfg.model, cfg.lora,
                    compute_dtype=torch.float32)
    assert emb.shape == (1, cfg.model.dim) and bool(emb.isfinite().all())


# ---------------------------------------------------------------------------
# (c) torchvision state dicts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 4], ids=["no-lora-keys", "lora-keys"])
def test_torchvision_state_dict_matches_jax(rank):
    sd = _torchvision_sd(B16, rank=rank)
    jm, tm = jc.ViTConfig(**B16), tc.ViTConfig(**B16)
    want = jvi.from_torchvision_state_dict(sd, jm, jc.LoraConfig(4))
    got = tvi.from_torchvision_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tm,
        tc.LoraConfig(4))
    _assert_trees_equal(got["base"], jax.tree.map(np.asarray, want["base"]))
    if rank:
        _assert_trees_equal(got["lora"],
                            jax.tree.map(np.asarray, want["lora"]))
    else:
        # a fresh LoRA in both (each package's own generator): kaiming A,
        # zero B; from an explicit generator, reproducibly
        shapes = {k: v.shape for k, v in flatten_tree(want["lora"]).items()}
        assert {k: tuple(v.shape) for k, v in
                flatten_tree(got["lora"]).items()} == shapes
        assert not got["lora"]["ffn"]["B1"].any()
        again = tvi.from_torchvision_state_dict(
            sd, tm, tc.LoraConfig(4),
            generator=torch.Generator().manual_seed(0))
        _assert_trees_equal(again["lora"], got["lora"])
    # and back: the same names and values as JAX's exporter, and the dict
    # it started from
    back = tvi.to_torchvision_state_dict(got, tm)
    jback = jvi.to_torchvision_state_dict(jax.tree.map(np.asarray, want), jm)
    if not rank:  # the fresh LoRAs differ: compare the base names only
        jback = {k: v for k, v in jback.items() if "lora_" not in k}
        back = {k: v for k, v in back.items() if "lora_" not in k}
    assert set(back) == set(jback)
    for k, w in jback.items():
        np.testing.assert_array_equal(back[k].numpy(), w, err_msg=k)
        if k in sd:
            np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


# ---------------------------------------------------------------------------
# (d) head slicing and the missing-class set
# ---------------------------------------------------------------------------


WNIDS = [f"n{i:08d}" for i in range(20)]


def _head(rows=20, d=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"weight": rng.randn(rows, d).astype(np.float32),
            "bias": rng.randn(rows).astype(np.float32)}


def test_modify_and_resume_head_match_jax():
    head = _head()
    id_map = {0: 7, 1: 12, 2: 19}
    want = jvi.modify_head({"base": {"head": jax.tree.map(jnp.asarray, head)},
                            "lora": {}}, id_map)
    got = tvi.modify_head({"base": {"head": {k: torch.from_numpy(v) for k, v
                                             in head.items()}},
                           "lora": {}}, id_map)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(got["base"]["head"][k].numpy(),
                                      np.asarray(want["base"]["head"][k]))
        np.testing.assert_array_equal(got["original_head"][k].numpy(),
                                      head[k])
    back = tvi.resume_head(got, got["original_head"])
    jback = jvi.resume_head(want, want["original_head"])
    assert set(back) == set(jback) == {"base", "lora"}
    np.testing.assert_array_equal(back["base"]["head"]["weight"].numpy(),
                                  np.asarray(jback["base"]["head"]["weight"]))


def _cfgs(root, num_class=3):
    def cfg(C):
        return C.RunConfig(model=C.ViTConfig(**{**B16,
                                                "num_class": num_class}),
                           data=C.DataConfig(data_mode="imagenet100",
                                             data_root=str(root)))
    return cfg(jc), cfg(tc)


class _DS:  # classes sorted, as ImageFolder yields them
    classes = [WNIDS[2], WNIDS[5], WNIDS[9]]


@pytest.mark.parametrize("wnid_file", [True, False],
                         ids=["wnid-map", "no-wnid-file"])
def test_prepare_imagenet_head_matches_jax(tmp_path, wnid_file):
    if wnid_file:
        (tmp_path / "imagenet_folder_names.txt").write_text(
            "\n".join(WNIDS) + "\n")
    jcfg, tcfg = _cfgs(tmp_path)
    head = _head()
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jout, jorig = jcommon.prepare_imagenet_head(
            jcfg, {"base": {"head": jax.tree.map(jnp.asarray, head)},
                   "lora": {}}, _DS())
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tout, torig = tcommon.prepare_imagenet_head(
            tcfg, {"base": {"head": {k: torch.from_numpy(v) for k, v in
                                     head.items()}}, "lora": {}}, _DS())
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == (0 if wnid_file else 1)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(tout["base"]["head"][k].numpy(),
                                      np.asarray(jout["base"]["head"][k]))
        np.testing.assert_array_equal(torig[k].numpy(), np.asarray(jorig[k]))
    rows = [2, 5, 9] if wnid_file else [0, 1, 2]
    np.testing.assert_array_equal(tout["base"]["head"]["weight"].numpy(),
                                  head["weight"][rows])
    # a head already of the run's width is left alone
    again, orig = tcommon.prepare_imagenet_head(tcfg, tout, _DS())
    assert again is tout and orig is None


def test_prepare_imagenet_head_rejects_unknown_classes(tmp_path):
    (tmp_path / "imagenet_folder_names.txt").write_text("\n".join(WNIDS))
    jcfg, tcfg = _cfgs(tmp_path)

    class Odd:
        classes = [WNIDS[1], "n99999999", WNIDS[3]]

    head = _head()
    with pytest.raises(ValueError, match="not in the ImageNet-1k list"):
        jcommon.prepare_imagenet_head(
            jcfg, {"base": {"head": jax.tree.map(jnp.asarray, head)}}, Odd())
    with pytest.raises(ValueError, match="not in the ImageNet-1k list"):
        tcommon.prepare_imagenet_head(
            tcfg, {"base": {"head": {k: torch.from_numpy(v) for k, v in
                                     head.items()}}}, Odd())


def test_build_missing_dataset_matches_jax(tmp_path):
    """Held-out folders get global ImageNet-1k labels (as
    tests/test_vit_imagenet.py builds them), decoded alike."""
    from PIL import Image
    root = tmp_path / "data"
    root.mkdir()
    (root / "imagenet_folder_names.txt").write_text("\n".join(WNIDS[:6]))
    miss = tmp_path / "nonexist"
    rng = np.random.RandomState(0)
    for w in (WNIDS[4], WNIDS[1]):
        (miss / w).mkdir(parents=True)
        for name in ("a.jpg", "b.png"):
            Image.fromarray(rng.randint(0, 256, (40, 52, 3), np.uint8)).save(
                miss / w / name)
    (miss / "notes.txt").write_text("not a class")
    jcfg, tcfg = _cfgs(root)
    jds = jcommon.build_missing_dataset(jcfg, str(miss))
    tds = tcommon.build_missing_dataset(tcfg, str(miss))
    assert tds.targets == jds.targets == [1, 1, 4, 4]
    assert [p for p, _ in tds.samples] == [p for p, _ in jds.samples]
    np.testing.assert_array_equal(tds.decode_batch(range(4)),
                                  jds.decode_batch(range(4)))
    (miss / "n99999999").mkdir()
    with pytest.raises(ValueError, match="not in the global"):
        tcommon.build_missing_dataset(tcfg, str(miss))
    (root / "imagenet_folder_names.txt").unlink()
    with pytest.raises(FileNotFoundError, match="imagenet_folder_names"):
        tcommon.build_missing_dataset(tcfg, str(miss))


# ---------------------------------------------------------------------------
# (e) the imagenet100 CL CLI against the JAX CLI
# ---------------------------------------------------------------------------


# the tiny CLI model: 224x224 (the ImageNet eval transform's crop), 32x32
# conv patches (49 tokens + CLS), 6 classes in the run
CLI_MODEL = {**B16, "image_size": 224, "patch_size": 32, "ac_patch_size": 32,
             "dim": 16, "heads": 2, "dim_head": 8, "mlp_dim": 32,
             "num_class": 6}
TRAIN_WNIDS = [WNIDS[i] for i in (1, 3, 6, 8, 11, 14)]
MISS_WNIDS = [WNIDS[i] for i in (2, 17)]


def _image_folder(root):
    """train/ and test/ of 6 classes (4 and 2 images), the 20-wnid list
    with the 6 at scattered indices, and 2 held-out classes of 3 images."""
    from PIL import Image
    rng = np.random.RandomState(7)
    data = root / "data"
    for split, n in (("train", 4), ("test", 2)):
        for c, w in enumerate(TRAIN_WNIDS):
            (data / split / w).mkdir(parents=True)
            for i in range(n):
                base = rng.randint(0, 256, (1, 1, 3))
                img = np.clip(base + rng.randint(-40, 40, (64, 80, 3)), 0,
                              255).astype(np.uint8)
                Image.fromarray(img).save(data / split / w / f"{i}.jpg")
    (data / "imagenet_folder_names.txt").write_text("\n".join(WNIDS))
    for w in MISS_WNIDS:
        (root / "miss" / w).mkdir(parents=True)
        for i in range(3):
            img = rng.randint(0, 256, (70, 60, 3)).astype(np.uint8)
            Image.fromarray(img).save(root / "miss" / w / f"{i}.jpg")
    return data, root / "miss"


def _np_reinit(lora_tree):
    """One numpy-drawn LoRA reinit for both packages (their generators
    draw different numbers), as tests/test_torch_continual.py does."""
    out = {}
    for pos, sub in lora_tree.items():
        out[pos] = {}
        for name, arr in sub.items():
            shape = tuple(arr.shape)
            rng = np.random.RandomState(sum(map(ord, pos + name)))
            b = np.sqrt(6.0 / (51.0 * shape[-1]))
            out[pos][name] = rng.uniform(-b, b, shape).astype(np.float32) \
                if name.startswith("A") else np.zeros(shape, np.float32)
    return out


def _tiny(cli_module, C, monkeypatch):
    orig = C.config_from_args

    def patched(args):
        cfg = orig(args)
        cfg.model = C.ViTConfig(**CLI_MODEL)
        return cfg

    monkeypatch.setattr(cli_module, "config_from_args", patched)


def _spy(monkeypatch, module):
    """Keep the continual result of a CLI run."""
    kept = []
    orig = module.run_continual_forgetting

    def run(*a, **k):
        kept.append(orig(*a, **k))
        return kept[-1]

    monkeypatch.setattr(module, "run_continual_forgetting", run)
    return kept


def test_imagenet100_cl_cli_matches_jax(tmp_path, monkeypatch):
    data, miss = _image_folder(tmp_path)
    sd = _torchvision_sd({**CLI_MODEL, "num_class": 20}, rank=4, seed=3)
    ckpt = tmp_path / "vit_b16.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    for module, C in ((jcli, jc), (tcli, tc)):
        _tiny(module, C, monkeypatch)
    monkeypatch.setattr(jcont, "reinit_lora", lambda key, tree: jax.tree.map(
        jnp.asarray, _np_reinit(tree)))
    monkeypatch.setattr(tcont, "reinit_lora", lambda gen, tree: {
        pos: {k: torch.from_numpy(v) for k, v in sub.items()}
        for pos, sub in _np_reinit(tree).items()})
    kept = {"jax": _spy(monkeypatch, jcli), "torch": _spy(monkeypatch, tcli)}
    argv = ["--one_stage", "-b", "4", "-d", "imagenet100", "-n", "VIT_B16",
            "--head", "Softmax", "--lora_rank", "4", "--lr", "1e-2",
            "--warmup-epochs", "0", "--BND", "10", "--alpha", "1e-4",
            "--alpha_epoch", "0", "--min-lr", "1e-5", "--num_tasks", "2",
            "--num_of_first_cls", "4", "--per_forget_cls", "1",
            "--cl_beta_list", "0.15", "0.15", "-e", "1",
            "--data_ratio", "1.0", "--compute_dtype", "float32",
            "--data_root", str(data), "--imagenet_miss_root", str(miss),
            "-r", str(ckpt), "--profile_dir", str(tmp_path / "prof")]
    reports, logged = {}, {}
    for name, module, extra in (("jax", jcli, []),
                                ("torch", tcli, ["--device", "cpu"])):
        out = tmp_path / name
        reports[name] = module.main(argv + ["--outdir", str(out)] + extra)
        logged[name] = {k: v for line in
                        (out / "metrics.jsonl").read_text().splitlines()
                        for k, v in json.loads(line).items()
                        if k.startswith("imagenet-val-miss")}
    # the head cut 20 -> 6 by the wnid list, exact (task 0's snapshot:
    # the head is never trained)
    jsnap = msgpack.load(str(tmp_path / "jax" / "task-level" /
                             "Backbone_task_0.msgpack"))
    tsnap = torch.load(tmp_path / "torch" / "task-level" /
                       "Backbone_task_0.pth")
    rows = [WNIDS.index(w) for w in TRAIN_WNIDS]
    for k in ("weight", "bias"):
        want = sd[f"heads.head.{k}"][rows]
        np.testing.assert_array_equal(tsnap[f"base.head.{k}"].numpy(), want)
        np.testing.assert_array_equal(jsnap["base"]["head"][k].numpy(), want)
    # missing-class accuracy (the 20-way head put back): equal before
    assert set(logged["torch"]) == set(logged["jax"]) == {
        "imagenet-val-miss_before", "imagenet-val-miss_after"}
    assert logged["torch"]["imagenet-val-miss_before"] == \
        logged["jax"]["imagenet-val-miss_before"]
    one = 100.0 / 6  # one of the 6 held-out images
    assert abs(logged["torch"]["imagenet-val-miss_after"] -
               logged["jax"]["imagenet-val-miss_after"]) <= one + 1e-9
    # the trained LoRA
    want = flatten_tree(jax.tree.map(np.asarray,
                                     kept["jax"][0].final_params["lora"]))
    got = flatten_tree(kept["torch"][0].final_params["lora"])
    assert set(got) == set(want)
    assert float(got["ffn.B1"].abs().max()) > 0  # trained from B = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=5e-3, atol=5e-5,
                                   err_msg=k)
    # accuracies after training within one sample of each test set
    for t, j in zip(reports["torch"], reports["jax"]):
        assert t["task"] == j["task"]
        for key, n in (("forget_acc", 2), ("remain_acc", 2 * (4 - t["task"])),
                       ("forget_acc_before", 2)):
            assert abs(t[key] - j[key]) <= 100.0 / n + 1e-9, (t["task"], key)
    assert reports["torch"][1]["old_acc"] == pytest.approx(
        reports["jax"][1]["old_acc"], abs=100.0 / 2 + 1e-9)


# ---------------------------------------------------------------------------
# (h) .msgpack checkpoints of the JAX package
# ---------------------------------------------------------------------------


FACE = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
            dim_head=16, mlp_dim=64, num_class=6, dropout=0.0,
            emb_dropout=0.0)


def test_msgpack_reader_reads_every_type():
    """Every msgpack type flax writes, and its ext arrays, as the msgpack
    package reads them."""
    import msgpack as mp
    from flax import serialization
    rng = np.random.RandomState(0)
    tree = {"pos": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                    2 ** 63 + 5],
            "neg": [-1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
            "floats": [0.5, -1e300, float("inf")], "none": None,
            "bools": [True, False], "short": "s" * 31, "str8": "é" * 40,
            "str16": "x" * 300, "bytes": b"\x00\x01" * 200,
            "scalar32": np.float32(1.5), "scalar_i": np.int64(-7),
            "wide": {f"k{i}": i for i in range(20)},
            "arrays": {"f32": rng.randn(3, 4).astype(np.float32),
                       "f64": rng.randn(5), "i32": np.arange(6, dtype=np.int32)
                       .reshape(2, 3), "u8": np.arange(300, dtype=np.uint8)
                       .reshape(-1)[:17], "bool": rng.rand(4) > 0.5,
                       "empty": np.zeros((0, 3), np.float32),
                       "scalar0": np.asarray(3.0, np.float32)}}
    data = serialization.msgpack_serialize(tree)
    got = msgpack.loads(data)
    ref = mp.unpackb(data, raw=False, strict_map_key=False,
                     ext_hook=lambda c, d: (c, d))
    assert {k: v for k, v in got.items() if k not in (
        "arrays", "scalar32", "scalar_i")} == {
        k: v for k, v in ref.items() if k not in (
            "arrays", "scalar32", "scalar_i")}
    for k, v in tree["arrays"].items():
        assert got["arrays"][k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got["arrays"][k].numpy(), v)
    assert got["scalar32"].shape == () and float(got["scalar32"]) == 1.5
    assert int(got["scalar_i"]) == -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msgpack_checkpoints_read_exactly(tmp_path, monkeypatch, dtype):
    """save_pytree and save_task_checkpoint files, fp32 and bf16, and
    flax's chunked form of large leaves (the chunk size made small)."""
    from flax import serialization
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = jax_init(jax.random.key(0), jc.ViTConfig(**FACE), jc.LoraConfig(4),
                 param_dtype=jdt)
    save_pytree(str(tmp_path / "full.msgpack"), p)
    task = save_task_checkpoint(str(tmp_path), 3, {"base": p["base"]})
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    save_pytree(str(tmp_path / "chunked.msgpack"), p)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    # the base in the run's dtype, the LoRA in fp32
    dtypes = {k: str(v.dtype) for k, v in flatten_tree(p).items()}
    assert set(dtypes.values()) == ({"float32"} if dtype == "float32"
                                    else {"bfloat16", "float32"})
    for path, want in ((tmp_path / "full.msgpack", host),
                       (tmp_path / "chunked.msgpack", host),
                       (task, {"base": host["base"]})):
        got = msgpack.load(str(path))
        assert {k: str(t.dtype)[6:] for k, t in
                flatten_tree(got).items()} == {
            k: v for k, v in dtypes.items() if k in flatten_tree(want)}
        _assert_trees_equal(got, want)


def _run(C, rank=4, pos="FFN", resume="", param_dtype="float32"):
    return C.RunConfig(model=C.ViTConfig(**FACE),
                       lora=C.LoraConfig(rank=rank, pos=pos), resume=resume,
                       param_dtype=param_dtype)


@pytest.mark.parametrize("case", ["same-rank", "rank0-ckpt-into-rank4",
                                  "rank4-ckpt-into-rank0", "wrong-pos",
                                  "bf16-ckpt", "task-snapshot"])
def test_msgpack_resume_follows_the_jax_rules(tmp_path, case):
    ck_rank, run_rank, pos = {"rank0-ckpt-into-rank4": (0, 4, "FFN"),
                              "rank4-ckpt-into-rank0": (4, 0, "FFN"),
                              "wrong-pos": (4, 4, "Attention")}.get(
        case, (4, 4, "FFN"))
    jdt = jnp.bfloat16 if case == "bf16-ckpt" else jnp.float32
    p = _jax_params(FACE, rank=ck_rank, seed=5)
    p = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    path = str(tmp_path / "ckpt.msgpack")
    if case == "task-snapshot":
        path = save_task_checkpoint(str(tmp_path), 0, {"base": p["base"]})
    else:
        save_pytree(path, p)
    jcfg, tcfg = _run(jc, run_rank, pos, path), _run(tc, run_rank, pos, path)
    fresh = init_vit_params(torch.Generator().manual_seed(tcfg.data.seed),
                            tcfg.model, tcfg.lora)
    if case == "wrong-pos":
        for build, cfg in ((jcommon.build_params, jcfg),
                           (tcommon.build_params, tcfg)):
            with pytest.raises(ValueError, match="Wrong resume"):
                build(cfg)
        return
    if case == "task-snapshot":
        # the JAX function cannot load its own task snapshots (flax's
        # from_state_dict wants the "lora" key); the port loads the base
        # and keeps the fresh LoRA, as for its own snapshots
        with pytest.raises(ValueError, match="keys do not match"):
            jcommon.build_params(jcfg)
        got = tcommon.build_params(tcfg)
        _assert_trees_equal(got["base"], jax.tree.map(
            lambda a: np.asarray(a, np.float32), p["base"]))
        _assert_trees_equal(got["lora"], fresh["lora"])
        return
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jcommon.build_params(jcfg)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tcommon.build_params(tcfg)
    dropped = case == "rank4-ckpt-into-rank0"
    assert any("dropping" in str(w.message) for w in jw) == dropped
    assert any("dropping" in str(w.message) for w in tw) == dropped
    assert all(t.dtype == torch.float32 for t in flatten_tree(got).values())
    _assert_trees_equal(got["base"], jax.tree.map(
        lambda a: np.asarray(a, np.float32), want["base"]))
    if case == "rank0-ckpt-into-rank4":
        # both keep their own fresh LoRA
        _assert_trees_equal(got["lora"], fresh["lora"])
        assert set(flatten_tree(got["lora"])) == set(
            flatten_tree(want["lora"]))
    else:
        assert (got["lora"] == {}) == (want["lora"] == {}) == dropped
        _assert_trees_equal(got["lora"], jax.tree.map(
            lambda a: np.asarray(a, np.float32), want["lora"]))


# ---------------------------------------------------------------------------
# -r for VIT_B16 and (i) cli/export_torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 4], ids=["no-lora-keys", "lora-keys"])
def test_vit_b16_resume_keeps_the_checkpoint_head(tmp_path, rank):
    """A torchvision checkpoint's 20-way head is kept as it is (the run has
    6 classes), as the JAX function does; every other shape is checked."""
    sd = _torchvision_sd({**B16, "num_class": 20}, rank=rank, seed=1)
    path = tmp_path / "tv.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    model = {**B16, "num_class": 6}

    def cfg(C):
        return C.RunConfig(net="VIT_B16", model=C.ViTConfig(**model),
                           lora=C.LoraConfig(4), resume=str(path))

    want = jcommon.build_params(cfg(jc))
    got = tcommon.build_params(cfg(tc))
    assert got["base"]["head"]["weight"].shape == (20, 32)
    _assert_trees_equal(got["base"], jax.tree.map(np.asarray, want["base"]))
    if rank:
        _assert_trees_equal(got["lora"], jax.tree.map(np.asarray,
                                                      want["lora"]))
    else:  # the fresh LoRA of the run
        seed = tc.RunConfig().data.seed
        fresh = init_vit_params(torch.Generator().manual_seed(seed),
                                tc.ViTConfig(**model), tc.LoraConfig(4))
        _assert_trees_equal(got["lora"], fresh["lora"])
    bad = dict(sd)
    bad["conv_proj.bias"] = np.zeros(31, np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in bad.items()}, path)
    with pytest.raises(ValueError, match="shapes differ"):
        tcommon.build_params(cfg(tc))


def test_export_torch_vit_b16_matches_jax(tmp_path, monkeypatch):
    """export_torch -n VIT_B16 writes torchvision naming, unmerged and
    merged, as JAX's export_state_dict(naming="torchvision"); the file
    resumes into the JAX package's VIT_B16 -r."""
    p = _jax_params(B16, seed=4)
    own = tmp_path / "trained.pth"
    save_params(str(own), params_from_jax(p))
    def patched(args, orig=tc.config_from_args):
        cfg = orig(args)
        cfg.model = tc.ViTConfig(**B16)
        return cfg

    monkeypatch.setattr(texport, "config_from_args", patched)
    out = tmp_path / "x.pth"
    written = texport.main(["-n", "VIT_B16", "--lora_rank", "4", "-r",
                            str(own), "--export_out", str(out),
                            "--export_form", "both"])
    assert [w["naming"] for w in written] == ["torchvision"] * 2
    jm = jc.ViTConfig(**B16)
    for w in written:
        got = torch.load(w["path"])
        want = jexport.export_state_dict(jax.tree.map(jnp.asarray, p), jm,
                                         jc.LoraConfig(4), w["form"],
                                         naming="torchvision")
        assert set(got) == set(want)
        for k, v in want.items():
            tol = 1e-6 if w["form"] == "merged" else 0.0
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=tol, atol=tol, err_msg=k)
    # the unmerged file resumes into the JAX package's ImageNet path
    back = jcommon.build_params(jc.RunConfig(
        net="VIT_B16", model=jm, lora=jc.LoraConfig(4), resume=str(out)))
    _assert_trees_equal(params_from_jax(jax.tree.map(np.asarray, back)), p)
