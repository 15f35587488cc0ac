"""The port's shell-script mirrors (gslora_tpu_torch/scripts/*.sh), each
run for real in a subprocess on a generated 100-class JPEG folder, as
tests/test_scripts.py runs the JAX package's: the same decode, split and
CLI path a user runs, shrunk through the ``GSLORA_EXTRA_ARGS`` hook
(argparse takes the last occurrence) to depth 1, one epoch, small batches
and the CPU. A typo in a mirror (a path, a renamed flag, a recipe that
drifted from the CLI) fails here."""
import glob
import json
import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "gslora_tpu_torch", "scripts")

# ViT-P8S8 at depth 1 on the CPU, one epoch; the smoke is about the .sh
# surface, not accuracy
TINY = "--vit_depth 1 -e 1 --device cpu"


def _make_face_folder(root, n_cls=100, n_train=1, n_test=1, size=112):
    """100-class JPEG folder (train/test) at the native 112x112."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for split, n in (("train", n_train), ("test", n_test)):
        for c in range(n_cls):
            d = os.path.join(root, split, f"id_{c:03d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                arr = rng.randint(0, 255, (size, size, 3), np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"),
                                          quality=90)
    return root


def _run_script(name, args, extra, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["GSLORA_EXTRA_ARGS"] = extra
    env["OMP_NUM_THREADS"] = "2"  # the suite runs several workers
    proc = subprocess.run(["bash", os.path.join(SCRIPTS, name)] + args,
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"{name} rc={proc.returncode}\nstdout tail:\n"
            f"{proc.stdout[-3000:]}\nstderr tail:\n{proc.stderr[-3000:]}")
    return proc


def test_mirrors_call_the_port():
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(SCRIPTS, "*.sh")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "scripts", "*.sh")))
    for name in names:
        text = open(os.path.join(SCRIPTS, name)).read()
        assert "python -m gslora_tpu_torch.cli." in text, name
        assert "$GSLORA_EXTRA_ARGS" in text, name


@pytest.fixture(scope="module")
def face_root(tmp_path_factory):
    return _make_face_folder(str(tmp_path_factory.mktemp("faces")))


@pytest.fixture(scope="module")
def pretrained(face_root, tmp_path_factory):
    """run_pretrain.sh end to end (tiny) -> the best-accuracy checkpoint
    (.pth) every later script resumes from."""
    out = str(tmp_path_factory.mktemp("pre"))
    # b 4 -> 25 batches: the best-accuracy save fires every 20 batches
    _run_script("run_pretrain.sh", [], (
        f"{TINY} -b 4 --lr 3e-3 --warmup-epochs 0 --data_root {face_root} "
        f"--outdir {out}"))
    ckpts = sorted(glob.glob(os.path.join(out, "*.pth")))
    assert ckpts, f"run_pretrain.sh saved no checkpoint in {out}"
    return ckpts[-1], out


def test_run_pretrain_sh(pretrained):
    _, out = pretrained
    assert os.path.exists(os.path.join(out, "config.txt"))
    assert json.load(open(os.path.join(out, "report.json")))


def test_test_sh(pretrained, face_root, tmp_path):
    ckpt, _ = pretrained
    # test.sh takes the outdir as $2; its --lora_rank 8 also runs the
    # resume of a checkpoint without LoRA (a fresh B = 0 adds nothing)
    _run_script("test.sh", [ckpt, str(tmp_path)],
                f"{TINY} -b 50 --data_root {face_root}")
    assert (tmp_path / "class_accuracy.txt").exists()
    assert json.load(open(tmp_path / "report.json"))["num_samples"] == 100


def test_run_forget_sh(pretrained, face_root, tmp_path):
    ckpt, _ = pretrained
    _run_script("run_forget.sh", [ckpt], (
        f"{TINY} -b 16 --few_shot_num 1 --aug_num 0 --data_root "
        f"{face_root} --outdir {tmp_path}"))
    rep = json.load(open(tmp_path / "report.json"))
    assert "best_H_mean" in rep


@pytest.mark.parametrize("method", ["gs_lora", "full"])
def test_run_forget_open_sh(pretrained, face_root, tmp_path, method):
    ckpt, _ = pretrained
    _run_script("run_forget_open.sh", [ckpt, method], (
        f"{TINY} -b 16 --data_root {face_root} --outdir {tmp_path}"))
    rep = json.load(open(tmp_path / "report.json"))
    assert rep["open_acc"] is not None


def test_run_cl_forget_sh(pretrained, face_root, tmp_path):
    ckpt, _ = pretrained
    _run_script("run_cl_forget.sh", [ckpt], (
        f"{TINY} -b 16 --few_shot_num 1 --num_tasks 1 --aug_num 0 "
        f"--data_root {face_root} --outdir {tmp_path}"))
    rep = json.load(open(tmp_path / "report.json"))
    assert len(rep) == 1 and "best_H_mean" in rep[0]


def test_run_cl_forget_open_sh(pretrained, face_root, tmp_path):
    ckpt, _ = pretrained
    _run_script("run_cl_forget_open.sh", [ckpt], (
        f"{TINY} -b 16 --num_tasks 1 --data_root {face_root} "
        f"--outdir {tmp_path}"))
    rep = json.load(open(tmp_path / "report.json"))
    assert rep[0]["open_acc"] is not None


def test_run_cl_forget_image_sh(pretrained, face_root, tmp_path):
    """The ImageNet recipe's flags, retargeted through GSLORA_EXTRA_ARGS at
    the face model (ViT-B/16 itself is too heavy for a CPU smoke; its
    parity is tests/test_torch_vit_imagenet.py's): every flag the script
    writes still parses and a real first step runs."""
    ckpt, _ = pretrained
    _run_script("run_cl_forget_image.sh", [ckpt, ""], (
        f"{TINY} -b 16 -n VIT -d casia100 --head CosFace --num_tasks 1 "
        f"--lora_rank 4 -r {ckpt} --data_root {face_root} "
        f"--outdir {tmp_path}"))
    rep = json.load(open(tmp_path / "report.json"))
    assert len(rep) == 1
