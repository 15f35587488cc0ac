"""tools/base_split at the integration tools' tiny model on the CPU: the
report of the torch-seed-0 arms (the recipe's bf16 and the plain
attention "dpa") after 1 pretrain epoch and one forget run of 1 epoch,
and the jax0 arm's init read from a JAX ``.msgpack``.

On the CPU both attentions run K1's plain version, so the launch
counters stay at 0; the test counts what the card would launch by
counting the model's calls into the fused attention that do not ask for
the plain version (``plain=False``) as K1 forward launches of the
query's dtype."""
import json
import math

import numpy as np
import pytest
import torch

from gslora_tpu_torch.models import vit as V
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.ops import attention as A
from gslora_tpu_torch.tools import base_split, flagship

from torch_baselines_setup import np_tree, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

BASE_KEYS = {"arm", "init", "compute_dtype", "remat", "attn_impl",
             "pretrain_epochs", "pretrain_test_acc", "forget_classes_acc",
             "final_loss", "final_acc", "norms", "pretrain_wall_s",
             "k1_launches", "runs", "summary"}
RUN_KEYS = {"seed", "compute_dtype", "attn_impl", "forget_acc_before",
            "forget_acc_after", "remain_acc_after", "best_H_mean",
            "wallclock_s", "k1_launches"}


@pytest.fixture
def k1_calls(monkeypatch):
    """The model's fused-attention calls that would launch K1 on the
    card, counted into ops/attention's forward counters by dtype."""
    fused = V.fused_attention_bhnd

    def counted(q, k, v, scale, plain=False):
        if not plain:
            A.FWD_BY_DTYPE[q.dtype] += 1
        return fused(q, k, v, scale, plain=plain)

    monkeypatch.setattr(V, "fused_attention_bhnd", counted)


def test_tiny_split_report(k1_calls, tmp_path):
    out = tmp_path / "split.json"
    arms = ["torch0_bf16", "torch0_bf16_dpa"]
    report = base_split.main(["--tiny", "--device", "cpu", "--seeds", "1",
                              "--pretrain_epochs", "1", "--epochs", "1",
                              "--arms", ",".join(arms), "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert report["card"] == report["device"] == "cpu"
    assert (report["pretrain_epochs"], report["epochs"],
            report["seeds"]) == (1, 1, 1)
    assert list(report["bases"]) == arms
    depth = flagship.model_config(True, tiny=True).depth
    for name, base in report["bases"].items():
        assert set(base) == BASE_KEYS, name
        assert base["init"] == "torch0" and base["remat"]
        assert base["compute_dtype"] == "bfloat16"
        for key in ("pretrain_test_acc", "forget_classes_acc"):
            assert 0.0 <= base[key] <= 100.0, (name, key)
        assert math.isfinite(base["final_loss"])
        norms = base["norms"]
        assert len(norms["qkv"]) == len(norms["fc2"]) == depth
        assert all(math.isfinite(v) and v > 0 for v in
                   [norms[k] for k in ("patch", "pos_embed", "cls_token",
                                       "head")] + norms["fc1"])
        (run,) = base["runs"]
        assert set(run) == RUN_KEYS
        assert (run["compute_dtype"], run["attn_impl"]) == ("bfloat16",
                                                            "auto")
        for key in ("forget_acc_before", "forget_acc_after",
                    "remain_acc_after", "best_H_mean"):
            assert 0.0 <= run[key] <= 100.0, (name, key)
        assert run["forget_acc_before"] == base["forget_classes_acc"]
        # the forget recipe runs K1 in bf16 from every base
        assert run["k1_launches"]["bfloat16"][0] > 0
        assert run["k1_launches"]["float32"] == [0, 0]
        assert base["summary"]["remain_acc_after"]["mean"] == \
            run["remain_acc_after"]
    # 10 steps of remat: two forwards of each block a step
    assert report["bases"]["torch0_bf16"]["k1_launches"] == {
        "bfloat16": [2 * depth * 10, 0], "float32": [0, 0]}
    assert report["bases"]["torch0_bf16_dpa"]["k1_launches"] == {
        "bfloat16": [0, 0], "float32": [0, 0]}
    # the same init, batches and dropout draws, and on the CPU one plain
    # attention under both names: the same base
    assert report["bases"]["torch0_bf16"]["norms"] == \
        report["bases"]["torch0_bf16_dpa"]["norms"]


def test_jax_init_arm_reads_the_jax_tree(tmp_path):
    """The jax0 arm starts from the JAX package's seed-0 init as
    save_pytree wrote it, leaf for leaf; without the file, or with another
    model's tree, it refuses before any pretrain."""
    import jax
    import jax.numpy as jnp
    from gslora_tpu.checkpoints.io import save_pytree

    model = flagship.model_config(True, tiny=True)
    fields = ("image_size", "patch_size", "dim", "depth", "heads",
              "dim_head", "mlp_dim", "num_class", "dropout", "emb_dropout",
              "head_type")
    tree = np_tree(0, rank=8, model={f: getattr(model, f) for f in fields})
    path = str(tmp_path / "init.msgpack")
    save_pytree(path, jax.tree.map(jnp.asarray, tree))
    got = flatten_tree(base_split.init_tree("jax0", model, path))
    want = flatten_tree(tree)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    train, test = flagship.stand_in(model, 2.4)
    with pytest.raises(ValueError, match="--jax_init"):
        base_split.run_split(model, train, test, arms=["torch0_bf16",
                                                       "jax0_bf16"],
                             seeds=1, pretrain_epochs=1, epochs=1,
                             device="cpu", out=str(tmp_path / "x.json"))
    other = {**{f: getattr(model, f) for f in fields}, "dim": 32}
    save_pytree(path, jax.tree.map(jnp.asarray,
                                   np_tree(0, rank=8, model=other)))
    with pytest.raises(ValueError, match="does not hold the model's tree"):
        base_split.init_tree("jax0", model, path)
    with pytest.raises(ValueError, match=r"with \{seed\} in the path"):
        base_split.run_split(model, train, test, arms=["jax1_bf16"],
                             seeds=1, pretrain_epochs=1, epochs=1,
                             device="cpu", jax_init=path)
    with pytest.raises(ValueError, match="unknown arm"):
        base_split.run_split(model, train, test, arms=["torch0_fp16"],
                             seeds=1, pretrain_epochs=1, epochs=1,
                             device="cpu")
    assert base_split.arm("jax3_fp32_noremat") == ("jax3", "float32",
                                                   False, "auto")
    assert base_split.jax_init_path("a/init_{seed}.msgpack", 2) == \
        "a/init_2.msgpack"
