"""tools/attention_split on the CPU at the integration tools' tiny model:
the four runs (K1's impl "auto" and the plain "dpa", in bf16 and fp32) from
one base, written to the report with their summary. On the CPU both impls
run the plain attention, so each pair agrees exactly and no kernel
launches; on the card the tool itself checks which kernel ran."""
import json

import pytest
import torch

from gslora_tpu_torch.models.vit import init_vit_params
from gslora_tpu_torch.tools import attention_split as S
from gslora_tpu_torch.tools import flagship

from torch_baselines_setup import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def test_split_runs_each_impl_and_dtype_from_one_base(tmp_path):
    model = flagship.model_config(True, tiny=True)
    train, test = flagship.stand_in(model, flagship.noise(True))
    params = init_vit_params(torch.Generator().manual_seed(0), model,
                             flagship.LORA)
    before = {k: v.clone() for k, v in params["base"]["head"].items()}
    out = tmp_path / "split.json"
    report = S.run_split(params, train, test, model, seeds=1, epochs=1,
                         device="cpu", out=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    runs = {(r["compute_dtype"], r["attn_impl"]): r for r in report["runs"]}
    assert set(runs) == {(d, i) for d in S.DTYPES for i in S.IMPLS}
    assert set(report["base_test_acc"]) == set(S.DTYPES)
    for dtype in S.DTYPES:
        auto, dpa = runs[dtype, "auto"], runs[dtype, "dpa"]
        for key in ("forget_acc_before", *S.METRICS):
            assert auto[key] == dpa[key], (dtype, key)
            assert 0.0 <= auto[key] <= 100.0
        assert report["summary"][f"{dtype}/auto"]["remain_acc_after"][
            "mean"] == auto["remain_acc_after"]
    assert all(v == [0, 0] for r in report["runs"]
               for v in r["k1_launches"].values())
    # every run starts from the same base: the tool never trains it in
    # place
    for k, v in params["base"]["head"].items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
