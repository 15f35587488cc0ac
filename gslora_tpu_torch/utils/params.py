"""Parameter accounting (port of gslora_tpu/utils/params.py; reference
util/utils.py:423-426 count_trainable_parameters)."""
from __future__ import annotations


def count_params(tree) -> int:
    """Elements in a nested dict of tensors."""
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


def param_summary(params) -> dict:
    """{'base': N, 'lora': M, 'total': N + M, 'trainable_fraction': M/total}
    for the standard {base, lora} split."""
    base = count_params(params.get("base", {}))
    lora = count_params(params.get("lora", {}))
    total = base + lora
    return {"base": base, "lora": lora, "total": total,
            "trainable_fraction": lora / total if total else 0.0}
