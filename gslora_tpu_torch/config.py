"""Configuration dataclasses + CLI flag surface.

The port's own copy of ``gslora_tpu/config.py``, plus ``--device``
(``RunConfig.device``). Options that name TPU/XLA mechanisms keep their
names so recipes carry over; the port maps them as models/vit.py says.

Mirrors the reference two-stage config (argparse in ``util/args.py:4-380`` →
cfg dict in ``config.py:6-116``) as typed dataclasses with the same defaults,
so every reference shell recipe (``scripts/run_forget.sh`` etc.) maps 1:1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


# torchvision ImageNet normalization constants (reference
# image_iter.py:147-149). SINGLE SOURCE for the host transform
# (data/folders.py), the device-side uint8 dequant-normalize
# (models/vit.py input_norm) and prototype augmentation
# (engine/prototypes.py) — the uint8-transfer exact-parity contract
# requires every site to use identical fp32 constants.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# model / lora
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViTConfig:
    """Architecture of the face transformer (reference vit_face.py:449-548).

    Defaults are the ViT-P8S8 used in all forgetting experiments
    (train_own_forget.py:553-567: dim 512, depth 6, heads 8, mlp 2048).
    """

    image_size: int = 112
    patch_size: int = 8
    dim: int = 512
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    mlp_dim: int = 2048
    channels: int = 3
    num_class: int = 100
    pool: str = "cls"  # "cls" | "mean"
    dropout: float = 0.1
    emb_dropout: float = 0.1
    head_type: str = "CosFace"  # Softmax | ArcFace | CosFace | SFace | None
    # soft-split (ViTs_face, vits_face.py:446-450): overlapping patches via
    # unfold with ac_patch kernel / patch_size stride / pad padding.
    soft_split: bool = False
    ac_patch_size: int = 12
    pad: int = 4
    # vit_face omits qkv bias and scales by dim**-0.5 (vit_face.py:346
    # quirk); torchvision ViT-B/16 has qkv bias and standard head-dim scale.
    qkv_bias: bool = False
    attn_scale: str = "dim"  # "dim" | "dim_head"
    attn_impl: str = "auto"  # auto | pallas: the fused attention kernel
    # (CUDA kernel on the card, its plain version on the CPU) | dpa: that
    # plain version on any device | xla | bnhd: eager einsums with bf16
    # scores, as the JAX model's einsum path
    # rematerialize block activations in backward: each block's forward
    # runs again in the backward (torch.utils.checkpoint per block,
    # models/vit.transformer_stack)
    remat: bool = False
    # block-scan unroll factor of the JAX package; the port runs its
    # blocks as a Python loop and ignores it (kept so recipes carry over)
    scan_unroll: int = 0
    # projection-GEMM implementation: "default" = compute-dtype matmul,
    # "int8" = W8A8 dynamic quantization (ops/quant.py; eval and serving
    # only: a training forward raises)
    gemm_impl: str = "default"
    # dropout mask generation: "uniform" = keep with probability 1-rate,
    # scale by 1/keep. The "bits*" variants are TPU RNG workarounds of the
    # JAX package; the port maps them to the same uniform dropout
    dropout_impl: str = "uniform"
    # numerics knobs (defaults preserve torch parity):
    # block LayerNorms in fp32 (torch nn.LayerNorm parity) or "bf16"
    ln_dtype: str = "fp32"
    # FFN GELU: "erf" = fp32 erf (torch default parity), "erf_bf16" =
    # erf in compute dtype, "tanh" = tanh approximation (parity-diverging)
    gelu_impl: str = "erf"
    # device-side input normalization applied ONLY to uint8 inputs
    # (uint8_transfer path): "none" = ToTensor only (/255 — the face
    # path), "imagenet" = /255 then the torchvision ImageNet mean/std
    # (image_iter.py:147-149). fp32 inputs are assumed pre-normalized on
    # host and pass through untouched.
    input_norm: str = "none"

    @classmethod
    def vit_b16(cls, num_class: int = 100, **overrides) -> "ViTConfig":
        """torchvision vit_b_16 parity configuration (modified_VIT.py:5-39):
        conv patchify (kernel=stride=16, pad=0 — expressed as soft_split,
        which yields the conv's channel-major feature layout), qkv bias ON,
        standard head-dim attention scale, no dropout, plain Linear head.

        ``input_norm`` defaults to "imagenet" (the torchvision recipe) but
        is overridable: a VIT_B16 run on a ToTensor-only pipeline (face
        data) must pass input_norm="none" so the uint8-transfer device
        dequant matches what the host fp32 path actually applies."""
        overrides.setdefault("input_norm", "imagenet")
        return cls(
            image_size=224, patch_size=16, dim=768, depth=12, heads=12,
            dim_head=64, mlp_dim=3072, num_class=num_class,
            head_type="Softmax", dropout=0.0, emb_dropout=0.0,
            soft_split=True, ac_patch_size=16, pad=0,
            qkv_bias=True, attn_scale="dim_head", **overrides)

    @property
    def num_patches(self) -> int:
        if self.soft_split:
            out = (self.image_size + 2 * self.pad - self.ac_patch_size) // self.patch_size + 1
            return out * out
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        if self.soft_split:
            return self.channels * self.ac_patch_size**2
        return self.channels * self.patch_size**2

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS


@dataclass(frozen=True)
class LoraConfig:
    """LoRA placement + hyperparameters (loralib semantics: forward adds
    ``x @ A^T @ B^T * (alpha/r)``; A kaiming-uniform(a=sqrt(5)), B zeros)."""

    rank: int = 8
    alpha: float = 1.0  # loralib lora.Linear default lora_alpha=1
    pos: str = "FFN"  # "FFN" | "Attention"  (vit_face.py Transformer lora_pos)

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank if self.rank > 0 else 0.0


# ---------------------------------------------------------------------------
# optimization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimConfig:
    """timm-style optimizer/scheduler surface (util/args.py:30-150)."""

    opt: str = "adamw"
    lr: float = 5e-4
    weight_decay: float = 0.05
    opt_eps: float = 1e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    momentum: float = 0.9
    sched: str = "cosine"
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    warmup_epochs: int = 3
    epochs: int = 125
    decay_epochs: int = 30
    decay_rate: float = 0.1
    cooldown_epochs: int = 10
    # gslora_tpu addition (no reference analogue — its nn.DataParallel
    # path fits the full batch on 8 GPUs): >1 splits each batch into that
    # many microbatches inside one train step, one optimizer
    # update per batch, activation memory divided by the factor
    grad_accum: int = 1


# ---------------------------------------------------------------------------
# forgetting
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ForgetConfig:
    """GS-LoRA(++) loss recipe (engine.py:13-433; util/args.py:190-380)."""

    num_of_first_cls: int = 90
    per_forget_cls: int = 10
    bnd: float = 10.0  # --BND bounded forget loss: relu(BND - CE)
    beta: float = 0.03  # forget loss weight
    alpha: float = 0.1  # structure (group-Lasso) loss weight
    group_type: str = "block"  # block | lora | matrix (engine.py:532-687)
    group_pos: str = "FFN"  # FFN | Attention
    # alpha warmup (train_own_forget.py:723-727)
    warmup_alpha: bool = False
    big_alpha: float = 1e-4
    alpha_epoch: int = 20  # structure loss gated by epoch >= ALPHA_EPOCH
    # beta decay (train_own_forget.py:728-732)
    beta_decay: bool = False
    small_beta: float = 1e-4
    # prototype regularizer (GS-LoRA++, engine.py:690-722)
    prototype: bool = False
    pro_f_weight: float = 0.0
    pro_r_weight: float = 0.0
    bnd_pro: float = 18.0  # single-step engine hinge uses 18 (engine.py:104);
    # the CL engine reads cfg BND_pro (engine_cl.py:99)
    prototype_distance: str = "kl"  # kl | l2
    aug_num: int = 0  # RandAugment magnitude for prototype replication
    # EMA (train_own_forget.py:783-826)
    average_weight: bool = False
    ema_decay: float = 0.99  # args default; recipes pass 0.9
    ema_epoch: int = 50
    # continual
    num_tasks: int = 1
    cl_beta_list: Tuple[float, ...] = ()
    cl_prof_list: Tuple[float, ...] = ()  # per-task prototype forget weights
    # data subsetting
    few_shot: bool = False
    few_shot_num: int = 4
    data_ratio: float = 0.1
    # open-set
    open_cls_num: int = 0


@dataclass(frozen=True)
class BaselineConfig:
    """Baseline method switches + hyperparameters (util/args.py:200-300)."""

    method: str = "gs_lora"  # gs_lora | retrain | l2 | ewc | mas | lwf | der |
    # der_plus | fdr | scrub | lirf | replay
    l2_lambda: float = 0.1
    ewc_lambda: float = 0.1
    mas_lambda: float = 0.1
    replay: bool = False
    n_fisher_sample: Optional[int] = None
    # LwF
    lwf_T: float = 2.0
    lwf_lambda_kd: float = 0.5
    lwf_lambda_remain: float = 1.0
    # reproduce the reference's self-zeroing KD term (Lwftrain.py:16-24)
    lwf_faithful_zero_kd: bool = False
    # DER
    der_lambda: float = 0.1
    der_plus: bool = False
    der_plus_lambda: float = 0.1
    # FDR
    fdr_lambda: float = 0.1
    # SCRUB
    sgda_smoothing: float = 0.0
    sgda_gamma: float = 0.99
    sgda_alpha: float = 0.001
    sgda_learning_rate: float = 1e-4
    sgda_momentum: float = 0.9
    sgda_weight_decay: float = 5e-4
    scrub_superepoch: int = 10
    kd_T: float = 2.0
    scrub_decay_epoch: int = 100
    sgda_optim: str = "sgd"
    # LIRF
    lirf_T: float = 10.0
    lirf_alpha: float = 0.1
    # reference baseline param freezing (baselines/freeze.py): the margin
    # head ("loss" module) is FROZEN in every CL-baseline branch unless
    # --ffn_open (train_own_forget_cl.py:426; default False), and
    # --only_ffn inverts the default to train ONLY the FFN Linears + head
    # (cl.py:432-439). imagenet100 freezes the class head unconditionally.
    ffn_open: bool = False
    only_ffn: bool = False


# ---------------------------------------------------------------------------
# data / run
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    data_mode: str = "casia100"  # casia100 | imagenet100 | synthetic
    data_root: str = "./data/faces_webface_112x112_sub100_train_test"
    batch_size: int = 256
    test_batch_scale: int = 5  # test loaders use 5x batch (train_own_forget_cl.py:710)
    workers: int = 4
    # ship batches as uint8 and dequantize inside the model (4x less
    # host->device traffic, bit-identical forward — BatchLoader docstring).
    # Supported for ToTensor-only pipelines (face path: device does /255)
    # AND ImageNet pipelines (datasets switch to raw_uint8 decode; the
    # mean/std normalization moves on-device via ViTConfig.input_norm).
    uint8_transfer: bool = False
    seed: int = 1337


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout of the JAX package (data / model axes, tp, fsdp,
    pp, sp, multi-slice; gslora_tpu/config.py describes each). The port
    runs the whole ``(dcn, data, model)`` mesh (``--dp``: torch.distributed
    ranks, one per card, parallel/mesh) with a model axis, tp, fsdp, sp
    and pp (parallel/sharding, parallel/pipeline), and a mesh smaller
    than the world, whose other ranks sit idle."""

    data: int = -1  # -1 => all devices (after model/slices)
    model: int = 1
    tp: bool = False  # shard FFN hidden dim over the model axis
    fsdp: bool = False  # shard block kernels (+moments) over the data axis
    pp: bool = False  # GPipe stages over the model axis
    pp_micro: int = 0  # microbatches per batch (0 => stage count)
    sp: bool = False  # shard activation token dim over the model axis
    slices: int = 1  # >1 => outermost dcn data-parallel axis (multi-slice)


@dataclass
class RunConfig:
    """Top-level config bundle (the analogue of reference cfg dict)."""

    net: str = "VIT"  # VIT | VITs | VIT_B16
    model: ViTConfig = field(default_factory=ViTConfig)
    lora: LoraConfig = field(default_factory=LoraConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    forget: ForgetConfig = field(default_factory=ForgetConfig)
    baseline: BaselineConfig = field(default_factory=BaselineConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    resume: str = ""
    outdir: str = "./results/out"
    embedding_size: int = 512
    compute_dtype: str = "bfloat16"  # matmul/activation dtype
    param_dtype: str = "float32"
    lora_apply: str = "factored"  # "factored" | "merged" (fold B@A per step)
    structure_mode: str = "loss"  # "loss" (reference) | "prox" (kernel K2)
    fused_batch: bool = False  # one forward over [forget; remain]
    disp_freq: int = 5  # engine.py DISP_FREQ
    ver_freq: int = 100  # engine.py VER_FREQ (eval every N batches)
    num_epoch: int = 100
    log_wandb: bool = False
    device: str = "cuda"  # "cuda" | "cpu"; no silent fallback

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """Argparse surface mirroring the reference flags (util/args.py)."""
    p = argparse.ArgumentParser(description="gslora_tpu_torch")
    p.add_argument("-w", "--workers_id", default="tpu", type=str)
    p.add_argument("-e", "--epochs", default=125, type=int)
    p.add_argument("-b", "--batch_size", default=256, type=int)
    p.add_argument("-d", "--data_mode", default="casia100", type=str)
    p.add_argument("--data_root", default="", type=str)
    p.add_argument("-n", "--net", default="VIT", type=str,
                   choices=["VIT", "VITs", "VIT_B16"])
    p.add_argument("--head", default="CosFace", type=str,
                   choices=["Softmax", "ArcFace", "CosFace", "SFace", "None"])
    p.add_argument("-r", "--resume", default="", type=str)
    p.add_argument("--outdir", default="./results/out", type=str)
    # optimizer / sched
    p.add_argument("--opt", default="adamw", type=str)
    p.add_argument("--opt-eps", default=1e-8, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", default=0.05, type=float)
    p.add_argument("--sched", default="cosine", type=str)
    p.add_argument("--lr", default=5e-4, type=float)
    p.add_argument("--warmup-lr", default=1e-6, type=float)
    p.add_argument("--min-lr", default=1e-5, type=float)
    p.add_argument("--warmup-epochs", default=3, type=int)
    p.add_argument("--decay-epochs", default=30, type=int)
    p.add_argument("--decay-rate", default=0.1, type=float)
    # model
    p.add_argument("--vit_depth", default=6, type=int)
    p.add_argument("--lora_rank", default=8, type=int)
    p.add_argument("--lora_pos", default="FFN", type=str)
    # forgetting
    p.add_argument("--num_of_first_cls", default=90, type=int)
    p.add_argument("--per_forget_cls", default=10, type=int)
    p.add_argument("--BND", default=10.0, type=float)
    p.add_argument("--beta", default=0.03, type=float)
    p.add_argument("--alpha", default=0.1, type=float)
    p.add_argument("--min_alpha", default=0.0, type=float)
    p.add_argument("--group_type", default="block", type=str)
    p.add_argument("--warmup_alpha", action="store_true")
    p.add_argument("--big_alpha", default=1e-4, type=float)
    p.add_argument("--alpha_epoch", default=20, type=int)
    p.add_argument("--beta_decay", action="store_true")
    p.add_argument("--small_beta", default=1e-4, type=float)
    # prototype
    p.add_argument("--prototype", action="store_true")
    p.add_argument("--pro_f_weight", default=0.0, type=float)
    p.add_argument("--pro_r_weight", default=0.0, type=float)
    p.add_argument("--BND_pro", default=18.0, type=float)
    p.add_argument("--aug_num", default=0, type=int)
    # EMA
    p.add_argument("--average_weight", action="store_true")
    p.add_argument("--ema_decay", default=0.99, type=float)
    p.add_argument("--ema_epoch", default=50, type=int)
    # continual
    p.add_argument("--num_tasks", default=1, type=int)
    p.add_argument("--cl_beta_list", nargs="*", default=[], type=float)
    p.add_argument("--cl_prof_list", nargs="*", default=[], type=float)
    # few shot / subsets
    p.add_argument("--few_shot", action="store_true")
    p.add_argument("--few_shot_num", default=4, type=int)
    p.add_argument("--data_ratio", default=0.1, type=float)
    # open set
    p.add_argument("--open_cls_num", default=0, type=int)
    # baselines
    p.add_argument("--one_stage", action="store_true")  # GS-LoRA
    # --si exists in the reference flag surface (util/args.py:219) but is
    # never dispatched by any entry point there — accepted here for CLI parity,
    # equally undispatched (PARITY.md "flag-only")
    p.add_argument("--si", action="store_true")
    p.add_argument("--retrain", action="store_true")
    p.add_argument("--l2", action="store_true")
    p.add_argument("--l2_lambda", default=0.1, type=float)
    p.add_argument("--ewc", action="store_true")
    p.add_argument("--ewc_lambda", default=0.1, type=float)
    p.add_argument("--MAS", action="store_true")
    p.add_argument("--mas_lambda", default=0.1, type=float)
    p.add_argument("--replay", action="store_true")
    p.add_argument("--Lwf", action="store_true")
    p.add_argument("--Lwf_T", default=2.0, type=float)
    p.add_argument("--Lwf_lambda_kd", default=0.5, type=float)
    p.add_argument("--Lwf_lambda_remain", default=1.0, type=float)
    # gslora_tpu addition: the reference's LwF KD term self-zeroes (double
    # log bug, Lwftrain.py:16-24). Default here is the intended loss; this
    # flag reproduces the reference's no-op term bit-faithfully.
    p.add_argument("--lwf_faithful_zero_kd", action="store_true")
    p.add_argument("--Der", action="store_true")
    p.add_argument("--DER_lambda", default=0.1, type=float)
    p.add_argument("--DER_plus", action="store_true")
    p.add_argument("--DER_plus_lambda", default=0.1, type=float)
    p.add_argument("--FDR", action="store_true")
    p.add_argument("--FDR_lambda", default=0.1, type=float)
    p.add_argument("--SCRUB", action="store_true")
    p.add_argument("--sgda_smoothing", default=0.0, type=float)
    p.add_argument("--sgda_gamma", default=0.99, type=float)
    p.add_argument("--sgda_alpha", default=0.001, type=float)
    p.add_argument("--sgda_learning_rate", default=1e-4, type=float)
    p.add_argument("--sgda_momentum", default=0.9, type=float)
    p.add_argument("--sgda_weight_decay", default=5e-4, type=float)
    p.add_argument("--SCRUB_superepoch", default=10, type=int)
    p.add_argument("--kd_T", default=2.0, type=float)
    p.add_argument("--scrub_decay_epoch", default=100, type=int)
    p.add_argument("--LIRF", action="store_true")
    p.add_argument("--LIRF_T", default=10.0, type=float)
    p.add_argument("--LIRF_alpha", default=0.1, type=float)
    p.add_argument("--ffn_open", action="store_true",
                   help="train the margin head in baseline runs (the "
                        "reference freezes it by default, cl.py:426)")
    p.add_argument("--only_ffn", action="store_true",
                   help="baseline runs train ONLY the FFN Linears + head "
                        "(reference cl.py:432-439)")
    # misc
    p.add_argument("--seed", default=1337, type=int)
    p.add_argument("--compute_dtype", default="bfloat16", type=str)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--mesh_data", default=-1, type=int)
    p.add_argument("--mesh_model", default=1, type=int)
    p.add_argument("--tp", action="store_true",
                   help="tensor parallelism: shard FFN hidden dims (and the "
                        "head's class dim) over the model mesh axis")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-style: shard block kernels + optimizer "
                        "moments over the data mesh axis")
    p.add_argument("--pp", action="store_true",
                   help="GPipe pipeline parallelism: stage the stacked "
                        "layers over the model mesh axis")
    p.add_argument("--pp_micro", default=0, type=int,
                   help="pipeline microbatches per batch (0 = stage count)")
    p.add_argument("--sp", action="store_true",
                   help="sequence parallelism: shard the activation token "
                        "dim over the model mesh axis between matmul "
                        "regions (composes with --tp/--fsdp)")
    p.add_argument("--mesh_slices", default=1, type=int,
                   help="multi-slice pods: outermost dcn data-parallel "
                        "mesh axis (batch shards over dcn x data; only the "
                        "gradient all-reduce crosses DCN)")
    p.add_argument("--grad_accum", default=1, type=int,
                   help="gradient accumulation: split each batch into N "
                        "microbatches inside the step (one optimizer "
                        "update per batch; activation memory / N). Exact "
                        "everywhere: pretrain, the dual-batch forget/CL "
                        "step (two-phase gate scheme for the bounded/hinged "
                        "losses — engine/forget.py), and every baseline "
                        "family (reg/SCRUB/distill/LIRF)")
    # execution modes (gslora_tpu additions; defaults reference-faithful)
    p.add_argument("--lora_apply", default="factored", type=str,
                   choices=["factored", "merged"])
    p.add_argument("--structure_mode", default="loss", type=str,
                   choices=["loss", "prox"])
    p.add_argument("--fused_batch", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="execution preset: merged LoRA apply + fused "
                        "dual-batch forward — the bench.py configuration "
                        "(same math; merged-fold bf16 quantization caveat "
                        "in models/vit.py)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--uint8_transfer", action="store_true",
                   help="ship batches as uint8, dequantize in the model "
                        "step (4x less H2D; bit-identical forward). Face "
                        "pipelines dequantize k/255; ImageNet pipelines "
                        "decode raw uint8 and normalize on device")
    p.add_argument("--scan_unroll", default=0, type=int,
                   help="block-scan unroll of the JAX package; the port "
                        "loops over blocks in Python and ignores it")
    p.add_argument("--attn_impl", default="auto", type=str,
                   choices=["auto", "xla", "pallas", "dpa", "bnhd"])
    p.add_argument("--gemm_impl", default="default", type=str,
                   choices=["default", "int8"],
                   help="projection GEMMs: compute-dtype matmul, or W8A8 "
                        "dynamic int8 (eval and serving only)")
    p.add_argument("--dropout_impl", default="uniform", type=str,
                   choices=["uniform", "bits16", "bits32", "bits8"],
                   help="dropout mask generator; the port maps every "
                        "choice to the uniform dropout")
    p.add_argument("--ln_dtype", default="fp32", type=str,
                   choices=["fp32", "bf16"],
                   help="block LayerNorm stats dtype: fp32 = torch parity "
                        "(default) or bf16")
    p.add_argument("--gelu_impl", default="erf", type=str,
                   choices=["erf", "erf_bf16", "tanh"],
                   help="FFN GELU: erf = torch parity (default); erf_bf16 "
                        "and tanh diverge from torch-erf numerics")
    p.add_argument("--fast_math", action="store_true",
                   help="opt-in preset: ln_dtype=bf16 + gelu_impl=tanh "
                        "(diverges from torch-parity numerics at "
                        "bf16-roundoff scale)")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a profiler trace of the run here "
                        "(TensorBoard-viewable)")
    p.add_argument("--imagenet_miss_root", default="", type=str,
                   help="folder of held-out ImageNet class dirs for the "
                        "missing-class eval (reference "
                        "data/imagenet_val_split/nonexist)")
    p.add_argument("--device", default="cuda", type=str,
                   choices=["cuda", "cpu"],
                   help="where the run computes: cuda (default; raises "
                        "when no GPU is visible) or cpu")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over all devices (mesh)")
    p.add_argument("--ver_targets", default="", type=str,
                   help="comma-separated verification .bin pair sets under "
                        "data_root (util/utils.py:60-75 get_val_data names, "
                        "e.g. lfw,cfp_ff); evaluated by cli.test_model with "
                        "ROC artifacts")
    return p


_METHOD_FLAGS = [
    ("retrain", "retrain"), ("l2", "l2"), ("ewc", "ewc"), ("MAS", "mas"),
    ("Lwf", "lwf"), ("Der", "der"), ("FDR", "fdr"), ("SCRUB", "scrub"),
    ("LIRF", "lirf"),
]

_DATA_ROOTS = {
    # reference config.py:36-43 DATA_ROOT per data_mode
    "casia100": "./data/faces_webface_112x112_sub100_train_test",
    "imagenet100": "./data/imagenet100",
    "synthetic": "synthetic",
}


def config_from_args(args: argparse.Namespace) -> RunConfig:
    """args → RunConfig (the analogue of reference config.py:get_config)."""
    method = "gs_lora"
    for flag, name in _METHOD_FLAGS:
        if getattr(args, flag, False):
            method = name
    if getattr(args, "si", False):
        import warnings
        warnings.warn("--si is accepted for reference-CLI parity but, as in "
                      "the reference (util/args.py:219), no entry point "
                      "dispatches it — the flag is a no-op", stacklevel=2)
    if getattr(args, "replay", False) and method == "gs_lora":
        method = "replay"
    if getattr(args, "DER_plus", False):
        method = "der_plus"

    imagenet = args.data_mode == "imagenet100"
    fast = getattr(args, "fast_math", False)
    ln_dtype = "bf16" if fast else getattr(args, "ln_dtype", "fp32")
    gelu_impl = "tanh" if fast else getattr(args, "gelu_impl", "erf")
    if args.net == "VIT_B16":
        # full torchvision parity (qkv bias, head-dim scale, conv patchify,
        # no dropout) — the importer's weight layout depends on these
        model = ViTConfig.vit_b16(
            num_class=100, remat=args.remat,
            scan_unroll=getattr(args, "scan_unroll", 0),
            dropout_impl=getattr(args, "dropout_impl", "uniform"),
            gemm_impl=getattr(args, "gemm_impl", "default"),
            attn_impl=getattr(args, "attn_impl", "auto"),
            ln_dtype=ln_dtype, gelu_impl=gelu_impl,
            # device-side normalization must mirror what the host
            # transform applies: ImageNet data normalizes, the face
            # pipeline is ToTensor-only — otherwise --uint8_transfer on
            # VIT_B16+casia would shift inputs vs the fp32 path
            input_norm="imagenet" if imagenet else "none")
    else:
        model = ViTConfig(
            remat=args.remat,
            scan_unroll=getattr(args, "scan_unroll", 0),
            dropout_impl=getattr(args, "dropout_impl", "uniform"),
            gemm_impl=getattr(args, "gemm_impl", "default"),
            attn_impl=getattr(args, "attn_impl", "auto"),
            ln_dtype=ln_dtype, gelu_impl=gelu_impl,
            input_norm="imagenet" if imagenet else "none",
            image_size=224 if imagenet else 112,
            patch_size=16 if imagenet else 8,
            dim=512,
            depth=args.vit_depth,
            heads=8,
            dim_head=64,
            mlp_dim=2048,
            num_class=100,
            head_type=args.head,
            soft_split=(args.net == "VITs"),
        )
    cfg = RunConfig(
        net=args.net,
        model=model,
        lora=LoraConfig(rank=args.lora_rank, pos=args.lora_pos),
        optim=OptimConfig(
            opt=args.opt, lr=args.lr, weight_decay=args.weight_decay,
            opt_eps=args.opt_eps, momentum=args.momentum, sched=args.sched,
            warmup_lr=args.warmup_lr, min_lr=args.min_lr,
            warmup_epochs=args.warmup_epochs, epochs=args.epochs,
            decay_epochs=args.decay_epochs, decay_rate=args.decay_rate,
            grad_accum=getattr(args, "grad_accum", 1),
        ),
        forget=ForgetConfig(
            num_of_first_cls=args.num_of_first_cls,
            per_forget_cls=args.per_forget_cls,
            bnd=args.BND, beta=args.beta, alpha=args.alpha,
            group_type=args.group_type, group_pos=args.lora_pos,
            warmup_alpha=args.warmup_alpha, big_alpha=args.big_alpha,
            alpha_epoch=args.alpha_epoch,
            beta_decay=args.beta_decay, small_beta=args.small_beta,
            prototype=args.prototype, pro_f_weight=args.pro_f_weight,
            pro_r_weight=args.pro_r_weight, bnd_pro=args.BND_pro,
            aug_num=args.aug_num,
            average_weight=args.average_weight, ema_decay=args.ema_decay,
            ema_epoch=args.ema_epoch,
            num_tasks=args.num_tasks,
            cl_beta_list=tuple(args.cl_beta_list),
            cl_prof_list=tuple(args.cl_prof_list),
            few_shot=args.few_shot, few_shot_num=args.few_shot_num,
            data_ratio=args.data_ratio, open_cls_num=args.open_cls_num,
        ),
        baseline=BaselineConfig(
            method=method,
            l2_lambda=args.l2_lambda, ewc_lambda=args.ewc_lambda,
            mas_lambda=args.mas_lambda, replay=args.replay,
            lwf_T=args.Lwf_T, lwf_lambda_kd=args.Lwf_lambda_kd,
            lwf_lambda_remain=args.Lwf_lambda_remain,
            lwf_faithful_zero_kd=getattr(args, "lwf_faithful_zero_kd",
                                         False),
            der_lambda=args.DER_lambda, der_plus=args.DER_plus,
            der_plus_lambda=args.DER_plus_lambda,
            fdr_lambda=args.FDR_lambda,
            sgda_smoothing=args.sgda_smoothing, sgda_gamma=args.sgda_gamma,
            sgda_alpha=args.sgda_alpha,
            sgda_learning_rate=args.sgda_learning_rate,
            sgda_momentum=args.sgda_momentum,
            sgda_weight_decay=args.sgda_weight_decay,
            scrub_superepoch=args.SCRUB_superepoch, kd_T=args.kd_T,
            scrub_decay_epoch=args.scrub_decay_epoch,
            lirf_T=args.LIRF_T, lirf_alpha=args.LIRF_alpha,
            ffn_open=getattr(args, "ffn_open", False),
            only_ffn=getattr(args, "only_ffn", False),
        ),
        data=DataConfig(
            data_mode=args.data_mode,
            data_root=args.data_root or _DATA_ROOTS.get(args.data_mode, ""),
            batch_size=args.batch_size, seed=args.seed,
            uint8_transfer=getattr(args, "uint8_transfer", False),
        ),
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model,
                        tp=getattr(args, "tp", False),
                        fsdp=getattr(args, "fsdp", False),
                        pp=getattr(args, "pp", False),
                        pp_micro=getattr(args, "pp_micro", 0),
                        sp=getattr(args, "sp", False),
                        slices=getattr(args, "mesh_slices", 1)),
        resume=args.resume, outdir=args.outdir,
        compute_dtype=args.compute_dtype,
        lora_apply="merged" if getattr(args, "fast", False)
        else args.lora_apply,
        structure_mode=args.structure_mode,
        fused_batch=args.fused_batch or getattr(args, "fast", False),
        num_epoch=args.epochs,
        log_wandb=args.wandb,
        device=getattr(args, "device", "cuda"),
    )
    return cfg
