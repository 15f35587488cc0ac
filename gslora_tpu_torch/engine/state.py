"""Train state: frozen base + trainable LoRA + optimizer state (port of
gslora_tpu/engine/state.py).

The reference freezes via loralib ``mark_only_lora_as_trainable``
(train_own_forget.py:650-651); here only the trainable subtree's
parameters require grad, and the optimizer updates them in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from gslora_tpu_torch.config import OptimConfig
from gslora_tpu_torch.models.vit import ViT


def _lr32(lr: float) -> torch.Tensor:
    """The learning rate as the fp32 value the JAX step writes into its
    optimizer state each step (``_with_lr``)."""
    return torch.tensor(lr, dtype=torch.float32)


def _apply(p: torch.Tensor, u: torch.Tensor) -> None:
    """optax.apply_updates in place of an fp32 update: p + u in fp32, cast
    back to the parameter's dtype. (Callers widen the update themselves:
    torch, unlike JAX, keeps bf16 when a 0-dim fp32 lr multiplies a bf16
    tensor.)"""
    p.copy_((p.float() + u).to(p.dtype))


def _bias_correction(b: float, t: int) -> torch.Tensor:
    """``1 - b**t`` in fp32 (optax's count is an int32 array)."""
    return 1.0 - torch.tensor(b, dtype=torch.float32) ** t


def _coupled_decay(g: torch.Tensor, p: torch.Tensor, wd: float):
    """optax.add_decayed_weights before the inner transform (the JAX
    package's ``_coupled``, state.py:73-88): g + wd * p in p's dtype."""
    g = g.to(p.dtype)
    return g + wd * p if wd else g


class AdamW:
    """optax.adamw semantics (what the JAX package's make_optimizer builds,
    state.py:59-65), updating a list of tensors in place:

    * moments kept in each parameter's dtype; b1, b2 and eps are Python
      floats (a bf16 b2 would round to 1.0 and make the first update NaN);
    * bias corrections ``1 - b**t`` computed in fp32, cast to the moment
      dtype;
    * decoupled weight decay on every parameter: u = adam + wd * p;
    * the learning rate is an fp32 value set per step: p += -lr * u, taken
      in fp32 and cast back to the parameter dtype (optax.apply_updates).
    """

    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def _adam(self, g, mu, nu, bc1, bc2):
        """optax.scale_by_adam on one tensor: moments updated in place,
        the scaled update returned in the moments' dtype."""
        b1, b2 = self.b1, self.b2
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
        mu_hat = mu / bc1.to(mu.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict, lr: float) -> None:
        state["count"] += 1
        t = state["count"]
        bc1, bc2 = _bias_correction(self.b1, t), _bias_correction(self.b2, t)
        lr32 = _lr32(lr)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            u = self._adam(g.to(p.dtype), mu, nu, bc1, bc2)
            u = u + self.weight_decay * p
            _apply(p, -lr32 * u.float())


class Adam(AdamW):
    """``--opt adam``: optax.chain(add_decayed_weights(wd), adam): the
    decay joins the gradient before the moments (coupled, as
    torch.optim.Adam's weight_decay), then p += -lr * adam(g + wd * p)."""

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict, lr: float) -> None:
        state["count"] += 1
        t = state["count"]
        bc1, bc2 = _bias_correction(self.b1, t), _bias_correction(self.b2, t)
        lr32 = _lr32(lr)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            u = self._adam(_coupled_decay(g, p, self.weight_decay), mu, nu,
                           bc1, bc2)
            _apply(p, -lr32 * u.float())


class SGD:
    """``--opt sgd``: optax.chain(add_decayed_weights(wd),
    sgd(lr, momentum)): the trace ``m = (g + wd * p) + momentum * m`` in
    the parameter's dtype (it starts at zero, so its first value is the
    decayed gradient), then p += -lr * m."""

    def __init__(self, lr: float, momentum: float, weight_decay: float):
        self.lr, self.momentum, self.weight_decay = lr, momentum, \
            weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict, lr: float) -> None:
        lr32 = _lr32(lr)
        for p, g, m in zip(params, grads, state["trace"]):
            m.copy_(_coupled_decay(g, p, self.weight_decay) +
                    self.momentum * m)
            _apply(p, -lr32 * m.float())


class RMSprop:
    """``--opt rmsprop``: optax.chain(add_decayed_weights(wd),
    rmsprop(lr, momentum=momentum)) of optax 0.2.6, which differs from
    torch.optim.RMSprop in four ways:

    * the squared-gradient average decays by 0.9 (torch: 0.99);
    * eps = 1e-8 sits inside the root, g * rsqrt(nu + eps) (torch:
      g / (sqrt(nu) + eps)); ``--opt-eps`` is not passed to it;
    * the momentum trace runs after the -lr scaling, so it carries the
      learning rate of past steps: m = -lr * g' + momentum * m;
    * the trace starts in the parameter's dtype and, with bf16
      parameters, is fp32 from the first update on (fp32 lr times a bf16
      update, never cast back).
    """

    DECAY, EPS = 0.9, 1e-8

    def __init__(self, lr: float, momentum: float, weight_decay: float):
        self.lr, self.momentum, self.weight_decay = lr, momentum, \
            weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"nu": [torch.zeros_like(p) for p in params],
                "trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict, lr: float) -> None:
        lr32 = _lr32(lr)
        d = self.DECAY
        for i, (p, g, nu) in enumerate(zip(params, grads, state["nu"])):
            g = _coupled_decay(g, p, self.weight_decay)
            nu.copy_((1.0 - d) * (g * g) + d * nu)
            u = -lr32 * (torch.rsqrt(nu + self.EPS) * g).float()
            m = u + self.momentum * state["trace"][i]
            state["trace"][i] = m
            _apply(p, m)


def make_optimizer(cfg: OptimConfig):
    """Optimizer factory (util/args.py --opt) with the JAX package's optax
    semantics: adamw (decoupled decay), and adam, sgd, rmsprop with the
    decay coupled into the gradient (state.py:43-93)."""
    if cfg.opt == "adamw":
        return AdamW(lr=cfg.lr, b1=cfg.betas[0], b2=cfg.betas[1],
                     eps=cfg.opt_eps, weight_decay=cfg.weight_decay)
    if cfg.opt == "adam":
        return Adam(lr=cfg.lr, b1=cfg.betas[0], b2=cfg.betas[1],
                    eps=cfg.opt_eps, weight_decay=cfg.weight_decay)
    if cfg.opt == "sgd":
        return SGD(lr=cfg.lr, momentum=cfg.momentum,
                   weight_decay=cfg.weight_decay)
    if cfg.opt == "rmsprop":
        return RMSprop(lr=cfg.lr, momentum=cfg.momentum,
                       weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.opt}")


@dataclass
class ForgetState:
    """The model (base + LoRA parameters), which subtree trains, the
    optimizer's state for it, and the global step count."""

    model: ViT
    trainable: str
    opt_state: Dict
    step: int = 0

    @classmethod
    def create(cls, model: ViT, optimizer,
               trainable: str = "lora") -> "ForgetState":
        """``trainable``: "lora" (mark_only_lora_as_trainable semantics) or
        "base" (rank 0: the reference trains ALL parameters,
        train_own_forget_open.py:699-706). Sets requires_grad on the
        trainable subtree only."""
        if trainable not in ("lora", "base"):
            raise ValueError(f"unknown trainable {trainable!r}")
        for name, p in model.named_parameters():
            p.requires_grad_(name.startswith(trainable + "."))
        state = cls(model=model, trainable=trainable, opt_state={})
        state.opt_state = optimizer.init(state.trainable_params())
        return state

    def trainable_params(self) -> List[torch.nn.Parameter]:
        sub = self.model.base if self.trainable == "base" else self.model.lora
        return list(sub.parameters())

    def trainable_names(self) -> List[str]:
        """The dotted names of :meth:`trainable_params`, in its order."""
        return [n for n, p in self.model.named_parameters()
                if n.startswith(self.trainable + ".")]

    @property
    def params(self) -> Dict:
        return self.model.tree()
