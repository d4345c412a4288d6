"""The JAX trainer's optimizer with optax's semantics, written out in torch.

`diffusion_e2e_ft_tpu/training/trainer.py::_build_optimizer` chains
`optax.clip_by_global_norm` and `optax.adamw`, splits the parameters into a
"base" group and a "class_embedding" group with its own learning-rate
multiplier (`optax.multi_transform`, only when the multiplier is not 1: at 1
one chain clips all parameters together), and wraps the lot in `optax.MultiSteps`
for gradient accumulation. torch.optim.AdamW differs in small ways (where the
decay is applied, when the learning rate is read, no accumulation), so the
port writes the same arithmetic out:

- clip: per group, g <- g / |g| * max_norm only when |g| >= max_norm (no epsilon);
- Adam: mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, both bias-corrected
  with the count after the update, u = mu_hat / (sqrt(nu_hat) + eps);
- decoupled weight decay on every parameter: u <- u + wd p;
- p <- p - lr(count) u, with lr read at the count before this update;
- accumulation over K micro-steps: acc <- acc + (g - acc) / (n + 1) (optax's
  running mean), applied at the K-th micro-step; parameters do not move in
  between;
- `mu_dtype` (optax's `mu_dtype`, the JAX `TrainConfig.adam_mu_dtype`): the
  first moment is stored in that dtype, zeros at init. A step computes
  m = (1 - b1) g + b1 m_stored in fp32, with b1 rounded to the stored dtype
  (optax's weak-typed scalar takes the moment's dtype) and the product not
  rounded (exact in fp32; the jitted JAX step computes it so: XLA keeps the
  excess precision), takes the update and its bias correction from that
  fp32 m, and stores m cast back (round to nearest even).

The state is a plain dict of ints and tensor dicts, so `torch.save` writes it.
Updates run as `torch._foreach_*` ops, a few launches per op for all tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch

GROUPS = ("base", "class_embedding")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every element squared) over a list of tensors, in fp32."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def sharded_global_norm(
    shards: List[torch.Tensor], replicated: List[torch.Tensor], fsdp_sum: Callable[[torch.Tensor], torch.Tensor]
) -> torch.Tensor:
    """The global norm of tensors of which `shards` are this rank's blocks of
    fsdp-sharded ones: the fsdp axis's sum of the shards' squares, plus the
    replicated tensors' squares, counted once."""
    squares = [fsdp_sum(global_norm(shards) ** 2)] if shards else []
    if replicated:
        squares.append(global_norm(replicated) ** 2)
    return torch.stack(squares).sum().sqrt()


def group_of(name: str) -> str:
    """The class-embedding group takes every parameter under a `class_embedding` module."""
    return "class_embedding" if "class_embedding" in name.split(".") else "base"


class OptaxAdamW:
    """clip_by_global_norm + adamw (+ MultiSteps when accumulate > 1), per group."""

    def __init__(
        self,
        schedule: Callable[[int], float],
        *,
        b1: float,
        b2: float,
        eps: float,
        weight_decay: float,
        max_grad_norm: float,
        class_embedding_lr_mult: float = 1.0,
        accumulate: int = 1,
        mu_dtype: Optional[torch.dtype] = None,
    ):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.lr_mult = {"base": 1.0, "class_embedding": class_embedding_lr_mult}
        self.accumulate = accumulate
        self.mu_dtype = mu_dtype

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        zeros = lambda dtype=None: {  # noqa: E731
            n: torch.zeros_like(p, dtype=dtype, memory_format=torch.preserve_format) for n, p in params.items()
        }
        state = {"count": 0, "mu": zeros(self.mu_dtype), "nu": zeros(), "mini_step": 0, "acc": None}
        if self.accumulate > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict, params: Mapping[str, torch.Tensor],
               norm: Optional[Callable[[Mapping[str, torch.Tensor]], torch.Tensor]] = None) -> bool:
        """One micro-step: updates `params` and `state` in place. Returns whether
        the parameters were updated (every micro-step when accumulate == 1).
        `norm` takes the clipping's global norm of a group's gradients by
        name (default `global_norm`; a sharded state's is over the fsdp axis)."""
        if self.accumulate > 1:
            names = list(grads)
            acc = [state["acc"][n] for n in names]
            delta = torch._foreach_sub([grads[n] for n in names], acc)
            torch._foreach_div_(delta, float(state["mini_step"] + 1))
            torch._foreach_add_(acc, delta)
            if state["mini_step"] < self.accumulate - 1:
                state["mini_step"] += 1
                return False
            self._apply(state["acc"], state, params, norm)
            torch._foreach_zero_(acc)
            state["mini_step"] = 0
            return True
        self._apply(grads, state, params, norm)
        return True

    def _apply(self, grads: Mapping[str, torch.Tensor], state: Dict, params: Mapping[str, torch.Tensor],
               norm_of: Optional[Callable[[Mapping[str, torch.Tensor]], torch.Tensor]] = None) -> None:
        count = state["count"]
        bias1 = 1.0 - self.b1 ** (count + 1)
        bias2 = 1.0 - self.b2 ** (count + 1)
        split = self.lr_mult["class_embedding"] != 1.0  # the JAX trainer's multi_transform
        for group in GROUPS:
            names = [n for n in params if (group_of(n) if split else "base") == group]
            if not names:
                continue
            g = [grads[n] for n in names]
            p = [params[n] for n in names]
            mu = [state["mu"][n] for n in names]
            nu = [state["nu"][n] for n in names]
            norm = global_norm(g) if norm_of is None else norm_of(dict(zip(names, g)))
            clip = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            g = torch._foreach_mul(g, clip)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            if self.mu_dtype is None:
                torch._foreach_mul_(mu, self.b1)
                torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
                m = mu
            else:  # the fp32 moment in the clipped gradients' storage: no list of its own
                torch._foreach_mul_(g, 1.0 - self.b1)
                # + b1 m_stored, b1 in the moment's dtype, the product exact in fp32
                torch._foreach_add_(g, mu, alpha=torch.tensor(self.b1, dtype=self.mu_dtype).item())
                m = g
            denom = torch._foreach_div(nu, bias2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(m, bias1)
            torch._foreach_div_(u, denom)
            torch._foreach_add_(u, p, alpha=self.weight_decay)
            lr = self.schedule(count) * self.lr_mult[group]
            torch._foreach_add_(p, u, alpha=-lr)
            if m is not mu:
                torch._foreach_copy_(mu, m)  # cast to the stored dtype
        state["count"] = count + 1


def ema_update_(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor], decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    with torch.no_grad():
        e = list(ema.values())
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, [params[n] for n in ema], alpha=1.0 - decay)

