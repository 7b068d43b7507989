"""Rematerialization on the training path: the counterpart of
`jax.checkpoint`.

`checkpoint(fn, *tensors)` returns `fn(*tensors)` and keeps only
`tensors` for the backward pass, where it runs `fn` again on them and
takes the vector-Jacobian product of that run with respect to the
floating-point ones: `torch.func.grad` of Σ out·cotangent, whose gradient
reaching each output is its cotangent exactly. The run and its backward
stay inside that one transform level, so checkpoints nest (a layer's
attention blocks or SSD chunks inside the layer's checkpoint); a
`torch.func.vjp` pullback runs after its level has closed, where a nested
checkpoint's own level collides with it. The backward runs under
`torch.no_grad()`: `torch.func.grad` records its own backward pass for a
second derivative (create_graph), which would keep every layer's
recomputed activations alive to the end of the backward pass and undo
the saving; so a checkpointed function has no second derivative, which
nothing on the training path takes, and a backward pass that would be
differentiated again (`grad` of `grad`, `jacrev` of `grad`,
`torch.autograd.grad(create_graph=True)`) raises instead of returning a
derivative that misses the recomputed part. It is a
`torch.autograd.Function` with `setup_context` and
`generate_vmap_rule = True`, so `torch.func.grad`, `grad_and_value` and
`vmap(grad)` run through it, and so does a fake trace under
`FlopCounterMode`, which then counts the forward twice, as XLA's cost
analysis counts the reference's remat.

`torch.utils.checkpoint` is not used: it raises under `torch.func.grad`
(the non-reentrant form does not support saved-tensor hooks there, the
reentrant form has no `setup_context`).

Rules for callers:
  * every tensor `fn` reads that was made under a `torch.func` transform
    (the positions, a chunk's labels and mask, anything derived from a
    vmapped batch) is passed in `tensors`, not closed over: such a tensor
    is a wrapper of its transform's level, which the vmap rule cannot
    read. Integer and bool tensors are kept too, but are never
    differentiated and get no gradient; Python numbers and configs are
    closed over;
  * `fn` returns a tensor or a tuple whose items are tensors or None; a
    None goes out as a 0-d f32 zero (an MoE-less layer's aux loss, which
    its caller sums), so the output is tensors only;
  * `fn` must give the same values when run again: no random draw, and
    no in-place write to its inputs.
Nothing is cast here: the inputs are kept, and recomputed from, in their
own dtypes, so the gradients are those of the plain run.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch._C._functorch import TransformType, get_interpreter_stack
from torch.func import grad


def _tensors(out, device: torch.device):
    """`fn`'s output with each None replaced by a 0-d f32 zero."""
    if isinstance(out, tuple):
        return tuple(torch.zeros((), device=device) if o is None else o
                     for o in out)
    return out


def _differentiated_again() -> bool:
    """Is the backward pass now running recorded for a further
    derivative? Under `torch.func` the top level runs it: it records for
    a level below when it was entered with grad mode on (a
    checkpoint's own recompute enters its level under no_grad) and a
    grad or jvp level lies below it. Without `torch.func`, grad mode on
    in a backward pass means create_graph=True."""
    stack = get_interpreter_stack() or []
    if not stack:
        return torch.is_grad_enabled()
    top = stack[-1]
    return (top.key() == TransformType.Grad
            and torch._C._functorch.CGradInterpreterPtr(top).prevGradMode()
            and any(i.key() in (TransformType.Grad, TransformType.Jvp)
                    for i in stack[:-1]))


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn, ctx.many = inputs[0], isinstance(output, tuple)
        ctx.floats = [i for i, t in enumerate(inputs[1:])
                      if t.is_floating_point()]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        if _differentiated_again():
            raise RuntimeError(
                "remat.checkpoint has no second derivative: its backward "
                "pass recomputes the function outside the graph of a "
                "further derivative")
        saved = list(ctx.saved_tensors)
        cots = grads if ctx.many else grads[0:1]

        def dot(*floats):
            args = list(saved)
            for i, t in zip(ctx.floats, floats):
                args[i] = t
            out = ctx.fn(*args)
            outs = out if ctx.many else (out,)
            # the gradient reaching each output is its cotangent times 1
            return sum((o * c).sum() for o, c in zip(outs, cots))

        out = [None] * len(saved)
        if ctx.floats:
            # outside the outer transforms' graphs: no second derivative,
            # and the recomputed activations die with this call
            with torch.no_grad():
                g = grad(dot, argnums=tuple(range(len(ctx.floats))))(
                    *(saved[i] for i in ctx.floats))
            for i, gi in zip(ctx.floats, g):
                out[i] = gi
        return (None, *out)


def checkpoint(fn: Callable, *tensors: torch.Tensor):
    """`fn(*tensors)`, with only `tensors` kept for the backward pass (the
    module docstring's rules)."""
    device = tensors[0].device
    return _Checkpoint.apply(lambda *t: _tensors(fn(*t), device), *tensors)
