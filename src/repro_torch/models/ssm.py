"""Mamba2 (SSD, state-space duality) block: chunked prefill scan and O(1)
decode (counterpart of `repro/models/ssm.py`). Single SSM group (G=1).

`mamba2_prefill` takes its scan from its caller. Serving passes the kernel
route, `kernels.ops.ssd`: the hand-written CUDA kernel on the card, its
plain version on the CPU. The training forward passes `ssd_chunked`, the
reference's differentiable model function (the kernel is forward-only and
cannot run under `torch.func` transforms; the reference's training path
calls no kernel either). The chunk is chosen as the reference chooses it:
the configured chunk, halved until it divides S.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _device_init
from repro_torch.models.remat import checkpoint


def mamba2_dims(d_model: int, expand: int, headdim: int, d_state: int,
                conv_width: int):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_ch = d_inner + 2 * d_state          # conv over [x, B, C]
    proj_dim = 2 * d_inner + 2 * d_state + n_heads  # z, x, B, C, dt
    return d_inner, n_heads, conv_ch, proj_dim


def mamba2_init(gen: torch.Generator, d_model: int, expand: int,
                headdim: int, d_state: int, conv_width: int,
                dtype: torch.dtype) -> dict:
    d_inner, n_heads, conv_ch, proj_dim = mamba2_dims(
        d_model, expand, headdim, d_state, conv_width)
    dev, f32 = gen.device, torch.float32
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((n_heads,), generator=gen, dtype=f32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_proj": _device_init(gen, (d_model, proj_dim), dtype),
        "conv_w": _device_init(gen, (conv_width, conv_ch), dtype, scale=0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=f32,
                                        device=dev)),
        "D": torch.ones((n_heads,), dtype=f32, device=dev),
        "dt_bias": dt_bias,
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": _device_init(gen, (d_inner, d_model), dtype),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, d_state: int,
                n_heads: int):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * d_state]
    dt = proj[..., -n_heads:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. xbc (B,S,C); w (W,C)."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    y32 = y.float()
    var = y32.square().mean(-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def ssd_chunk(S: int, chunk: int) -> int:
    """The chunk the reference's `ssd_chunked` uses for length S: the
    configured chunk (at most S), halved until it divides S."""
    q = min(chunk, S)
    while S % q:
        q //= 2
    return q


def _segsum_exp(a: torch.Tensor) -> torch.Tensor:
    """a (..., q) -> L (..., q, q) with L[i,j] = exp(sum_{j<k<=i} a_k),
    lower-triangular.

    The reference takes `where(tril, exp(diff), 0)`. Above the diagonal
    diff = -sum a_k > 0 overflows to inf once a chunk's |dA| sum passes
    ~88, and the reference's gradient is then 0·inf = NaN (at zamba2-7b's
    full width, A up to -112: ROADMAP Queue 3, reference-side findings).
    Here the mask is applied before the exp: the same values, the same
    gradient wherever the reference's is finite, and a finite one where
    the reference's is NaN.
    """
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.exp(torch.where(mask, diff, float("-inf")))


def ssd_chunked(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, h0: torch.Tensor | None = None):
    """Chunked SSD, the training forward's scan: a loop over chunks with
    the (b,h,p,n) state carried in f32, all state math in f32.

    x (b,S,h,p); dA (b,S,h) [= dt·A, negative]; B, C (b,S,n). The chunk is
    `ssd_chunk(S, chunk)`. Returns (y (b,S,h,p) in x's dtype, h_final
    (b,h,p,n) f32). Differentiable, with no in-place op, so `torch.func`
    transforms run through it. Each chunk's body takes the carried state
    and the chunk's slices and goes through `remat.checkpoint`, as the
    reference's goes through `jax.checkpoint`: the backward pass keeps the
    state entering each chunk and recomputes the chunk's (b,h,Q,Q) decay
    matrix and the rest. `_segsum_exp` masks before its exp inside the
    body, so the recomputed backward is finite wherever the plain one is.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = ssd_chunk(S, chunk)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())

    def chunk_body(h, xq, daq, bq, cq):
        xq, daq, bq, cq = xq.float(), daq.float(), bq.float(), cq.float()
        cum = torch.cumsum(daq, dim=1)                   # (b,Q,h)
        L = _segsum_exp(daq.transpose(-1, -2))           # (b,h,Q,Q)
        att = torch.einsum("bqn,bkn->bqk", cq, bq)       # (b,Q,Q)
        y = torch.einsum("bqk,bhqk,bkhp->bqhp", att, L, xq)
        # contribution of the carried state
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", cq, h, torch.exp(cum))
        # state update
        decay = torch.exp(cum[:, -1:, :] - cum)          # (b,Q,h)
        h_new = (h * torch.exp(cum[:, -1, :])[..., None, None]
                 + torch.einsum("bqn,bqh,bqhp->bhpn", bq, decay, xq))
        return y, h_new

    ys = []
    for c0 in range(0, S, Q):
        # x (b,Q,h,p), dA (b,Q,h), B and C (b,Q,n): views, cast in the body
        y, h = checkpoint(chunk_body, h, x[:, c0:c0 + Q], dA[:, c0:c0 + Q],
                          B[:, c0:c0 + Q], C[:, c0:c0 + Q])
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def mamba2_prefill(params: dict, x: torch.Tensor, *, expand: int,
                   headdim: int, d_state: int, chunk: int, conv_width: int,
                   scan=ops.ssd):
    """x (B,S,d) -> (y (B,S,d), (ssm_state (B,H,P,N) f32,
    conv_state (B,W-1,C))).

    `scan(x, dA, B, C, chunk=Q) -> (y, h_final)` is the SSD scan: the
    kernel route `ops.ssd` for serving (the default), `ssd_chunked` for
    the training forward."""
    Bsz, S, d_model = x.shape
    d_inner, n_heads, _, _ = mamba2_dims(d_model, expand, headdim, d_state,
                                         conv_width)
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj, d_inner, d_state, n_heads)
    if S >= conv_width - 1:
        conv_state = xbc[:, S - (conv_width - 1):, :]
    else:
        conv_state = F.pad(xbc, (0, 0, conv_width - 1 - S, 0))
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = xbc[..., :d_inner].reshape(Bsz, S, n_heads, headdim)
    Bmat = xbc[..., d_inner:d_inner + d_state].contiguous()
    Cmat = xbc[..., d_inner + d_state:].contiguous()

    dt = F.softplus(dt.float() + params["dt_bias"])              # (B,S,H)
    A = -torch.exp(params["A_log"])                              # (H,)
    y, h_final = scan((xs * dt[..., None].to(xs.dtype)).contiguous(),
                      (dt * A).contiguous(), Bmat, Cmat,
                      chunk=ssd_chunk(S, chunk))
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(Bsz, S, d_inner)
    y = _gated_rmsnorm(y, z, params["norm_scale"])
    return y @ params["out_proj"], (h_final, conv_state)


def mamba2_decode(params: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                  conv_state: torch.Tensor, *, expand: int, headdim: int,
                  d_state: int, conv_width: int):
    """Single-token recurrent step.

    x (B,1,d); ssm_state (B,H,P,N) f32; conv_state (B,W-1,conv_ch).
    Returns (y (B,1,d), (ssm_state, conv_state)) as new tensors.
    """
    Bsz, _, d_model = x.shape
    d_inner, n_heads, _, _ = mamba2_dims(d_model, expand, headdim, d_state,
                                         conv_width)
    proj = (x @ params["in_proj"])[:, 0]                  # (B, proj)
    z, xbc, dt = _split_proj(proj, d_inner, d_state, n_heads)

    # conv: append the new channel vector, take the causal window
    win = torch.cat([conv_state, xbc[:, None, :].to(conv_state.dtype)],
                    dim=1)                                # (B,W,C)
    conv_state = win[:, 1:, :]
    conv_out = torch.einsum("bwc,wc->bc", win.float(),
                            params["conv_w"].float())
    xbc = F.silu(conv_out + params["conv_b"].float()).to(x.dtype)

    xs = xbc[:, :d_inner].reshape(Bsz, n_heads, headdim)
    Bv = xbc[:, d_inner:d_inner + d_state].float()
    Cv = xbc[:, d_inner + d_state:].float()

    dt = F.softplus(dt.float() + params["dt_bias"])               # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                        # (B,H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bv, xs.float())
    ssm_state = ssm_state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cv)
    y = y + params["D"][None, :, None] * xs.float()
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z[:, None, :], params["norm_scale"])
    return y @ params["out_proj"], (ssm_state, conv_state)
