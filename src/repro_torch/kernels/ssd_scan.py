"""Mamba2 SSD chunked scan (one group): the CUDA kernel's wrapper and its
plain version.

For x (b,S,h,p), dA (b,S,h) (= dt·A, negative), B, C (b,S,n) and chunks of
Q rows, with cum the within-chunk cumulative sum of dA and h the (p, n)
state carried from chunk to chunk (zero at the start):

    y[i]  = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) x[j]  +  exp(cum_i) (h·C_i)
    h    <- h·exp(cum[-1]) + sum_j x[j] ⊗ B_j exp(cum[-1] - cum_j)

Returns y (b,S,h,p) in x's dtype and the final state (b,h,p,n) in f32.

`ssd_scan` decides by the tensors' device: CUDA tensors launch the
hand-written kernel `csrc/ssd_scan.cu` (which replaces the TPU kernel
`repro/kernels/ssd_scan.py`), CPU tensors take `ssd_scan_ref`, the chunked
form of the reference's `models/ssm.py::ssd_chunked` in f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import (FLOAT_STORES, check_tensors,
                                         entry_point, launch)

# the kernel holds a row of x (p) in up to 8 column slices of 16 threads,
# and the state h (p, n) and a tile of B and C (64, n) in shared memory
MAX_HEADDIM = 128
MAX_STATE = 128
MAX_CHUNK = 1024


def ssd_scan_ref(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, *, chunk: int):
    """Plain version: the chunked SSD in f32, one chunk at a time.
    Returns (y (b,S,h,p) in x's dtype, h_final (b,h,p,n) f32)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    nc = S // Q
    xc = x.float().reshape(b, nc, Q, H, P)
    dAc = dA.float().reshape(b, nc, Q, H)
    Bc = B.float().reshape(b, nc, Q, N)
    Cc = C.float().reshape(b, nc, Q, N)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xq, bq, cq = xc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(dAc[:, c], dim=1)                  # (b,Q,h)
        cum_h = cum.transpose(1, 2)                           # (b,h,Q)
        diff = cum_h[..., :, None] - cum_h[..., None, :]      # (b,h,Q,Q)
        L = torch.where(tri, torch.exp(diff), 0.0)
        att = torch.einsum("bqn,bkn->bqk", cq, bq)            # (b,Q,Q)
        y = torch.einsum("bqk,bhqk,bkhp->bqhp", att, L, xq)
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", cq, h, torch.exp(cum))
        decay = torch.exp(cum[:, -1:, :] - cum)               # (b,Q,h)
        h = (h * torch.exp(cum[:, -1, :])[..., None, None]
             + torch.einsum("bqn,bqh,bqhp->bhpn", bq, decay, xq))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, S, H, P).to(x.dtype)
    return y, h


def _check(x, dA, B, C, chunk: int) -> None:
    if x.ndim != 4 or B.ndim != 3:
        raise ValueError(f"x must be (b,S,h,p) and B (b,S,n), got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    b, S, H, P = x.shape
    N = B.shape[-1]
    if min(b, S, H, P, N) == 0:
        raise ValueError(f"empty scan x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}")
    if not 0 < chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must divide S={S} and be at most "
                         f"{MAX_CHUNK}")
    if P > MAX_HEADDIM or N > MAX_STATE:
        raise ValueError(f"head dim {P} and state {N} must be at most "
                         f"{MAX_HEADDIM} and {MAX_STATE}")
    check_tensors(x.device, {
        "x": (x, FLOAT_STORES, (b, S, H, P)),
        "dA": (dA, (torch.float32,), (b, S, H)),
        "B": (B, (x.dtype,), (b, S, N)),
        "C": (C, (x.dtype,), (b, S, N))})


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 256):
    """x (b,S,h,p) f32|bf16; dA (b,S,h) f32; B, C (b,S,n) of x's dtype;
    all contiguous; S % chunk == 0. Returns (y (b,S,h,p) in x's dtype,
    h_final (b,h,p,n) f32). CPU tensors take the plain version; CUDA
    tensors launch the kernel into fresh outputs."""
    _check(x, dA, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dA, B, C, chunk=chunk)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = entry_point("ssd_scan", "ssd_scan", [vp] * 6 + [ci] * 7, x.device)
    b, S, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    h_final = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    launch(fn, x.device, x.data_ptr(), dA.data_ptr(), B.data_ptr(),
           C.data_ptr(), y.data_ptr(), h_final.data_ptr(), b, S, H, P, N,
           chunk, int(x.dtype == torch.bfloat16))
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
