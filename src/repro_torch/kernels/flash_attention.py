"""Forward online-softmax attention: the CUDA kernel's wrapper and its plain
version.

    out[b,s,h] = softmax_t(q[b,s,h]·k[b,t,h//g] / sqrt(hd), mask) · v[b,t,h//g]

for q (B,S,H,hd), k (B,T,KV,hd) and v (B,T,KV,dv), out (B,S,H,dv), with g =
H // KV (grouped-query attention reads a key/value head per group; nothing
is repeated in memory) and, when `causal`, the mask key <= query. v's head
dim dv may differ from hd (MLA's prefill: hd 192, dv 128); the scale is
always q's. The causal mask is top-left
aligned, as the TPU kernel's `kpos <= qpos`; the reference's oracle aligns
it bottom-right (`tril(k=T-S)`), and the two agree only when S == T, so a
causal call with S != T raises. A causal call may take a sliding `window`
w > 0 (gemma3's local layers): key t is then valid for query s iff
s - w < t <= s, the mask of the reference's windowed
`blockwise_attention` (`repro/models/attention.py`). A window without
`causal` raises: the reference's non-causal windowed result depends on its
query block, whose key slice ends at the block's end.

`flash_attention` decides by the tensors' device: CUDA tensors launch the
hand-written kernel `csrc/flash_attention.cu` (which replaces the TPU kernel
`repro/kernels/flash_attention.py`), CPU tensors take
`flash_attention_ref`. Scores, the softmax and the accumulator are f32; in
bf16 the kernel rounds the probabilities to bf16 before P·V, as the TPU
kernel does, while the plain version keeps them in f32. The f32 kernel
takes any (hd, dv); the bf16 kernel has an instance for dv == hd and one
for MLA's (hd, dv) (`served_bf16`), and a CUDA call with another pair
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.backend import (FLOAT_STORES, check_tensors,
                                         entry_point, launch)

# the kernel keeps a head's row in registers in 16-wide slices
MAX_HEAD_DIM = 256
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """Plain version: exact softmax attention in f32 with the top-left
    causal mask (and, for window > 0, the window's lower edge), returned
    in q's dtype at v's head dim."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float().reshape(B, S, KV, g, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
        if window > 0:
            mask = mask.triu(1 - window)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def served_bf16(hd: int, dv: int, window: int) -> bool:
    """Has the bf16 kernel an instance for this (hd, dv)? Every hd with dv
    == hd, and without a window hd 129..192 with dv 113..128 (MLA's 192 and
    128: the instance of 12 and 8 16-wide slices)."""
    return dv == hd or (not window and 128 < hd <= 192 and 112 < dv <= 128)


def _check(q, k, v, causal: bool, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k and v must be (B,S,H,hd), (B,T,KV,hd) and "
                         f"(B,T,KV,dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if min(B, S, H, T, KV) == 0:
        raise ValueError(f"empty attention q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if H % KV:
        raise ValueError(f"{H} query heads do not split into {KV} kv heads")
    dv = v.shape[-1]
    for name, d in (("head dim", hd), ("v head dim", dv)):
        if d % 8 or d > MAX_HEAD_DIM:
            raise ValueError(f"{name} {d} must be a multiple of 8 and at "
                             f"most {MAX_HEAD_DIM}")
    if causal and S != T:
        raise ValueError(f"causal attention needs S == T (got S={S}, "
                         f"T={T}): the kernel's mask is top-left aligned")
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window}: a sliding window must be >= 0 "
                         "and is taken only with causal=True")
    check_tensors(q.device, {
        "q": (q, FLOAT_STORES, (B, S, H, hd)),
        "k": (k, (q.dtype,), (B, T, KV, hd)),
        "v": (v, (q.dtype,), (B, T, KV, dv))})


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd) f32|bf16; k (B,T,KV,hd), v (B,T,KV,dv) of q's dtype,
    H % KV == 0, hd and dv multiples of 8 up to 256, all contiguous;
    `window` > 0 (causal only) keeps each query's last `window` keys.
    Returns (B,S,H,dv) in q's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel into a fresh output."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    if bf16 and q.device.type == "cuda" and not served_bf16(hd, dv, window):
        raise ValueError(
            f"no bf16 flash_attention instance for hd {hd}, dv {dv}"
            f"{f', window {window}' if window else ''}: it serves dv == hd, "
            "and without a window hd 129..192 with dv 113..128")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = entry_point("flash_attention", "flash_attention",
                     [vp] * 4 + [ci] * 9, q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel reads rows 16 bytes at a time: q, k "
                         "and v must start 16-byte aligned")
    out = q.new_empty((B, S, H, dv))
    launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), B, S, T, H, KV, hd, dv,
           int(causal) | (int(bf16) << 1), window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
